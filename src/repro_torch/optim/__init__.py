"""The LM's optimizer (AdamW)."""
