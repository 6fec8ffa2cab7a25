"""The LM substrate's models: shared layers and the per-family assembly
(dense and encoder-decoder)."""
