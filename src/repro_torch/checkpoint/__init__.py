"""Atomic checkpoints of named tensors."""
