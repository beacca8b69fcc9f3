"""Resumable checkpoints of trees of tensors."""
