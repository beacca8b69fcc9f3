"""Training: optimizers, gradient compression and the checkpointed loop."""
