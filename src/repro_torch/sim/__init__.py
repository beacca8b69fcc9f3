"""sim layer of the PyTorch/CUDA port (see repro_torch): the JAX package's
analytical Ascend-910 simulator and the conflict-free estimate, numpy only."""
