"""Hand-written device kernels and their plain PyTorch versions."""
