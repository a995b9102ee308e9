"""Hand-written kernels (``csrc/``) with their plain PyTorch versions."""
