"""PyTorch/CUDA port of the MAFIA reproduction (the JAX package ``repro``
stays the reference).  Entry points run on the card unless the caller asks
for the CPU."""
