"""LM training: AdamW, the train step, checkpoints, int8 compression and
fault tolerance (the JAX package's ``train/``)."""
