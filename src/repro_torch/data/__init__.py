"""Synthetic Table-I datasets and the LM's synthetic token pipeline."""
