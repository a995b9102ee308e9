"""Synthetic Table-I datasets."""
