"""Serving engines over compiled classical programs."""
