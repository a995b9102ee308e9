"""Serving engines: over compiled classical programs, and the token engine
of the LM stack (``engine``)."""
