"""Models: the classical ones the paper compiles (Bonsai, ProtoNN) and the
dense LM stack (``layers``, ``attention``, ``transformer``)."""
