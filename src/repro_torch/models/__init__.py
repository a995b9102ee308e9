"""Classical models the paper compiles: Bonsai and ProtoNN."""
