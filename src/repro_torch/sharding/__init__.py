"""Distribution: the MAFIA sharding planner (the JAX package's
``sharding/``), partition specs without a framework, and their DTensor
placements."""
