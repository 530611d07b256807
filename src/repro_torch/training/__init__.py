"""Training substrate: optimizer, ring train step, checkpointing, elasticity."""
