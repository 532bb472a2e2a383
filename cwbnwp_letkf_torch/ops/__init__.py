"""Device-side LETKF operators: accumulation, solve and the fused cycle."""
