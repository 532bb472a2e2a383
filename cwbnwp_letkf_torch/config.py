"""Run configuration constants (the namelist parser is not ported yet)."""

MAX_VARS = 16  # analysis variables per run (config.f90:4)
