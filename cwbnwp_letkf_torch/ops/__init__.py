"""Device-side LETKF operators: accumulation, solve and the fused cycle."""
from .solver import (apply_weight_factors, letkf_solve_batch,
                     letkf_weight_factors, tune_q)

__all__ = [
    "letkf_solve_batch",
    "letkf_weight_factors",
    "apply_weight_factors",
    "tune_q",
]
