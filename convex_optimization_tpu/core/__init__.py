"""Core layer (L1): problem container, synthetic data generation, and the
certified duality-gap convergence monitor.  Pure jnp — runs on CPU and GPU.
"""

from convex_optimization_tpu.core.problem import Problem
from convex_optimization_tpu.core.objective import (
    primal_value,
    dual_value,
    duality_gap,
    gap_from_parts,
    lambda_max,
)
from convex_optimization_tpu.core import datagen

__all__ = [
    "Problem",
    "primal_value",
    "dual_value",
    "duality_gap",
    "gap_from_parts",
    "lambda_max",
    "datagen",
]
