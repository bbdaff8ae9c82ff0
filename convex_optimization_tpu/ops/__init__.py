"""Compute ops (L2 kernels layer): the fused block sweep (route.py picks
the Hopper CUDA kernel or the plain XLA sweep), products over the
transposed layout, power iteration, and the pure-jnp oracle
(bcd_sweep_ref.py), kept as the parity reference (SURVEY.md section 7.2
step 4).
"""

from convex_optimization_tpu.ops.power_iter import (
    spectral_norm_sq,
    block_spectral_norms_sq,
)
from convex_optimization_tpu.ops.bcd_sweep_ref import bcd_sweep_ref

__all__ = ["spectral_norm_sq", "block_spectral_norms_sq", "bcd_sweep_ref"]
