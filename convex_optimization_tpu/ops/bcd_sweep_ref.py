"""Pure-jnp Gauss-Seidel block-coordinate sweep — the parity oracle.

One sweep visits every contiguous column block j (in a given order) and runs
the reference's hot loop (SURVEY.md section 3.2) as a single ``lax.scan``:

    g_j   = A_j^T r + lam2 * x_j        # block gradient
    x_j'  = prox_{t_j g}(x_j - t_j g_j) # t_j = step_scale / (L_j + lam2)
    r    += A_j (x_j' - x_j)            # incremental residual update

Unlike the reference (a Python loop dispatching per-block kernels with
host-side step logic), the whole sweep is one jitted program: no host
round-trips, static shapes, sequential-in-j semantics preserved.  This file
is the correctness oracle for the fused sweep in bcd_sweep.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from convex_optimization_tpu.core.problem import Problem


def bcd_sweep_ref(
    problem: Problem,
    x: jax.Array,
    r: jax.Array,
    block_L: jax.Array,
    block_order: jax.Array,
    *,
    step_scale: float = 1.0,
    keep_mask: jax.Array | None = None,
) -> tuple[jax.Array, jax.Array]:
    """One Gauss-Seidel sweep over all column blocks.  Returns (x, r).

    x:           (n,) current iterate
    r:           (m,) residual A x - b (kept incrementally, must be consistent)
    block_L:     (n_blocks,) per-block ||A_j||_2^2 (WITHOUT lam2; added here)
    block_order: (n_blocks,) int visit order (cyclic = arange, or a permutation)
    step_scale:  damping multiplier on the 1/L_j step (used by the sharded
                 Jacobi-across-chips variant; 1.0 for plain Gauss-Seidel)
    keep_mask:   optional (n,) screening mask; False coordinates stay frozen
    """
    A, lam2, penalty = problem.A, problem.lam2, problem.penalty
    m, n = A.shape
    n_blocks = block_L.shape[0]
    if n % n_blocks != 0:
        raise ValueError(f"n={n} not divisible by n_blocks={n_blocks}")
    B = n // n_blocks

    def body(carry, j):
        x, r = carry
        col0 = j * B
        Aj = lax.dynamic_slice_in_dim(A, col0, B, axis=1)
        xj = lax.dynamic_slice(x, (col0,), (B,))
        g = jnp.dot(Aj.T, r, precision=lax.Precision.HIGHEST) + lam2 * xj
        t = step_scale / (lax.dynamic_index_in_dim(block_L, j, keepdims=False) + lam2)
        xj_new = penalty.prox_block(xj - t * g, t, j, n)
        if keep_mask is not None:
            # screened coordinates are CERTIFIED zero at the optimum: set
            # them to 0 (not their stale value) — the incremental residual
            # update below absorbs the change exactly
            mj = lax.dynamic_slice(keep_mask, (col0,), (B,))
            xj_new = jnp.where(mj, xj_new, 0.0)
        r = r + jnp.dot(Aj, xj_new - xj, precision=lax.Precision.HIGHEST)
        x = lax.dynamic_update_slice(x, xj_new, (col0,))
        return (x, r), None

    (x, r), _ = lax.scan(body, (x, r), block_order)
    return x, r
