"""Gap-safe active-set screening (SURVEY.md C11), expressed as jittable masks.

XLA constraint: no dynamic shapes inside jit, so screening never gathers —
it produces a boolean keep-mask consumed by the solvers (screened coordinates
are provably zero at the current lam1 and stay frozen).  Compaction (actually
shrinking the problem) happens only at lambda-path boundaries on the host,
where a re-jit on the new static shape is amortized across the path segment.

Safety property (tested): a gap-safe mask never discards a coordinate that
belongs to the support of the exact solution at the same lam1.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from convex_optimization_tpu.core.problem import Problem
from convex_optimization_tpu.core.objective import duality_gap, dual_witness


def gap_safe_keep_mask(problem: Problem, x: jax.Array,
                       r: jax.Array | None = None,
                       col_norms: jax.Array | None = None) -> jax.Array:
    """One-shot gap-safe screen at the point x.  Returns (n,) keep mask."""
    if r is None:
        r = problem.residual(x)
    if col_norms is None:
        col_norms = problem.col_norms()
    z = dual_witness(problem, x, r)
    info = duality_gap(problem, x, r, z=z)
    return problem.penalty.screen_keep(
        z, info.alpha, info.gap, col_norms,
        r_norm=jnp.linalg.norm(r), primal=info.primal)


def compact_problem(problem: Problem, keep_mask) -> tuple[Problem, jax.Array]:
    """Host-side compaction: drop screened columns (new static shape).

    Returns (smaller problem, int index array mapping kept -> original).
    Only called between lambda-path segments; triggers one re-jit.
    """
    import numpy as np

    keep = np.asarray(keep_mask)
    idx = np.nonzero(keep)[0]
    if problem.penalty.kind == "group_l2":
        # keep whole groups (masks are group-aligned already, but be safe)
        n = problem.n
        gsize = n // problem.penalty.ngroups
        gkeep = keep.reshape(-1, gsize).any(axis=1)
        idx = np.nonzero(np.repeat(gkeep, gsize))[0]
        import dataclasses

        new_pen = dataclasses.replace(
            problem.penalty,
            ngroups=int(gkeep.sum()),
            weights=(None if problem.penalty.weights is None
                     else problem.penalty.weights[np.nonzero(gkeep)[0]]),
        )
    else:
        new_pen = problem.penalty
    import dataclasses

    small = dataclasses.replace(
        problem, A=problem.A[:, idx], penalty=new_pen
    )
    return small, jnp.asarray(idx)
