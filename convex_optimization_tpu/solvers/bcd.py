"""Block-coordinate descent driver (SURVEY.md C2): jitted while_loop over
Gauss-Seidel sweeps, with the sweep itself either the pure-jnp oracle
(ops/bcd_sweep_ref.py) or the fused sweep over the transposed layout
(ops/bcd_sweep.py: one kernel launch per sweep on the GPU).

The reference dispatches one CPU/GPU kernel per block from Python with
host-side step logic (SURVEY.md section 3.3); here a whole sweep — all
blocks, prox included — is one traced program, and ``gap_every`` sweeps run
between duality-gap checks, all inside a single while_loop.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from convex_optimization_tpu.core.problem import Problem
from convex_optimization_tpu.ops.bcd_sweep_ref import bcd_sweep_ref
from convex_optimization_tpu.solvers.common import SolveState, SolverConfig
from convex_optimization_tpu.solvers.fista import _check_and_record, init_state


def pick_block_size(n: int, target: int = 256, *, multiple_of: int = 1) -> int:
    """Largest divisor of n that is <= target and a multiple of `multiple_of`
    (group size alignment); falls back to the smallest valid divisor."""
    best = None
    d = multiple_of
    while d <= n:
        if n % d == 0:
            if d <= target:
                best = d
            elif best is None:
                best = d
                break
            else:
                break
        d += multiple_of
    if best is None:
        raise ValueError(f"no block size for n={n}, multiple_of={multiple_of}")
    return best


@partial(jax.jit, static_argnames=("cfg",))
def bcd(problem: Problem, block_L: jax.Array, state: SolveState,
        cfg: SolverConfig, col_norms: jax.Array | None = None,
        A_t: jax.Array | None = None) -> SolveState:
    """Run block-CD sweeps until rel. duality gap <= cfg.tol or max_iters
    (counted in sweeps).  block_L holds per-block ||A_j||_2^2 (no lam2).

    With ``cfg.use_pallas`` each sweep is the fused sweep on the
    transposed layout ``A_t = to_tblock_major(problem.A, n_blocks)`` (built
    here when not passed; api.solve hoists it), and the residual refresh
    and dual witness read A_t too.  The fused sweep's gate must accept the
    shape (ops/route.sweep_gate); it raises otherwise.
    """
    if col_norms is None and cfg.screen_every > 0:
        col_norms = problem.col_norms()
    n_blocks = block_L.shape[0]
    order = jnp.arange(n_blocks, dtype=jnp.int32)

    if cfg.use_pallas:
        from convex_optimization_tpu.ops.bcd_sweep import bcd_sweep
        from convex_optimization_tpu.ops.matvec import to_tblock_major
        from convex_optimization_tpu.ops.route import sweep_gate

        B = problem.n // n_blocks
        gsize = (problem.n // problem.penalty.ngroups
                 if problem.penalty.kind == "group_l2" else 1)
        reason = sweep_gate(problem.m, problem.n, B, 1, problem.dtype, gsize)
        if reason is not None:
            raise ValueError(f"fused sweep refused this problem: {reason}")
        if A_t is None:
            A_t = to_tblock_major(problem.A, n_blocks)

        def sweep_fn(st: SolveState):
            return bcd_sweep(problem, st.x, st.r, block_L,
                             step_scale=cfg.step_scale,
                             keep_mask=st.keep_mask, A_t=A_t)
    else:
        def sweep_fn(st: SolveState):
            return bcd_sweep_ref(
                problem, st.x, st.r, block_L, order,
                step_scale=cfg.step_scale, keep_mask=st.keep_mask,
            )

    def refresh_and_check(s: SolveState) -> SolveState:
        # exact residual refresh once per check: the sweeps maintain r
        # incrementally (n_blocks rank-B updates per sweep), so rounding
        # drift accumulates across sweeps; one extra pass over A every
        # gap_every sweeps pins it back to machine precision
        if A_t is not None:
            from convex_optimization_tpu.ops.matvec import (
                ax_minus_b_t,
                neg_at_r_t,
            )

            r_fresh = ax_minus_b_t(A_t, s.x, problem.b)
            z = neg_at_r_t(A_t, r_fresh, s.x, problem.lam2)
            return _check_and_record(problem, s._replace(r=r_fresh), cfg,
                                     col_norms, z=z)
        s = s._replace(r=problem.residual(s.x))
        return _check_and_record(problem, s, cfg, col_norms)

    def body(s: SolveState) -> SolveState:
        def one(_, st):
            x, r = sweep_fn(st)
            return st._replace(x=x, r=r, k=st.k + 1)

        s = lax.fori_loop(0, cfg.gap_every, one, s)
        return refresh_and_check(s)

    def cond(s: SolveState) -> jax.Array:
        go = (s.k < cfg.max_iters) & (s.rel_gap > cfg.tol)
        if cfg.stall_checks > 0:
            go = go & (s.stall < cfg.stall_checks)
        return go

    state = refresh_and_check(state)
    return lax.while_loop(cond, body, state)


__all__ = ["bcd", "pick_block_size", "init_state"]
