"""FISTA / ISTA proximal-gradient solver, fully jitted (SURVEY.md C2/C9).

Device-first inversion of the reference's host-driven loop (SURVEY.md section
7.1): the entire solve — iterations, momentum, duality-gap checks, history
recording, screening-mask updates — is ONE ``lax.while_loop`` program.  The
host sees a single compiled call; device<->host traffic is zero until the
final state is fetched.

Per iteration: one ``A^T`` matvec (gradient at the momentum point, obtained
via the residual-linearity trick: r_y = r_x + beta*(r_x - r_x_prev), so no
extra ``A`` pass) and one ``A`` matvec (fresh residual at the new iterate —
exact, no incremental drift).  That is the 2-passes-over-A speed-of-light
for exact first-order methods.  Gap checks add one ``A^T`` pass every
``gap_every`` iterations.

Momentum: standard FISTA t-sequence with optional O'Donoghue–Candès adaptive
restart (a cheap dot product per iteration, large practical speedup).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from convex_optimization_tpu.core.problem import Problem
from convex_optimization_tpu.core.objective import gap_from_parts, dual_witness
from convex_optimization_tpu.solvers.common import (
    History,
    SolveState,
    SolverConfig,
    count_nnz,
    record_check,
)


def fista_step(problem: Problem, L_total, state: SolveState,
               cfg: SolverConfig,
               A_t: jax.Array | None = None) -> SolveState:
    """One FISTA (or ISTA if cfg.momentum=False) iteration.

    With ``A_t`` (the transposed block-major layout, ops/matvec.py) the two
    matvecs read A_t instead of A: the working-set solver's compact slabs
    exist only in that layout."""
    A, b, lam2, penalty = problem.A, problem.b, problem.lam2, problem.penalty
    x, r, x_prev, r_prev, t = state.x, state.r, state.x_prev, state.r_prev, state.t_mom

    if cfg.momentum:
        t_next = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * t * t))
        beta = (t - 1.0) / t_next
        y = x + beta * (x - x_prev)
        r_y = r + beta * (r - r_prev)       # linearity: r_y = A y - b
    else:
        t_next = t
        y, r_y = x, r

    if A_t is not None:
        from convex_optimization_tpu.ops.matvec import (
            ax_minus_b_t,
            neg_at_r_t,
        )

        g = -neg_at_r_t(A_t, r_y, y, lam2)          # A^T r_y + lam2 y
    else:
        g = jnp.dot(A.T, r_y, precision=lax.Precision.HIGHEST) + lam2 * y
    step = 1.0 / L_total
    x_new = penalty.prox(y - step * g, step)
    x_new = jnp.where(state.keep_mask, x_new, 0.0)
    if A_t is not None:
        r_new = ax_minus_b_t(A_t, x_new, b)
    else:
        r_new = jnp.dot(A, x_new, precision=lax.Precision.HIGHEST) - b

    if cfg.momentum and cfg.adaptive_restart:
        # restart when the momentum direction opposes progress
        do_restart = jnp.vdot(y - x_new, x_new - x) > 0.0
        t_next = jnp.where(do_restart, 1.0, t_next)
        # collapse momentum by making prev == new
        x_prev_out = jnp.where(do_restart, x_new, x)
        r_prev_out = jnp.where(do_restart, r_new, r)
    else:
        x_prev_out, r_prev_out = x, r

    return state._replace(
        x=x_new, r=r_new, x_prev=x_prev_out, r_prev=r_prev_out,
        t_mom=t_next, k=state.k + 1,
    )


def _check_and_record(problem: Problem, state: SolveState, cfg: SolverConfig,
                      col_norms, z: jax.Array | None = None) -> SolveState:
    """Duality-gap check + history record (+ gap-safe screening update).

    Pass a precomputed ``z`` (= -A^T r - lam2 x) when the solver already
    has it, e.g. from the transposed layout (ops/matvec.py).
    """
    x, r = state.x, state.r
    if z is None:
        z = dual_witness(problem, x, r)     # one extra A^T pass
    hi = lax.Precision.HIGHEST
    info = gap_from_parts(
        rho_dot_b=-jnp.vdot(r, problem.b, precision=hi),
        rho_aug_sq=(jnp.vdot(r, r, precision=hi)
                    + problem.lam2 * jnp.vdot(x, x, precision=hi)),
        g_value=problem.penalty.value(x),
        dual_norm_value=problem.penalty.dual_norm(z),
    )
    keep = state.keep_mask
    if cfg.screen_every > 0:
        new_keep = problem.penalty.screen_keep(
            z, info.alpha, info.gap, col_norms,
            r_norm=jnp.sqrt(jnp.vdot(r, r, precision=hi)),
            primal=info.primal)
        keep = keep & new_keep
    return record_check(state, info, x, count_nnz(x), keep)


def init_state(problem: Problem, x0: jax.Array | None, cfg: SolverConfig,
               keep_mask: jax.Array | None = None,
               r0: jax.Array | None = None) -> SolveState:
    """``r0``: precomputed residual A x0 - b.  The working-set solver passes
    the full-width residual here: its compact problems carry no usable A
    (core/problem.py shape_override), so they must never trace
    ``problem.residual``."""
    n = problem.n
    dtype = problem.dtype
    if x0 is None:
        # r(0) = -b exactly: skips a full A @ x matvec by zeros
        x = jnp.zeros((n,), dtype)
        r = -problem.b.astype(dtype)
    else:
        x = x0.astype(dtype)
        r = problem.residual(x) if r0 is None else r0.astype(dtype)
    if keep_mask is None:
        keep_mask = jnp.ones((n,), bool)
    big = jnp.asarray(jnp.inf, dtype)
    return SolveState(
        x=x, r=r, x_prev=x, r_prev=r,
        t_mom=jnp.ones((), dtype), k=jnp.zeros((), jnp.int32),
        rel_gap=big, gap=big, primal=big,
        keep_mask=keep_mask,
        history=History.empty(cfg.max_checks, dtype),
        best_rel_gap=big, stall=jnp.zeros((), jnp.int32),
        x_best=x, best_gap=big, best_primal=big,
    )


@partial(jax.jit, static_argnames=("cfg",))
def fista(problem: Problem, L_total, state: SolveState, cfg: SolverConfig,
          col_norms: jax.Array | None = None,
          A_t: jax.Array | None = None) -> SolveState:
    """Run FISTA until rel. duality gap <= cfg.tol or cfg.max_iters (jitted).

    L_total must be >= ||A||_2^2 + lam2 (see ops.power_iter).  The loop body
    runs ``gap_every`` iterations then one gap check, so the whole solve is a
    single while_loop with zero host synchronization.

    Pass ``A_t = to_tblock_major(problem.A, n_blocks)`` to run every
    matvec (steps and the gap-check witness) on the transposed layout.
    """
    if col_norms is None and cfg.screen_every > 0:
        col_norms = problem.col_norms()

    def check(s: SolveState) -> SolveState:
        if A_t is not None:
            from convex_optimization_tpu.ops.matvec import neg_at_r_t

            z = neg_at_r_t(A_t, s.r, s.x, problem.lam2)
            return _check_and_record(problem, s, cfg, col_norms, z=z)
        return _check_and_record(problem, s, cfg, col_norms)

    def body(s: SolveState) -> SolveState:
        s = lax.fori_loop(
            0, cfg.gap_every,
            lambda _, st: fista_step(problem, L_total, st, cfg, A_t), s
        )
        return check(s)

    def cond(s: SolveState) -> jax.Array:
        go = (s.k < cfg.max_iters) & (s.rel_gap > cfg.tol)
        if cfg.stall_checks > 0:
            go = go & (s.stall < cfg.stall_checks)
        return go

    # record the initial point too (check slot 0)
    state = check(state)
    return lax.while_loop(cond, body, state)
