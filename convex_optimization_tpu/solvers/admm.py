"""ADMM splitting solver (SURVEY.md C9's splitting-method family; the
retrieved-paper set — parallel multi-block ADMM, adaptive consensus ADMM —
points squarely at this family, PAPERS.md).

Problem split:  min 0.5||Ax-b||^2 + (lam2/2)||x||^2 + g(z)  s.t. x = z.

    x+ = (A^T A + (lam2+rho) I)^{-1} (A^T b + rho (z - u))
    z+ = prox_{g/rho}(x+ + u)
    u+ = u + x+ - z+

Design decisions:
  * The x-update is EXACT via one eigendecomposition of the small-side Gram
    matrix, done once at setup (one dense eigh).  With
    G = V diag(s) V^T, the inverse for ANY shift c is V diag(1/(s+c)) V^T —
    so residual-balancing adaptive rho (He-Yang-Wang / adaptive consensus
    ADMM) costs nothing inside jit: no refactorization, just a new
    reciprocal vector.  n > m uses the Woodbury identity on A A^T (m x m);
    n <= m uses A^T A directly.
  * The whole loop is one lax.while_loop: adaptive rho, duality-gap checks
    on the feasible iterate z, and history recording all stay on device.

Per iteration: two passes over A (same speed-of-light as FISTA) plus two
thin (m x m or n x n) matmuls.  ADMM typically needs FAR fewer iterations
than first-order methods at moderate accuracy, and the exact x-update makes
it robust to ill-conditioned A where FISTA's 1/L step crawls.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from convex_optimization_tpu.core.problem import Problem
from convex_optimization_tpu.core.objective import gap_from_parts
from convex_optimization_tpu.solvers.common import (
    History,
    SolverConfig,
    count_nnz,
)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["V", "s", "Atb"],
    meta_fields=["use_woodbury"],
)
@dataclasses.dataclass(frozen=True)
class ADMMFactors:
    """Eigendecomposition of the small-side Gram (setup-time, reused for
    every rho and every lam1 on a lambda path).  ``use_woodbury`` is static
    metadata (it picks the trace-time branch of the x-update)."""

    V: jax.Array        # (k, k) eigenvectors, k = min(m, n)
    s: jax.Array        # (k,) eigenvalues of the Gram
    Atb: jax.Array      # (n,) A^T b
    use_woodbury: bool  # True: k = m (n > m), False: k = n


class ADMMState(NamedTuple):
    x: jax.Array
    z: jax.Array
    u: jax.Array
    rho: jax.Array
    k: jax.Array
    rel_gap: jax.Array
    gap: jax.Array
    primal: jax.Array
    r_prim: jax.Array   # ||x - z||
    r_dual: jax.Array   # rho * ||z - z_prev||
    history: History
    best_rel_gap: jax.Array
    stall: jax.Array
    x_best: jax.Array
    best_gap: jax.Array
    best_primal: jax.Array


def admm_setup(problem: Problem) -> ADMMFactors:
    """One-time dense factorization (jittable; MXU matmul + eigh)."""
    A, b = problem.A, problem.b
    m, n = A.shape
    if n > m:
        G = A @ A.T                          # (m, m)
        use_woodbury = True
    else:
        G = A.T @ A                          # (n, n)
        use_woodbury = False
    s, V = jnp.linalg.eigh(G)
    s = jnp.maximum(s, 0.0)                  # Gram: clip tiny negative noise
    return ADMMFactors(V=V, s=s, Atb=A.T @ b, use_woodbury=use_woodbury)


def admm_setup_host(problem: Problem) -> ADMMFactors:
    """Host-eigh setup (round 3, VERDICT r2 #8 — the attempted fix behind
    the >4096 scale fence): the Gram is computed on the DEVICE (one matmul,
    f32), fetched, and eigendecomposed in FLOAT64 on the host with LAPACK;
    the factors go back as problem-dtype arrays and the f32 iteration loop
    is unchanged.

    Rationale: the fence exists because an on-device f32 eigendecomposition
    of an ill-conditioned 10k-dim Gram is inaccurate enough to stall the
    solve near 1e-2 relative gap (BASELINE.md, round 1).  A float64 eigh is
    backward-stable at ~1e-16: the only remaining error sources are the f32
    rounding of the Gram itself (~1e-7 relative, a FIXED perturbation — the
    x-update then solves a nearby quadratic exactly) and the f32 rounding
    of applying V in the loop.  Whether that rescues 1e-6-grade convergence
    at scale is an empirical question the scale measurement answers; the
    duality-gap certificate stays honest either way (it is computed from
    the real A at the feasible iterate z)."""
    import numpy as np

    A, b = problem.A, problem.b
    m, n = A.shape
    use_woodbury = n > m
    G = jax.jit(lambda a: a @ a.T if use_woodbury else a.T @ a)(A)
    G64 = np.asarray(jax.device_get(G), dtype=np.float64)
    del G
    G64 = 0.5 * (G64 + G64.T)                # exact symmetry for LAPACK
    s64, V64 = np.linalg.eigh(G64)
    s64 = np.maximum(s64, 0.0)
    dtype = problem.dtype
    return ADMMFactors(V=jnp.asarray(V64, dtype), s=jnp.asarray(s64, dtype),
                       Atb=jax.jit(lambda a, v: a.T @ v)(A, b),
                       use_woodbury=use_woodbury)


def _x_update(problem: Problem, fac: ADMMFactors, q: jax.Array,
              c: jax.Array) -> jax.Array:
    """Solve (A^T A + c I) x = q exactly via the cached eigenbasis."""
    A = problem.A
    if fac.use_woodbury:
        # (A^T A + cI)^{-1} q = (q - A^T (AA^T + cI)^{-1} A q) / c
        Aq = A @ q
        w = fac.V @ ((fac.V.T @ Aq) / (fac.s + c))
        return (q - A.T @ w) / c
    return fac.V @ ((fac.V.T @ q) / (fac.s + c))


def init_state(problem: Problem, x0: jax.Array | None,
               cfg: SolverConfig,
               rho0: float | jax.Array | None = None) -> ADMMState:
    n, dtype = problem.n, problem.dtype
    if rho0 is None:
        # lam1-scaled start: keeps the first prox threshold lam1/rho ~ 1,
        # measured 5-50x fewer iterations than rho0=1 across the test grid
        rho0 = jnp.maximum(jnp.asarray(problem.penalty.lam1, dtype), 1e-6)
    x = jnp.zeros((n,), dtype) if x0 is None else x0.astype(dtype)
    big = jnp.asarray(jnp.inf, dtype)
    return ADMMState(
        x=x, z=x, u=jnp.zeros((n,), dtype),
        rho=jnp.asarray(rho0, dtype), k=jnp.zeros((), jnp.int32),
        rel_gap=big, gap=big, primal=big, r_prim=big, r_dual=big,
        history=History.empty(cfg.max_checks, dtype),
        best_rel_gap=big, stall=jnp.zeros((), jnp.int32),
        x_best=x, best_gap=big, best_primal=big,
    )


def _gap_check(problem: Problem, state: ADMMState) -> ADMMState:
    """Duality-gap certificate at the FEASIBLE iterate z (z is the sparse
    output; x is dense until convergence)."""
    z = state.z
    r = problem.residual(z)
    w = -(problem.A.T @ r) - problem.lam2 * z
    info = gap_from_parts(
        rho_dot_b=-jnp.vdot(r, problem.b),
        rho_aug_sq=jnp.vdot(r, r) + problem.lam2 * jnp.vdot(z, z),
        g_value=problem.penalty.value(z),
        dual_norm_value=problem.penalty.dual_norm(w),
    )
    hist = state.history.record(
        state.k, info.primal, info.dual, info.gap, info.rel_gap, count_nnz(z)
    )
    improved = info.rel_gap < state.best_rel_gap
    return state._replace(rel_gap=info.rel_gap, gap=info.gap,
                          primal=info.primal, history=hist,
                          best_rel_gap=jnp.minimum(info.rel_gap,
                                                   state.best_rel_gap),
                          stall=jnp.where(improved, 0, state.stall + 1),
                          x_best=jnp.where(improved, z, state.x_best),
                          best_gap=jnp.where(improved, info.gap,
                                             state.best_gap),
                          best_primal=jnp.where(improved, info.primal,
                                                state.best_primal))


@partial(jax.jit, static_argnames=("cfg",))
def admm(problem: Problem, fac: ADMMFactors, state: ADMMState,
         cfg: SolverConfig) -> ADMMState:
    """Run ADMM until rel. duality gap <= cfg.tol or cfg.max_iters.

    Residual balancing (adaptive consensus ADMM, PAPERS.md): rho is scaled
    by 2 whenever the primal residual exceeds 10x the dual residual (and
    vice versa), keeping both updates in lockstep; the exact eigenbasis
    x-update makes each rescale free.
    """
    pen, lam2 = problem.penalty, problem.lam2

    def step(s: ADMMState) -> ADMMState:
        c = lam2 + s.rho
        q = fac.Atb + s.rho * (s.z - s.u)
        x = _x_update(problem, fac, q, c)
        xu = x + s.u
        z = pen.prox(xu, 1.0 / s.rho)
        u = xu - z
        r_prim = jnp.linalg.norm(x - z)
        r_dual = s.rho * jnp.linalg.norm(z - s.z)
        # residual balancing with u-rescaling (u is the SCALED dual).
        # Deadband mu=2 adapts much faster than the classic mu=10 here
        # (measured: group lasso 40 iters vs stuck at 3000).
        grow = r_prim > 2.0 * r_dual
        shrink = r_dual > 2.0 * r_prim
        factor = jnp.where(grow, 2.0, jnp.where(shrink, 0.5, 1.0))
        return s._replace(x=x, z=z, u=u / factor, rho=s.rho * factor,
                          k=s.k + 1, r_prim=r_prim, r_dual=r_dual)

    def body(s: ADMMState) -> ADMMState:
        s = lax.fori_loop(0, cfg.gap_every, lambda _, st: step(st), s)
        return _gap_check(problem, s)

    def cond(s: ADMMState) -> jax.Array:
        go = (s.k < cfg.max_iters) & (s.rel_gap > cfg.tol)
        if cfg.stall_checks > 0:
            go = go & (s.stall < cfg.stall_checks)
        return go

    state = _gap_check(problem, state)
    state = lax.while_loop(cond, body, state)
    # the certified (sparse, feasible) iterate is z — expose it as the
    # solution so api.Result.x is the point the gap certificate refers to
    return state._replace(x=state.z)  # x_best already tracks the best z
