"""Objective, Fenchel dual, and the certified duality-gap monitor.

This is the framework's upgrade of the reference's relative-objective-gap
stopping rule (SURVEY.md section 3.4): instead of comparing against the best
objective seen, we certify optimality with a duality gap built from a scaled
residual, which is valid for every penalty family via the augmented-matrix
view of the elastic net (see models/penalties.py for the conventions).

Definitions (r = A x - b, rho = -r, rho~ = [rho; -sqrt(lam2) x]):

    z      = A^T rho - lam2 x           (= A~^T rho~)
    alpha  = 1 / max(1, dual_norm(z))   (theta = alpha * rho~ is dual-feasible)
    P(x)   = 0.5*(||r||^2 + lam2*||x||^2) + g(x)
    D(th)  = alpha * <rho, b> - 0.5 * alpha^2 * (||r||^2 + lam2*||x||^2)
    gap    = P(x) - D(theta)  >= P(x) - P(x*)  >= 0

``gap_from_parts`` exposes the same arithmetic on pre-reduced scalars so the
sharded solvers (parallel/) can psum local partials and share this exact code.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from convex_optimization_tpu.core.problem import Problem
from convex_optimization_tpu.models.penalties import Penalty


class GapInfo(NamedTuple):
    gap: jax.Array      # duality gap (absolute)
    primal: jax.Array   # P(x)
    dual: jax.Array     # D(theta)
    alpha: jax.Array    # residual scaling that made theta feasible
    rel_gap: jax.Array  # gap / max(|P|, tiny) — the 1e-6-grade criterion


def gap_from_parts(
    rho_dot_b: jax.Array,
    rho_aug_sq: jax.Array,
    g_value: jax.Array,
    dual_norm_value: jax.Array,
) -> GapInfo:
    """Duality gap from pre-reduced scalars (shared by local & sharded paths).

    rho_dot_b:       <rho, b> = <b - Ax, b>
    rho_aug_sq:      ||r||^2 + lam2*||x||^2
    g_value:         g(x)  (the nonsmooth penalty value)
    dual_norm_value: penalty.dual_norm(z), global max across shards

    theta = alpha * rho~ is dual-feasible for every alpha in
    [0, 1/dual_norm]; D(alpha) = alpha <rho,b> - alpha^2/2 ||rho~||^2 is a
    concave parabola, so the OPTIMAL feasible alpha on the ray is the
    unconstrained maximizer <rho,b>/||rho~||^2 clipped to the feasible
    interval.  Round 1 used alpha = 1/max(1, dual_norm), which near the
    optimum sits on the wrong side of the parabola's tip and read gaps up
    to ~10x looser (measured on group-sparse instances); the clipped
    optimum is a uniformly tighter and still sound certificate — solves
    certify in fewer iterations and gap-safe screens get tighter radii.
    """
    feas = 1.0 / jnp.maximum(dual_norm_value, 1e-30)
    opt = rho_dot_b / jnp.maximum(rho_aug_sq,
                                  jnp.finfo(rho_aug_sq.dtype).tiny)
    alpha = jnp.clip(opt, 0.0, feas)
    primal = 0.5 * rho_aug_sq + g_value
    dual = alpha * rho_dot_b - 0.5 * alpha * alpha * rho_aug_sq
    gap = primal - dual
    rel = gap / jnp.maximum(jnp.abs(primal), jnp.finfo(primal.dtype).tiny)
    return GapInfo(gap=gap, primal=primal, dual=dual, alpha=alpha, rel_gap=rel)


def dual_witness(problem: Problem, x: jax.Array, r: jax.Array) -> jax.Array:
    """z = A~^T rho~ = -A^T r - lam2 x, the unscaled dual certificate."""
    return (-jnp.dot(problem.A.T, r, precision=lax.Precision.HIGHEST)
            - problem.lam2 * x)


def duality_gap(problem: Problem, x: jax.Array, r: jax.Array | None = None,
                z: jax.Array | None = None, *, precise: bool = False) -> GapInfo:
    """Certified duality gap at x.  r = Ax - b is recomputed if not given;
    pass a precomputed z (= -A^T r - lam2 x) to reuse a solver's matvec.

    precise=True recomputes everything in float64 (requires jax_enable_x64;
    used by the verification path — the f32 certificate has a noise floor of
    a few 1e-6 relative near the optimum, SURVEY.md section 7.4)."""
    if precise:
        import dataclasses

        if not jax.config.jax_enable_x64:
            raise RuntimeError(
                "duality_gap(precise=True) needs float64: enable it with "
                "jax.config.update('jax_enable_x64', True) (CPU verification "
                "path), or use the default f32 certificate."
            )
        problem = dataclasses.replace(
            problem,
            A=problem.A.astype(jnp.float64),
            b=problem.b.astype(jnp.float64),
        )
        x = x.astype(jnp.float64)
        r = z = None
    if r is None:
        r = problem.residual(x)
    if z is None:
        z = dual_witness(problem, x, r)
    hi = lax.Precision.HIGHEST
    rho_aug_sq = (jnp.vdot(r, r, precision=hi)
                  + problem.lam2 * jnp.vdot(x, x, precision=hi))
    return gap_from_parts(
        rho_dot_b=-jnp.vdot(r, problem.b, precision=hi),
        rho_aug_sq=rho_aug_sq,
        g_value=problem.penalty.value(x),
        dual_norm_value=problem.penalty.dual_norm(z),
    )


def primal_value(problem: Problem, x: jax.Array, r: jax.Array | None = None) -> jax.Array:
    if r is None:
        r = problem.residual(x)
    return (0.5 * (jnp.vdot(r, r) + problem.lam2 * jnp.vdot(x, x))
            + problem.penalty.value(x))


def dual_value(problem: Problem, x: jax.Array, r: jax.Array | None = None) -> jax.Array:
    return duality_gap(problem, x, r).dual


def raw_dual_norm(z: jax.Array, penalty: Penalty) -> jax.Array:
    """The penalty's raw dual norm of a witness z (the λ at which x = 0
    satisfies the optimality condition against this witness)."""
    if penalty.kind == "l1":
        raw = jnp.max(jnp.abs(z))
    elif penalty.kind == "nonneg_l1":
        raw = jnp.maximum(jnp.max(z), 0.0)
    elif penalty.kind == "group_l2":
        gn = jnp.linalg.norm(z.reshape(penalty.ngroups, -1), axis=1)
        w = (jnp.ones((penalty.ngroups,), z.dtype) if penalty.weights is None
             else penalty.weights)
        raw = jnp.max(gn / w)
    else:
        raise ValueError(f"unknown penalty kind {penalty.kind!r}")
    return raw


def lambda_max(A: jax.Array, b: jax.Array, penalty: Penalty) -> jax.Array:
    """Smallest lam1 at which x* = 0 is optimal (unit test: x=0 at lam >= this).

    At x = 0 the dual witness is z = A^T b; lam_max is its raw dual norm.
    When only the transposed layout A_t is resident, use
    :func:`lambda_max_t`.
    """
    return raw_dual_norm(jnp.dot(A.T, b, precision=lax.Precision.HIGHEST),
                         penalty)


def lambda_max_t(A_t: jax.Array, b: jax.Array, penalty: Penalty
                 ) -> jax.Array:
    """`lambda_max` on the transposed layout A_t (ops/matvec.py): one pass
    over A_t, for callers that no longer hold A (cv.py's free_A)."""
    from convex_optimization_tpu.ops.matvec import neg_at_r_t

    n_blocks, B, _ = A_t.shape
    z = neg_at_r_t(A_t, -b, jnp.zeros((n_blocks * B,), A_t.dtype), 0.0)
    return raw_dual_norm(z, penalty)
