"""The fused Gauss-Seidel block sweep over the transposed layout A_t.

One sweep visits every column block j of A_t (n_blocks, B, m) in order and,
for L >= 1 problems that share A (a lambda grid, or one lambda), runs

    g_l   = A_j^T r_l + lam2 x_jl
    x_jl' = prox_{t_j lam1_l}(x_jl - t_j g_l)      t_j = step_scale/(L_j+lam2)
    r_l  += rm * A_j (x_jl' - x_jl)                 rm: optional row mask

A stored block-transposed makes both products of block j read one
contiguous (B, m) slab, so one streamed read of A per sweep serves every
lambda.  The row mask sweeps the row-masked problem (rm * A, rm * b) against
the unmasked A as long as the residual rows come in masked:
(rm * A_j)^T r = A_j^T (rm * r) = A_j^T r for such r, and gating the update
keeps them masked.  K-fold CV rides on this.

Two implementations, chosen by ops/route.py: the Hopper kernel
(ops/cuda_sweep.py) and :func:`batch_sweep_ref`, a plain ``lax.scan`` that
is also the kernel's reference.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from convex_optimization_tpu.core.problem import Problem
from convex_optimization_tpu.ops import route as route_mod
from convex_optimization_tpu.ops.matvec import HIGHEST, to_tblock_major


def _prox(kind: str, v, tl, gsize: int, w_j):
    """Prox of the (L, B) block rows with per-row thresholds tl (L, 1)."""
    if kind == "l1":
        return jnp.sign(v) * jnp.maximum(jnp.abs(v) - tl, 0.0)
    if kind == "nonneg_l1":
        return jnp.maximum(v - tl, 0.0)
    if kind == "group_l2":
        L, B = v.shape
        vg = v.reshape(L, B // gsize, gsize)
        gn = jnp.sqrt(jnp.sum(vg * vg, axis=2))                 # (L, gpb)
        scale = jnp.maximum(0.0, 1.0 - tl * w_j / jnp.maximum(gn, 1e-30))
        return (vg * scale[:, :, None]).reshape(L, B)
    raise ValueError(f"unknown penalty kind {kind!r}")


def batch_sweep_ref(A_t, X, R, steps, lam1s, lam2, *, kind: str,
                    gsize: int = 1, weights=None, mask=None, row_mask=None):
    """One sweep as a ``lax.scan`` over the blocks (the plain route).

    A_t (nb, B, m), X (nb, L, B), R (L, m), steps (nb,) shared by every
    lambda, lam1s (L,).  ``weights``: group weights, nb * (B // gsize)
    elements (group_l2); ``mask``: keep mask, nb * B elements, 0 freezes a
    coordinate at 0; ``row_mask`` (m,): see the module docstring.
    Returns (X, R).  Works in any float dtype."""
    nb, B, m = A_t.shape
    dtype = A_t.dtype
    lam1s = jnp.asarray(lam1s, dtype).reshape(-1)
    w = (jnp.asarray(weights, dtype).reshape(nb, B // gsize)
         if kind == "group_l2" else jnp.zeros((nb, 1), dtype))
    keep = (None if mask is None
            else jnp.asarray(mask, dtype).reshape(nb, B))
    rm = None if row_mask is None else jnp.asarray(row_mask, dtype)

    def body(R, j):
        Aj = A_t[j]                                             # (B, m)
        xj = X[j]                                               # (L, B)
        g = jnp.einsum("bm,lm->lb", Aj, R, precision=HIGHEST) + lam2 * xj
        t = steps[j]
        v = xj - t * g
        xn = _prox(kind, v, t * lam1s[:, None], gsize, w[j][None, :])
        if keep is not None:
            xn = jnp.where(keep[j][None, :] > 0, xn, 0.0)
        upd = jnp.einsum("bm,lb->lm", Aj, xn - xj, precision=HIGHEST)
        if rm is not None:
            upd = rm[None, :] * upd
        return R + upd, xn

    R, Xn = lax.scan(body, R, jnp.arange(nb))
    return Xn, R


def batch_sweep(A_t, X, R, steps, lam1s, lam2, *, kind: str,
                gsize: int = 1, weights=None, mask=None, row_mask=None,
                route: str | None = None):
    """One batched sweep on the route ops/route.py picks (``route=None``)
    or on the one named.  Same contract as :func:`batch_sweep_ref`."""
    route = route_mod.check_route(route, A_t.dtype)
    if route == route_mod.CUDA:
        from convex_optimization_tpu.ops.cuda_sweep import batch_sweep_cuda

        return batch_sweep_cuda(A_t, X, R, steps, lam1s, lam2, kind=kind,
                                gsize=gsize, weights=weights, mask=mask,
                                row_mask=row_mask)
    return batch_sweep_ref(A_t, X, R, steps, lam1s, lam2, kind=kind,
                           gsize=gsize, weights=weights, mask=mask,
                           row_mask=row_mask)


def bcd_sweep(problem: Problem, x: jax.Array, r: jax.Array,
              block_L: jax.Array, *, step_scale: float = 1.0,
              keep_mask: jax.Array | None = None,
              A_t: jax.Array | None = None) -> tuple[jax.Array, jax.Array]:
    """One single-lambda sweep (L = 1) in cyclic block order; returns
    (x, r).  Drop-in for ops/bcd_sweep_ref.bcd_sweep_ref with block_order
    = arange.  Pass ``A_t = to_tblock_major(problem.A, n_blocks)`` when
    sweeping in a loop so the relayout is hoisted (solvers/bcd.py does)."""
    # problem.m/n, not A.shape: compact working-set problems carry a tiny
    # audit stand-in for A (core/problem.py shape_override)
    m, n = problem.m, problem.n
    n_blocks = block_L.shape[0]
    if n % n_blocks:
        raise ValueError(f"n={n} not divisible by n_blocks={n_blocks}")
    B = n // n_blocks
    dtype = problem.dtype
    if A_t is None:
        A_t = to_tblock_major(problem.A, n_blocks)
    penalty, lam2 = problem.penalty, problem.lam2
    gsize, w = 1, None
    if penalty.kind == "group_l2":
        gsize = n // penalty.ngroups
        if B % gsize:
            raise ValueError(
                f"block size {B} must contain whole groups (gsize={gsize})")
        w = penalty._gweights(dtype)
    steps = (step_scale / (block_L + lam2)).astype(dtype)
    lam1s = jnp.reshape(jnp.asarray(penalty.lam1, dtype), (1,))
    X, R = batch_sweep(A_t, x.reshape(n_blocks, 1, B), r.reshape(1, m),
                       steps, lam1s, lam2, kind=penalty.kind, gsize=gsize,
                       weights=w, mask=keep_mask)
    return X.reshape(n), R.reshape(m)
