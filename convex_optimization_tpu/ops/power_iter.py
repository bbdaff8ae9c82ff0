"""Lipschitz-constant estimation via power iteration (setup-time only).

The smooth part of the objective has L = ||A||_2^2 + lam2 (global step) and
per-block L_j = ||A_j||_2^2 + lam2 (block-CD steps, SURVEY.md section 3.2's
per-block Gram/Lipschitz precompute).  Power iteration costs a few dozen
passes over A at setup; the returned value is inflated by a small safety
factor so a slightly-unconverged estimate can never break the descent step.
Every product pins ``Precision.HIGHEST``: a TF32 estimate could undershoot
the constant the step size relies on.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

HI = lax.Precision.HIGHEST


def spectral_norm_sq(A: jax.Array, *, iters: int = 64, safety: float = 1.02,
                     key: jax.Array | None = None) -> jax.Array:
    """Estimate ||A||_2^2 with power iteration on A^T A (jittable)."""
    if key is None:
        key = jax.random.PRNGKey(0)
    v0 = jax.random.normal(key, (A.shape[1],), dtype=A.dtype)
    v0 = v0 / jnp.linalg.norm(v0)

    def body(_, v):
        w = jnp.dot(A.T, jnp.dot(A, v, precision=HI), precision=HI)
        return w / jnp.maximum(jnp.linalg.norm(w), 1e-30)

    v = lax.fori_loop(0, iters, body, v0)
    w = jnp.dot(A, v, precision=HI)
    return safety * jnp.vdot(w, w, precision=HI) / jnp.maximum(
        jnp.vdot(v, v, precision=HI), 1e-30)


def block_spectral_norms_sq(A: jax.Array, n_blocks: int, *, iters: int = 48,
                            safety: float = 1.02,
                            key: jax.Array | None = None) -> jax.Array:
    """Per-column-block ||A_j||_2^2 for contiguous equal blocks, batched.

    Returns shape (n_blocks,).  Runs one batched power iteration over all
    blocks at once: each sweep is two full passes over A expressed as
    einsums on the (m, n_blocks, B) reshape (a view, not a copy at trace
    level; XLA fuses the reshape into the contraction).
    """
    m, n = A.shape
    if n % n_blocks != 0:
        raise ValueError(f"n={n} not divisible by n_blocks={n_blocks}")
    B = n // n_blocks
    if key is None:
        key = jax.random.PRNGKey(1)
    Ab = A.reshape(m, n_blocks, B)
    v0 = jax.random.normal(key, (n_blocks, B), dtype=A.dtype)
    v0 = v0 / jnp.linalg.norm(v0, axis=1, keepdims=True)

    def body(_, v):
        u = jnp.einsum("mjb,jb->mj", Ab, v, precision=HI)   # A_j v_j, all j
        w = jnp.einsum("mjb,mj->jb", Ab, u, precision=HI)   # A_j^T u_j
        return w / jnp.maximum(jnp.linalg.norm(w, axis=1, keepdims=True), 1e-30)

    v = lax.fori_loop(0, iters, body, v0)
    u = jnp.einsum("mjb,jb->mj", Ab, v, precision=HI)
    num = jnp.sum(u * u, axis=0)
    den = jnp.maximum(jnp.sum(v * v, axis=1), 1e-30)
    return safety * num / den
