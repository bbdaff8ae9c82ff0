"""Matrix-vector products over the transposed block-major layout
``A_t`` (n_blocks, B, m), in plain ``jnp``.

Row c of ``A_t.reshape(n, m)`` is column c of A, so every product here is
one matrix-vector product (or, batched over L lambdas, one thin matrix
product) that XLA hands to cuBLAS on the GPU.  All are float32 products that
feed a residual, a dual witness, a gap or a step size, so every dot pins
``Precision.HIGHEST``: on the GPU XLA may otherwise run the (L, m) x (m, n)
shapes in TF32, which keeps about three decimal digits.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

HIGHEST = lax.Precision.HIGHEST

#: Largest piece of A one program transposes when building A_t eagerly: the
#: GPU compiler's autotuner allocates its own copies of an op's operands and
#: output, so a single transpose of a 16 GB A would need several times 16 GB.
TRANSPOSE_PIECE_BYTES = 1 << 30


def to_tblock_major(A: jax.Array, n_blocks: int) -> jax.Array:
    """(m, n) -> (n_blocks, B, m): each column block stored transposed and
    contiguous (a one-time device relayout; hoist it out of solve loops).
    Outside jit a large A is transposed in pieces of at most
    TRANSPOSE_PIECE_BYTES, written in place into the result."""
    m, n = A.shape
    B = n // n_blocks
    per = max(1, TRANSPOSE_PIECE_BYTES // (B * m * A.dtype.itemsize))
    per = max(d for d in range(1, min(per, n_blocks) + 1) if n_blocks % d == 0)
    if per == n_blocks or isinstance(A, jax.core.Tracer):
        return A.reshape(m, n_blocks, B).transpose(1, 2, 0)
    A_t = jnp.zeros((n_blocks, B, m), A.dtype)
    for j0 in range(0, n_blocks, per):
        A_t = _put_piece(A_t, _piece(A, j0, per=per, B=B), j0)
    return A_t


@functools.partial(jax.jit, static_argnames=("per", "B"))
def _piece(A, j0, *, per, B):
    m = A.shape[0]
    cols = lax.dynamic_slice_in_dim(A, j0 * B, per * B, axis=1)
    return cols.reshape(m, per, B).transpose(1, 2, 0)


@functools.partial(jax.jit, donate_argnums=0)
def _put_piece(A_t, piece, j0):
    return lax.dynamic_update_slice(A_t, piece, (j0, 0, 0))


def _rows(A_t):
    n_blocks, B, m = A_t.shape
    return A_t.reshape(n_blocks * B, m)


def ax_minus_b_t(A_t: jax.Array, x: jax.Array, b: jax.Array) -> jax.Array:
    """r = A x - b.  x is (n,), r is (m,)."""
    return jnp.dot(x, _rows(A_t), precision=HIGHEST) - b


def neg_at_r_t(A_t: jax.Array, r: jax.Array, x: jax.Array, lam2
               ) -> jax.Array:
    """Dual witness z = -(A^T r) - lam2 x, (n,)."""
    return -jnp.dot(_rows(A_t), r, precision=HIGHEST) - lam2 * x


def ax_minus_b_batch_t(A_t: jax.Array, X: jax.Array, b: jax.Array
                       ) -> jax.Array:
    """R = A X - b rows: X (n_blocks, L, B) -> R (L, m)."""
    return jnp.einsum("jlb,jbm->lm", X, A_t, precision=HIGHEST) - b[None, :]


def neg_at_r_batch_t(A_t: jax.Array, R: jax.Array, X: jax.Array, lam2
                     ) -> jax.Array:
    """Z = -(A^T R) - lam2 X batched: R (L, m), X (n_blocks, L, B) ->
    Z (n_blocks, L, B)."""
    return -jnp.einsum("jbm,lm->jlb", A_t, R, precision=HIGHEST) - lam2 * X


def block_power_t(A_t: jax.Array, *, iters: int = 48, safety: float = 1.02
                  ) -> jax.Array:
    """Per-block ||A_j||_2^2, (n_blocks,): a power iteration batched over
    the blocks (ops/power_iter.block_spectral_norms_sq on the A_t layout),
    two passes over A per iteration."""
    n_blocks, B, m = A_t.shape
    # deterministic start: ones plus a small tilt (orthogonality to the
    # top singular vector has measure zero; the tilt breaks symmetry)
    v0 = jnp.broadcast_to(
        1.0 + 0.01 * jnp.arange(B, dtype=A_t.dtype) / max(B, 1),
        (n_blocks, B))

    def matvec_pair(v):
        u = jnp.einsum("jbm,jb->jm", A_t, v, precision=HIGHEST)
        return u, jnp.einsum("jbm,jm->jb", A_t, u, precision=HIGHEST)

    def body(_, v):
        _, w = matvec_pair(v)
        return w / jnp.maximum(jnp.linalg.norm(w, axis=1, keepdims=True),
                               1e-30)

    v = lax.fori_loop(0, iters, body, v0)
    u, _ = matvec_pair(v)
    num = jnp.sum(u * u, axis=1)
    den = jnp.maximum(jnp.sum(v * v, axis=1), 1e-30)
    return safety * num / den


def spectral_norm_sq_t(A_t: jax.Array, *, iters: int = 48,
                       safety: float = 1.02) -> jax.Array:
    """||A||_2^2 by power iteration over the A_t products (same safety
    margin as ops/power_iter.spectral_norm_sq)."""
    n_blocks, B, m = A_t.shape
    n = n_blocks * B
    zeros_m = jnp.zeros((m,), A_t.dtype)
    zeros_n = jnp.zeros((n,), A_t.dtype)
    v0 = jnp.sin(jnp.arange(1, n + 1, dtype=A_t.dtype))
    v0 = v0 / jnp.linalg.norm(v0)

    def body(_, v):
        u = ax_minus_b_t(A_t, v, zeros_m)                  # A v
        w = -neg_at_r_t(A_t, u, zeros_n, 0.0)              # A^T u
        return w / jnp.maximum(jnp.linalg.norm(w), 1e-30)

    v = lax.fori_loop(0, iters, body, v0)
    u = ax_minus_b_t(A_t, v, zeros_m)
    return safety * jnp.vdot(u, u, precision=HIGHEST) / jnp.maximum(
        jnp.vdot(v, v, precision=HIGHEST), 1e-30)
