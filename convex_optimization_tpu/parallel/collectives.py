"""Collective primitives for the residual-consensus layer (SURVEY.md
sections 2.2/2.3): the flat psum default plus a ppermute ring all-reduce.

Why a ring: a ring reduction moves each device's m-vector to its neighbor
N-1 times, and each step is an independent XLA op that the latency-hiding
scheduler can overlap with compute that does not depend on it (the next
block chunk's matvec), whereas a single fused psum is one blocking op.
(The four NVLink-joined cards reach each other all to all, so the ring buys
overlap, not topology.)  This is the ring-attention analog
named in SURVEY.md section 2.2 for this framework: partial residuals
circulate around the ring while the sweep continues.

On a 1-device or CPU mesh the ring degenerates gracefully; equivalence with
psum is tested on the 8-device CPU mesh (tests/test_collectives.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def ring_psum(x: jax.Array, axis_name: str) -> jax.Array:
    """All-reduce(sum) via N-1 ppermute steps around a ring.

    Equivalent to ``lax.psum(x, axis_name)`` (tested); each step sends the
    running partial to the right neighbor and adds the received partial,
    so after N-1 steps every chip holds the full sum.
    """
    n = lax.axis_size(axis_name)
    if n == 1:
        return x
    perm = [(i, (i + 1) % n) for i in range(n)]

    # statically unrolled: n is a mesh constant, and XLA:CPU aborts on
    # ppermute inside a nested while loop (observed), so no fori_loop here
    acc, buf = x, x
    for _ in range(n - 1):
        buf = lax.ppermute(buf, axis_name, perm)
        acc = acc + buf
    return acc


def reduce_scatter_gather(x: jax.Array, axis_name: str) -> jax.Array:
    """All-reduce(sum) as reduce-scatter + all-gather — the Ulysses /
    all-to-all-family layout swap (SURVEY.md section 2.2): the summed
    residual briefly lives SHARDED (each chip owns m/p rows after the
    psum_scatter) before the all-gather restores the replicated layout.
    Equivalent to ``lax.psum`` (tested); on a torus each phase uses every
    ICI link, and XLA can schedule the gather phase independently of
    compute that only needs the caller's own shard.  Requires the axis
    size to divide ``x.shape[0]``.
    """
    n = lax.axis_size(axis_name)
    if n == 1:
        return x
    if x.shape[0] % n != 0:
        return lax.psum(x, axis_name)   # ragged rows: no tiled scatter
    shard = lax.psum_scatter(x, axis_name, scatter_dimension=0, tiled=True)
    return lax.all_gather(shard, axis_name, axis=0, tiled=True)


def ring_psum_chunked(x: jax.Array, axis_name: str, n_chunks: int = 2
                      ) -> jax.Array:
    """Ring all-reduce issued as ``n_chunks`` independent sub-reductions.

    Splitting the vector gives the XLA scheduler more freedom to overlap
    the early chunks' communication with whatever compute follows; the
    chunks are concatenated at the end.  Shapes must divide evenly.
    """
    if n_chunks <= 1:
        return ring_psum(x, axis_name)
    parts = jnp.split(x, n_chunks)
    return jnp.concatenate([ring_psum(p, axis_name) for p in parts])
