"""ppermute ring all-reduce == psum (SURVEY.md 2.2 ring-consensus analog)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from convex_optimization_tpu import solve
from convex_optimization_tpu.core.datagen import make_lasso_instance
from convex_optimization_tpu.parallel.collectives import ring_psum, ring_psum_chunked
from convex_optimization_tpu.parallel.mesh import make_mesh, BLOCKS


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8
    return make_mesh(8)


def test_ring_psum_equals_psum(mesh8):
    x = jnp.arange(8 * 16, dtype=jnp.float32).reshape(8, 16)

    def f(v):
        return ring_psum(v, BLOCKS), jax.lax.psum(v, BLOCKS)

    ring, flat = jax.jit(jax.shard_map(
        f, mesh=mesh8, in_specs=P(BLOCKS), out_specs=(P(BLOCKS), P(BLOCKS)),
    ))(x)
    # ring sums sequentially, psum is a tree: different f32 rounding
    np.testing.assert_allclose(np.asarray(ring), np.asarray(flat),
                               rtol=1e-5, atol=1e-6)


def test_ring_psum_chunked(mesh8):
    # NOTE: inside shard_map the operand is the LOCAL shard; chunking splits
    # the local vector, so the global is 1-D sharded over devices
    x = jnp.linspace(-1, 1, 8 * 32, dtype=jnp.float32)

    def f(v):
        return ring_psum_chunked(v, BLOCKS, 4), jax.lax.psum(v, BLOCKS)

    ring, flat = jax.jit(jax.shard_map(
        f, mesh=mesh8, in_specs=P(BLOCKS), out_specs=(P(BLOCKS), P(BLOCKS)),
    ))(x)
    # ring sums sequentially, psum is a tree: different f32 rounding
    np.testing.assert_allclose(np.asarray(ring), np.asarray(flat),
                               rtol=1e-5, atol=1e-6)


def test_sharded_solvers_with_ring_consensus(mesh8):
    """Ring-consensus sharded solves match the psum ones (SOLVER level).

    XLA:CPU SIGABRTs on collective-permute inside a while_loop body, so
    this runs the ring path with ``unroll_checks=True`` (static unrolled
    check loop, solvers/common.py) — same program arithmetic, no while
    thunk.  On the GPU the normal while_loop path is used.  The BCD ring run
    also exercises the SPLIT sweep (consensus of the first half-slab
    issued while the second half computes — the overlap path)."""
    inst = make_lasso_instance(jax.random.PRNGKey(11), 64, 256)
    ref = solve(inst.problem, "fista", mesh=mesh8, tol=1e-5, max_iters=400)
    ring_f = solve(inst.problem, "fista", mesh=mesh8, tol=1e-5,
                   max_iters=400, consensus="ring", unroll_checks=True)
    assert ring_f.converged
    np.testing.assert_allclose(np.asarray(ring_f.x), np.asarray(ref.x),
                               atol=5e-5)
    # BCD: compare against the SAME-config psum run (the line-searched
    # Jacobi merge may need more than these sweeps to hit tol on this
    # instance; what ring must prove is consensus equivalence)
    psum_b = solve(inst.problem, "bcd", mesh=mesh8, tol=1e-5, max_iters=200,
                   gap_every=5, block_size=16)
    ring_b = solve(inst.problem, "bcd", mesh=mesh8, tol=1e-5, max_iters=200,
                   gap_every=5, block_size=16, consensus="ring",
                   unroll_checks=True)
    assert ring_b.converged == psum_b.converged
    np.testing.assert_allclose(np.asarray(ring_b.x), np.asarray(psum_b.x),
                               atol=5e-4)


def test_ring_bcd_split_sweep_equals_psum_bcd(mesh8):
    """The overlapped split-sweep ring BCD must be numerically equivalent
    to the single-sweep psum BCD (identical local arithmetic; consensus
    split by linearity) — the data-race-analog check for the overlap."""
    inst = make_lasso_instance(jax.random.PRNGKey(12), 48, 512)
    psum_b = solve(inst.problem, "bcd", mesh=mesh8, tol=1e-5, max_iters=200,
                   gap_every=5, block_size=16)
    ring_b = solve(inst.problem, "bcd", mesh=mesh8, tol=1e-5, max_iters=200,
                   gap_every=5, block_size=16, consensus="ring",
                   unroll_checks=True)
    assert ring_b.converged == psum_b.converged
    np.testing.assert_allclose(np.asarray(ring_b.x), np.asarray(psum_b.x),
                               atol=2e-4)


def test_reduce_scatter_gather_equals_psum(mesh8):
    x = jnp.linspace(-2, 2, 8 * 64, dtype=jnp.float32)

    from convex_optimization_tpu.parallel.collectives import (
        reduce_scatter_gather,
    )

    def f(v):
        return reduce_scatter_gather(v, BLOCKS), jax.lax.psum(v, BLOCKS)

    rs, flat = jax.jit(jax.shard_map(
        f, mesh=mesh8, in_specs=P(BLOCKS), out_specs=(P(BLOCKS), P(BLOCKS)),
    ))(x)
    np.testing.assert_allclose(np.asarray(rs), np.asarray(flat),
                               rtol=1e-5, atol=1e-6)


def test_sharded_solvers_with_reduce_scatter_consensus(mesh8):
    """consensus='reduce_scatter' (Ulysses/all-to-all analog) matches the
    psum solve at the solver level."""
    inst = make_lasso_instance(jax.random.PRNGKey(31), 64, 256)
    ref = solve(inst.problem, "fista", mesh=mesh8, tol=1e-5, max_iters=400)
    rs = solve(inst.problem, "fista", mesh=mesh8, tol=1e-5, max_iters=400,
               consensus="reduce_scatter")
    assert rs.converged
    np.testing.assert_allclose(np.asarray(rs.x), np.asarray(ref.x),
                               atol=5e-5)
