"""The fused sweep over the transposed layout (ops/bcd_sweep.py) vs the jnp
oracle (ops/bcd_sweep_ref.py).

On the CPU the route is the plain ``lax.scan`` sweep (ops/route.py), so
these tests check the layout, blocking, prox and masking arithmetic that
the card's kernel is compared against; the kernel itself is checked on the
card by the ``gpu``-marked tests and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from convex_optimization_tpu.core.datagen import make_lasso_instance
from convex_optimization_tpu.ops.bcd_sweep_ref import bcd_sweep_ref
from convex_optimization_tpu.ops import cuda_sweep
from convex_optimization_tpu.ops.bcd_sweep import bcd_sweep
from convex_optimization_tpu.ops.matvec import to_tblock_major
from convex_optimization_tpu.ops.route import pick_block_size, sweep_gate


def eligible(m, n, block, dtype=jnp.float32):
    return sweep_gate(m, n, block, 1, dtype) is None
from convex_optimization_tpu.ops.power_iter import block_spectral_norms_sq


def _setup(m=64, n=1024, penalty_kind="l1", ngroups=0, lam2=0.0, seed=0,
           n_blocks=8):
    inst = make_lasso_instance(
        jax.random.PRNGKey(seed), m, n,
        penalty_kind=penalty_kind, ngroups=ngroups, lam2=lam2,
    )
    p = inst.problem
    block_L = block_spectral_norms_sq(p.A, n_blocks)
    x = p.penalty.prox(-0.5 / jnp.max(block_L) * (p.A.T @ (-p.b)),
                       0.5 / jnp.max(block_L))
    r = p.residual(x)
    return p, x, r, block_L


@pytest.mark.parametrize("kind,ngroups,lam2", [
    ("l1", 0, 0.0),
    ("l1", 0, 0.3),           # elastic net
    ("nonneg_l1", 0, 0.0),
    ("group_l2", 16, 0.0),
    ("group_l2", 16, 0.1),
])
def test_sweep_parity(kind, ngroups, lam2):
    p, x, r, block_L = _setup(penalty_kind=kind, ngroups=ngroups, lam2=lam2)
    order = jnp.arange(block_L.shape[0], dtype=jnp.int32)
    x_ref, r_ref = bcd_sweep_ref(p, x, r, block_L, order)
    x_v, r_v = bcd_sweep(p, x, r, block_L)
    # plain f32 arithmetic in another association order than the oracle
    np.testing.assert_allclose(np.asarray(x_v), np.asarray(x_ref),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(r_v), np.asarray(r_ref),
                               rtol=1e-5, atol=1e-6)


def test_sweep_parity_with_mask_and_damping():
    p, x, r, block_L = _setup()
    keep = jax.random.bernoulli(jax.random.PRNGKey(7), 0.7, (p.n,))
    order = jnp.arange(block_L.shape[0], dtype=jnp.int32)
    x_ref, r_ref = bcd_sweep_ref(p, x, r, block_L, order,
                                 step_scale=0.5, keep_mask=keep)
    x_v, r_v = bcd_sweep(p, x, r, block_L, step_scale=0.5,
                             keep_mask=keep)
    np.testing.assert_allclose(np.asarray(x_v), np.asarray(x_ref),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(r_v), np.asarray(r_ref),
                               rtol=1e-5, atol=1e-6)
    assert np.all(np.asarray(x_v)[~np.asarray(keep)] == 0.0)


def test_sublane_only_block_alignment():
    """B only needs 8-alignment, not a power of two."""
    p, x, r, block_L = _setup(m=56, n=1008, n_blocks=14)   # B = 72
    assert eligible(56, 1008, 72)
    order = jnp.arange(14, dtype=jnp.int32)
    x_ref, r_ref = bcd_sweep_ref(p, x, r, block_L, order)
    x_v, r_v = bcd_sweep(p, x, r, block_L)
    np.testing.assert_allclose(np.asarray(x_v), np.asarray(x_ref),
                               rtol=1e-5, atol=1e-6)


def test_eligibility_covers_headline():
    # the (B, m/SMs) tile of one block fits a CTA's shared memory at the
    # north-star size, so the fused kernel serves the headline bench
    assert eligible(10_000, 100_096, 128)
    assert cuda_sweep.plan(10_000, 128)["stages"] >= 2
    # pad-free block sizes are preferred (a padded A is another full-size
    # device copy); n=100000 divides at B=80
    assert pick_block_size(10_000, 100_000, 128) == (80, 0)
    # at m=200k one CTA's tile of 128 columns no longer fits, but the
    # picker recovers by shrinking B
    assert cuda_sweep.plan(200_000, 128) is None
    picked = pick_block_size(200_000, 1_000_000, 128)
    assert picked is not None and picked[0] < 128
    # non-f32 and ragged shapes decline
    assert not eligible(10_000, 100_096, 128, jnp.float64)
    assert not eligible(10_001, 100_096, 128)      # m % 8
    assert not eligible(10_000, 100_000, 129)      # B % 8


def test_to_tblock_major_roundtrip():
    A = jnp.arange(6 * 8, dtype=jnp.float32).reshape(6, 8)
    A_t = to_tblock_major(A, 2)            # (2, 4, 6)
    assert A_t.shape == (2, 4, 6)
    np.testing.assert_array_equal(np.asarray(A_t[1, 2]),
                                  np.asarray(A[:, 6]))


def test_to_tblock_major_in_pieces(monkeypatch):
    """Outside jit a large A is relaid in pieces written in place; the
    result is the same layout as the one-shot transpose, in or out of
    jit."""
    import convex_optimization_tpu.ops.matvec as mv

    A = jax.random.normal(jax.random.PRNGKey(2), (48, 240))
    ref = A.reshape(48, 10, 24).transpose(1, 2, 0)
    # room for 3 blocks per piece -> pieces of 2 (a divisor of 10)
    monkeypatch.setattr(mv, "TRANSPOSE_PIECE_BYTES", 48 * 24 * 4 * 3)
    np.testing.assert_array_equal(np.asarray(mv.to_tblock_major(A, 10)),
                                  np.asarray(ref))
    np.testing.assert_array_equal(
        np.asarray(jax.jit(lambda a: mv.to_tblock_major(a, 10))(A)),
        np.asarray(ref))


def test_fallback_when_ineligible(monkeypatch):
    """A shape the fused sweep refuses is never swept silently by another
    route: bcd(use_pallas) raises, and solve('bcd_pallas') warns and runs
    plain bcd, which Result.method records."""
    import dataclasses

    from convex_optimization_tpu.api import solve
    from convex_optimization_tpu.solvers.bcd import bcd
    from convex_optimization_tpu.solvers.common import SolverConfig
    from convex_optimization_tpu.solvers.fista import init_state

    monkeypatch.setattr(cuda_sweep, "SMEM_LIMIT", 1024)
    p, x, r, block_L = _setup()
    cfg = SolverConfig(use_pallas=True, max_iters=20)
    with pytest.raises(ValueError, match="fused sweep refused"):
        bcd(p, block_L, init_state(p, None, cfg), cfg)
    with pytest.warns(UserWarning, match="bcd_pallas gate failed"):
        res = solve(p, "bcd_pallas", tol=1e-5, max_iters=3000)
    assert res.method == "bcd"
    ref = solve(p, "bcd", tol=1e-5, max_iters=3000)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                               rtol=1e-6)
    assert dataclasses.replace(res.config, use_pallas=False) == res.config


def test_multiple_sweeps_converge():
    from convex_optimization_tpu.core.objective import primal_value

    p, x, r, block_L = _setup(m=48, n=512, n_blocks=4)
    prev = float(primal_value(p, x, r))
    for _ in range(5):
        x, r = bcd_sweep(p, x, r, block_L)
        cur = float(primal_value(p, x, r))
        assert cur <= prev + 1e-6
        prev = cur


def test_solve_end_to_end_uses_vpu():
    """api.solve('bcd_pallas') must take the fused sweep at an eligible
    size and return a solution matching FISTA."""
    from convex_optimization_tpu.api import solve

    inst = make_lasso_instance(jax.random.PRNGKey(3), 256, 1000)
    assert pick_block_size(256, 1000, 128) is not None
    res_p = solve(inst.problem, "bcd_pallas", tol=1e-5, max_iters=3000,
                  block_size=128)
    res_f = solve(inst.problem, "fista", tol=1e-6, max_iters=5000)
    assert res_p.method == "bcd_pallas"
    assert res_p.x.shape == (1000,)
    assert res_p.converged
    np.testing.assert_allclose(np.asarray(res_p.x), np.asarray(res_f.x),
                               atol=5e-4)
