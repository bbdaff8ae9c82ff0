"""Products and block power iteration over the transposed layout A_t
(ops/matvec.py) vs their references on A, and the solvers that use them."""

import jax
import jax.numpy as jnp
import numpy as np

from convex_optimization_tpu.core.datagen import make_lasso_instance
from convex_optimization_tpu.ops.matvec import (
    ax_minus_b_t,
    block_power_t,
    neg_at_r_t,
    to_tblock_major,
)
from convex_optimization_tpu.ops.power_iter import block_spectral_norms_sq


def _setup(m=64, n=1024, n_blocks=8, seed=0):
    inst = make_lasso_instance(jax.random.PRNGKey(seed), m, n)
    p = inst.problem
    A_t = to_tblock_major(p.A, n_blocks)
    return p, A_t


def test_ax_minus_b_parity():
    p, A_t = _setup()
    x = jax.random.normal(jax.random.PRNGKey(3), (p.n,), p.dtype)
    r_ref = p.A @ x - p.b
    r_k = ax_minus_b_t(A_t, x, p.b)
    np.testing.assert_allclose(np.asarray(r_k), np.asarray(r_ref),
                               rtol=1e-5, atol=1e-5)


def test_neg_at_r_parity():
    p, A_t = _setup()
    lam2 = 0.3
    x = jax.random.normal(jax.random.PRNGKey(4), (p.n,), p.dtype)
    r = jax.random.normal(jax.random.PRNGKey(5), (p.m,), p.dtype)
    z_ref = -(p.A.T @ r) - lam2 * x
    z_k = neg_at_r_t(A_t, r, x, lam2)
    np.testing.assert_allclose(np.asarray(z_k), np.asarray(z_ref),
                               rtol=1e-5, atol=1e-5)


def test_block_power_matches_einsum_version():
    p, A_t = _setup(m=96, n=512, n_blocks=4)
    ref = block_spectral_norms_sq(p.A, 4)
    k = block_power_t(A_t)
    # both are power-iteration ESTIMATES with the same 1.02 safety margin
    # (different starting vectors -> a few % of convergence slop; validity
    # is what matters and is covered by the upper-bound test below)
    np.testing.assert_allclose(np.asarray(k), np.asarray(ref), rtol=5e-2)


def test_block_power_is_valid_upper_bound():
    """The kernel estimate (with safety) must upper-bound the true per-block
    spectral norm — an underestimate would break the descent step."""
    p, A_t = _setup(m=80, n=768, n_blocks=6)
    est = np.asarray(block_power_t(A_t))
    A = np.asarray(p.A)
    B = p.n // 6
    for j in range(6):
        true = np.linalg.norm(A[:, j * B:(j + 1) * B], 2) ** 2
        assert est[j] >= true * 0.999, (j, est[j], true)


def test_bcd_with_hoisted_A_t_matches_plain():
    """bcd(A_t=...) (fused sweep, refresh + witness on A_t) must match the
    plain bcd solve on A."""
    from convex_optimization_tpu.solvers.bcd import bcd
    from convex_optimization_tpu.solvers.common import SolverConfig
    from convex_optimization_tpu.solvers.fista import init_state

    inst = make_lasso_instance(jax.random.PRNGKey(7), 128, 512)
    p = inst.problem
    cfg = SolverConfig(tol=1e-5, max_iters=2000, gap_every=5,
                       use_pallas=True, block_size=128)
    n_blocks = p.n // 128
    A_t = to_tblock_major(p.A, n_blocks)
    bL = block_power_t(A_t)
    s_k = bcd(p, bL, init_state(p, None, cfg), cfg, None, A_t)
    bL_ref = block_spectral_norms_sq(p.A, n_blocks)
    s_ref = bcd(p, bL_ref, init_state(p, None, cfg), cfg)
    assert float(s_k.best_rel_gap) <= 1e-5
    np.testing.assert_allclose(np.asarray(s_k.x_best),
                               np.asarray(s_ref.x_best), atol=5e-5)


def test_spectral_norm_kernel_matches_einsum():
    from convex_optimization_tpu.ops.matvec import spectral_norm_sq_t
    from convex_optimization_tpu.ops.power_iter import spectral_norm_sq

    p, A_t = _setup(m=96, n=512, n_blocks=4)
    ref = float(spectral_norm_sq(p.A))
    k = float(spectral_norm_sq_t(A_t))
    assert abs(k - ref) / ref < 2e-2
    # valid upper bound on the true spectral norm
    true = float(np.linalg.norm(np.asarray(p.A), 2) ** 2)
    assert k >= true * 0.999


def test_fista_with_A_t_matches_plain():
    """fista(A_t=...) (matvecs on A_t) must match fista on A."""
    from convex_optimization_tpu.solvers.common import SolverConfig
    from convex_optimization_tpu.solvers.fista import fista, init_state
    from convex_optimization_tpu.ops.power_iter import spectral_norm_sq

    inst = make_lasso_instance(jax.random.PRNGKey(8), 128, 512)
    p = inst.problem
    # tol above the f32 floor: the two layouts reduce in another order,
    # so at tol=1e-6 one path can land at 1.05e-6 while the other converges
    cfg = SolverConfig(tol=5e-6, max_iters=3000, gap_every=5)
    L = spectral_norm_sq(p.A) + p.lam2
    A_t = to_tblock_major(p.A, 512 // 64)
    s_k = fista(p, L, init_state(p, None, cfg), cfg, None, A_t)
    s_ref = fista(p, L, init_state(p, None, cfg), cfg)
    assert float(s_k.best_rel_gap) <= 5e-6
    np.testing.assert_allclose(np.asarray(s_k.x_best),
                               np.asarray(s_ref.x_best), atol=5e-5)


def test_solve_fista_kernel_routing_end_to_end():
    """api.solve('fista') certifies at a size the fused sweep also
    serves."""
    from convex_optimization_tpu.api import solve

    inst = make_lasso_instance(jax.random.PRNGKey(9), 128, 1024)
    res = solve(inst.problem, "fista", tol=1e-5, max_iters=4000)
    assert res.converged, res.rel_gap
