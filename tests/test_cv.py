"""K-fold CV driver (solvers/cv.py): fold-mask correctness, equivalence of
the masked-row training problem with the true row-subset problem, and a
closed-loop model-selection check on a planted instance."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from convex_optimization_tpu import solve
from convex_optimization_tpu.core.datagen import make_lasso_instance
from convex_optimization_tpu.solvers.common import SolverConfig
from convex_optimization_tpu.solvers.cv import (
    CVResult,
    cv_lambda_path,
    kfold_train_masks,
)

KEY = jax.random.PRNGKey(33)


def test_kfold_masks_partition_and_determinism():
    m, k = 103, 5
    masks = kfold_train_masks(m, k, seed=7)
    assert masks.shape == (k, m) and masks.dtype == np.float32
    # every row is a validation row in EXACTLY one fold
    val_counts = (masks == 0.0).sum(axis=0)
    np.testing.assert_array_equal(val_counts, np.ones(m))
    # balanced to within 1
    sizes = (masks == 0.0).sum(axis=1)
    assert sizes.max() - sizes.min() <= 1
    np.testing.assert_array_equal(masks, kfold_train_masks(m, k, seed=7))
    assert not np.array_equal(masks, kfold_train_masks(m, k, seed=8))
    with pytest.raises(ValueError):
        kfold_train_masks(10, 1)


def test_masked_fold_equals_row_subset_problem():
    """Zeroing validation rows is EXACTLY the lasso on the training subset:
    same solution to solver tolerance."""
    inst = make_lasso_instance(KEY, 60, 200)
    p = inst.problem
    mask = kfold_train_masks(p.m, 3, seed=0)[0]
    tm = jnp.asarray(mask)
    p_masked = dataclasses.replace(p, A=p.A * tm[:, None], b=p.b * tm)
    rows = np.nonzero(mask)[0]
    p_subset = dataclasses.replace(p, A=p.A[jnp.asarray(rows)],
                                   b=p.b[jnp.asarray(rows)])
    r1 = solve(p_masked, "fista", tol=1e-7, max_iters=8000)
    r2 = solve(p_subset, "fista", tol=1e-7, max_iters=8000)
    np.testing.assert_allclose(np.asarray(r1.x), np.asarray(r2.x),
                               atol=5e-5)


def test_cv_selects_a_recovering_lambda():
    inst = make_lasso_instance(KEY, 120, 400, noise_std=0.02)
    cfg = SolverConfig(tol=1e-5, max_iters=4000)
    res = cv_lambda_path(inst.problem, cfg, k=4, path_len=8, seed=1)
    assert isinstance(res, CVResult)
    k, L = res.val_mse.shape
    assert (k, L) == (4, 8)
    assert np.all(np.isfinite(np.asarray(res.mean_mse)))
    # lambdas descend; the 1-SE choice is the sparser (larger) lambda
    assert res.one_se_index <= res.best_index
    assert res.one_se_lambda >= res.best_lambda
    # the selected lambda must beat the near-lam_max end (x ~ 0 there)
    assert float(res.mean_mse[res.best_index]) < float(res.mean_mse[0])
    # refit at the chosen lambda recovers most of the planted support
    sup = np.asarray(inst.support)
    xb = np.asarray(res.x)
    recall = ((xb != 0) & sup).sum() / sup.sum()
    assert recall >= 0.8, recall
    # refits correspond to path points of the full problem
    assert res.x.shape == (inst.problem.n,)
    assert res.x_one_se.shape == (inst.problem.n,)


def test_fold_lambda_scale():
    from convex_optimization_tpu.solvers.cv import fold_lambda_scale

    masks = kfold_train_masks(100, 5, seed=0)
    for f in range(5):
        s = fold_lambda_scale(masks[f])
        assert s == masks[f].sum() / 100.0
        assert 0.7 < s < 0.9  # ~ (k-1)/k = 0.8


def test_lambda_scales_with_row_count():
    """The rationale for the fold-λ scale (ADVICE r4): duplicating every
    row doubles the unnormalized data-fit, so the duplicated problem at
    2λ has the same solution as the original at λ.  A fold (fewer rows)
    therefore needs λ·(m_train/m) to match the full-data grid point."""
    inst = make_lasso_instance(KEY, 48, 160)
    p = inst.problem
    p2 = dataclasses.replace(
        p, A=jnp.concatenate([p.A, p.A]), b=jnp.concatenate([p.b, p.b]),
        penalty=p.penalty.with_lam1(2.0 * p.penalty.lam1))
    r1 = solve(p, "fista", tol=1e-7, max_iters=8000)
    r2 = solve(p2, "fista", tol=1e-7, max_iters=8000)
    np.testing.assert_allclose(np.asarray(r1.x), np.asarray(r2.x),
                               atol=5e-5)


def test_cv_kernel_route_matches_masked_copy_route():
    """The default kernel-routed CV (fold masks inside the batch kernels,
    zero full-size XLA programs) must reproduce the masked-copy route's
    validation curves and selection."""
    inst = make_lasso_instance(KEY, 96, 320, noise_std=0.05)
    cfg = SolverConfig(tol=1e-6, max_iters=6000, gap_every=10,
                       stall_checks=20)
    kern = cv_lambda_path(inst.problem, cfg, k=3, path_len=6, seed=4,
                          method="bcd_batch")
    copy = cv_lambda_path(inst.problem, cfg, k=3, path_len=6, seed=4,
                          method="bcd")
    assert kern.method_used == "bcd_batch"
    # a certificate pins the objective, not x: two certified solvers can
    # sit ~1e-3 apart in x, which moves a held-out MSE by ~1e-3 absolute
    np.testing.assert_allclose(np.asarray(kern.val_mse),
                               np.asarray(copy.val_mse),
                               rtol=1e-3, atol=2e-3)
    assert kern.best_index == copy.best_index
    assert kern.one_se_index == copy.one_se_index


def test_cv_kernel_route_gate_fallback_warns():
    """m % 8 != 0 fails the kernel gate: CV must warn and record the
    masked-copy substitution."""
    inst = make_lasso_instance(KEY, 61, 128)
    cfg = SolverConfig(tol=1e-4, max_iters=1500)
    with pytest.warns(UserWarning, match="bcd_batch gate failed"):
        res = cv_lambda_path(inst.problem, cfg, k=3, path_len=4)
    assert res.method_used == "bcd_pallas+masked_copy"
    assert res.val_mse.shape == (3, 4)
    assert np.all(np.isfinite(np.asarray(res.mean_mse)))


def test_cv_kernel_route_traces_no_full_size_A_program():
    """NaN-A audit (the working-set audit pattern, solvers/working_set.py):
    after the one-time A_t hoist, replace problem.A with NaN — fold paths
    and the kernel-routed validation score must stay finite, proving that
    no program in the kernel-routed CV beyond the hoist ever traces the
    full-size A (VERDICT r4 Next #2's program audit)."""
    from convex_optimization_tpu.solvers.batched_path import (
        batched_lambda_path,
        prepare_batched_solver,
    )
    from convex_optimization_tpu.solvers.cv import _val_mse_kernel

    inst = make_lasso_instance(KEY, 64, 256)
    p = inst.problem
    cfg = SolverConfig(tol=1e-5, max_iters=2000, gap_every=10,
                       stall_checks=15)
    prep = prepare_batched_solver(p, cfg)
    assert prep.reason is None
    rm = jnp.asarray(kfold_train_masks(p.m, 3, seed=0)[0])
    lmax = float(jnp.max(jnp.abs(p.A.T @ (p.b * rm))))
    grid = jnp.geomspace(0.8 * lmax, 0.1 * lmax, 4)

    p_nan = dataclasses.replace(
        p, A=jnp.full(p.A.shape, jnp.nan, p.dtype))
    pr = batched_lambda_path(p_nan, cfg, lambdas=grid, row_mask=rm,
                             prepared=prep)
    assert pr.method_used == "bcd_batch"
    assert np.all(np.isfinite(np.asarray(pr.xs)))
    Xc = pr.xs.reshape(4, prep.n_blocks, prep.B).transpose(1, 0, 2)
    v = _val_mse_kernel(prep.A_t, Xc, p.b, 1.0 - rm)
    assert np.all(np.isfinite(np.asarray(v)))


def test_cv_no_refit_and_explicit_grid():
    inst = make_lasso_instance(KEY, 64, 128)
    cfg = SolverConfig(tol=1e-4, max_iters=1500)
    grid = jnp.geomspace(0.5, 0.01, 5) * float(
        jnp.max(jnp.abs(inst.problem.A.T @ inst.problem.b)))
    res = cv_lambda_path(inst.problem, cfg, k=3, lambdas=grid, refit=False)
    assert res.x is None and res.x_one_se is None
    assert res.val_mse.shape == (3, 5)
    np.testing.assert_allclose(np.asarray(res.lambdas), np.asarray(grid))


def test_lambda_max_t_matches_xla_dot():
    """λ_max on A_t (one witness product) == lambda_max on A for all three
    penalty families — the CV grid needs no A once A_t is hoisted."""
    from convex_optimization_tpu.core.objective import lambda_max, lambda_max_t
    from convex_optimization_tpu.ops.matvec import to_tblock_major

    for kind, ngroups in [("l1", 0), ("nonneg_l1", 0), ("group_l2", 16)]:
        inst = make_lasso_instance(jax.random.PRNGKey(3), 64, 256,
                                   penalty_kind=kind, ngroups=ngroups)
        p = inst.problem
        A_t = to_tblock_major(p.A, 256 // 32)
        ref = float(lambda_max(p.A, p.b, p.penalty))
        got = float(lambda_max_t(A_t, p.b, p.penalty))
        np.testing.assert_allclose(got, ref, rtol=2e-6)


def test_cv_free_A_deletes_device_buffer_and_matches():
    """free_A=True must (a) produce the same CV selection as free_A=False
    and (b) actually delete problem.A's device buffer (later reads raise)."""
    inst = make_lasso_instance(KEY, 64, 256)
    cfg = SolverConfig(tol=1e-5, max_iters=2000, gap_every=10,
                       stall_checks=15)
    ref = cv_lambda_path(inst.problem, cfg, k=3, path_len=4)

    inst2 = make_lasso_instance(KEY, 64, 256)
    res = cv_lambda_path(inst2.problem, cfg, k=3, path_len=4, free_A=True)
    assert res.method_used == "bcd_batch"
    np.testing.assert_allclose(np.asarray(res.mean_mse),
                               np.asarray(ref.mean_mse), rtol=1e-6)
    assert res.best_index == ref.best_index
    with pytest.raises(RuntimeError):
        _ = np.asarray(inst2.problem.A) + 0.0
