"""f64 polish phase: certified 1e-6 from an f32 plateau (SURVEY.md 7.4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from convex_optimization_tpu.api import solve
from convex_optimization_tpu.core.datagen import make_lasso_instance
from convex_optimization_tpu.core.objective import duality_gap
from convex_optimization_tpu.solvers.polish import polish


@pytest.mark.parametrize("kind,ngroups,lam2", [
    ("l1", 0, 0.0),
    ("nonneg_l1", 0, 1e-2),
    ("group_l2", 16, 0.0),
])
def test_polish_certifies_below_f32_floor(kind, ngroups, lam2):
    inst = make_lasso_instance(jax.random.PRNGKey(1), 96, 256,
                               penalty_kind=kind, ngroups=ngroups, lam2=lam2)
    # stop the f32 solve early (a coarse point, like an f32 plateau)
    res = solve(inst.problem, "fista", tol=1e-4, max_iters=3000)
    pr = polish(inst.problem, res.x, tol=1e-8)
    assert pr.rel_gap <= 1e-8, pr.rel_gap
    assert pr.kept <= inst.problem.n
    # independent f64 re-certification of the scattered-back full vector
    import dataclasses

    p64 = dataclasses.replace(
        inst.problem,
        A=inst.problem.A.astype(jnp.float64),
        b=inst.problem.b.astype(jnp.float64),
    )
    info = duality_gap(p64, jnp.asarray(pr.x))
    assert float(info.rel_gap) <= 2e-8


def test_polish_agrees_with_direct_f64_solve():
    inst = make_lasso_instance(jax.random.PRNGKey(2), 64, 192)
    res = solve(inst.problem, "fista", tol=1e-5, max_iters=3000)
    pr = polish(inst.problem, res.x, tol=1e-10)

    import dataclasses

    p64 = dataclasses.replace(
        inst.problem,
        A=inst.problem.A.astype(jnp.float64),
        b=inst.problem.b.astype(jnp.float64),
    )
    ref = solve(p64, "fista", tol=1e-10, max_iters=20000)
    np.testing.assert_allclose(pr.x, np.asarray(ref.x), atol=1e-7)


@pytest.mark.parametrize("kind,ngroups,lam2", [
    ("l1", 0, 0.0),
    ("nonneg_l1", 0, 1e-2),
    ("group_l2", 16, 0.0),
])
def test_polish_fast_matches_full_certificate(kind, ngroups, lam2):
    """polish_fast (screening-extended certificate, zero full passes) must
    agree with polish (explicit full-problem f64 certificate)."""
    from convex_optimization_tpu.solvers.polish import polish_fast

    inst = make_lasso_instance(jax.random.PRNGKey(8), 96, 256,
                               penalty_kind=kind, ngroups=ngroups, lam2=lam2)
    res = solve(inst.problem, "fista", tol=1e-4, max_iters=3000)
    fast = polish_fast(inst.problem, res.x, tol=1e-8)
    full = polish(inst.problem, res.x, tol=1e-8)
    assert fast.rel_gap <= 1e-8
    # both 1e-8-certified; their internal f64 solves may stop at different
    # checks (optimal-alpha monitor), so compare within the certified ball
    np.testing.assert_allclose(fast.x, full.x, atol=2e-5)
    # the extension theorem's claim: the fast result's FULL-problem f64
    # certificate (recomputed explicitly) really is below tol
    import dataclasses

    p64 = dataclasses.replace(
        inst.problem,
        A=inst.problem.A.astype(jnp.float64),
        b=inst.problem.b.astype(jnp.float64),
    )
    info = duality_gap(p64, jnp.asarray(fast.x))
    assert float(info.rel_gap) <= 2e-8, float(info.rel_gap)


def test_polish_fast_keeps_superset_of_support():
    from convex_optimization_tpu.solvers.polish import polish_fast

    inst = make_lasso_instance(jax.random.PRNGKey(9), 128, 512)
    res = solve(inst.problem, "fista", tol=1e-4, max_iters=3000)
    fast = polish_fast(inst.problem, res.x, tol=1e-9)
    support = np.asarray(fast.x) != 0
    assert fast.kept >= support.sum()
    assert fast.rel_gap <= 1e-9


@pytest.mark.parametrize("kind,lam2", [("l1", 0.0), ("nonneg_l1", 1e-2)])
def test_polish_support_certifies(kind, lam2):
    from convex_optimization_tpu.solvers.polish import polish_support

    inst = make_lasso_instance(jax.random.PRNGKey(12), 96, 512,
                               penalty_kind=kind, lam2=lam2)
    res = solve(inst.problem, "fista", tol=1e-4, max_iters=3000)
    ps = polish_support(inst.problem, res.x, tol=1e-8)
    assert ps.rel_gap <= 1e-8, ps.rel_gap
    # independent full f64 certificate
    import dataclasses

    p64 = dataclasses.replace(
        inst.problem,
        A=inst.problem.A.astype(jnp.float64),
        b=inst.problem.b.astype(jnp.float64),
    )
    info = duality_gap(p64, jnp.asarray(ps.x))
    assert float(info.rel_gap) <= 2e-8, float(info.rel_gap)
    # agrees with the belt-and-braces oracle
    full = polish(inst.problem, res.x, tol=1e-8)
    np.testing.assert_allclose(ps.x, full.x, atol=1e-6)


def test_polish_support_expands_from_truncated_start():
    """Start from a deliberately TRUNCATED support (half the nonzeros
    zeroed): the expansion loop must recover the rest and still certify."""
    from convex_optimization_tpu.solvers.polish import polish_support

    inst = make_lasso_instance(jax.random.PRNGKey(13), 96, 384)
    res = solve(inst.problem, "fista", tol=1e-5, max_iters=4000)
    x = np.asarray(res.x).copy()
    nz = np.nonzero(x)[0]
    x[nz[::2]] = 0.0          # drop half the support
    ps = polish_support(inst.problem, jnp.asarray(x), tol=1e-8)
    assert ps.rel_gap <= 1e-8, ps.rel_gap


def test_polish_support_group_variant():
    """group_l2 routes to the group-wise support restriction (round 2:
    gap-safe group screening keeps everything at f32 gaps, so the
    fallback-to-polish_fast path was replaced)."""
    from convex_optimization_tpu.solvers.polish import polish_support

    inst = make_lasso_instance(jax.random.PRNGKey(14), 64, 256,
                               penalty_kind="group_l2", ngroups=16)
    res = solve(inst.problem, "fista", tol=1e-4, max_iters=3000)
    ps = polish_support(inst.problem, res.x, tol=1e-8)
    assert ps.rel_gap <= 1e-8
    assert ps.kept < inst.problem.n      # really restricted
    # independent f64 certificate of the scattered-back vector
    import dataclasses

    p64 = dataclasses.replace(
        inst.problem,
        A=inst.problem.A.astype(jnp.float64),
        b=inst.problem.b.astype(jnp.float64),
    )
    info = duality_gap(p64, jnp.asarray(ps.x))
    assert float(info.rel_gap) <= 2e-8, float(info.rel_gap)


@pytest.mark.parametrize("kind,ngroups", [("l1", 0), ("group_l2", 16)])
def test_polish_fast_host_path(kind, ngroups):
    """polish_fast with A_host: the chunked-f64 host screen (zero device
    programs) must produce the same sound certificate as the device path."""
    from convex_optimization_tpu.core.datagen import make_lasso_instance_host
    from convex_optimization_tpu.solvers.polish import polish_fast

    inst, A_np, b_np = make_lasso_instance_host(
        5, 96, 256, penalty_kind=kind, ngroups=ngroups)
    res = solve(inst.problem, "fista", tol=1e-4, max_iters=3000)
    fast = polish_fast(inst.problem, res.x, tol=1e-8,
                       A_host=A_np, b_host=b_np)
    assert fast.rel_gap <= 1e-8
    import dataclasses

    p64 = dataclasses.replace(
        inst.problem,
        A=inst.problem.A.astype(jnp.float64),
        b=inst.problem.b.astype(jnp.float64),
    )
    info = duality_gap(p64, jnp.asarray(fast.x))
    assert float(info.rel_gap) <= 2e-8, float(info.rel_gap)


def test_cd64_group_direct_with_compaction():
    """_cd64_group (round-3 group shooting solver): converges from a cold
    start on a slab with many provably-inactive groups, compacts them out
    mid-solve (rescreen), and its certificate matches an independent f64
    recomputation on the full slab."""
    import numpy as np

    from convex_optimization_tpu.solvers.polish import (
        _NpPenalty,
        _cd64_group,
        _gap_from_parts,
        _gemv_t_mixed,
        _residual_sparse32,
    )

    rng = np.random.default_rng(3)
    m, ng, gsize = 96, 24, 8
    width = ng * gsize
    As = rng.standard_normal((m, width)).astype(np.float32)
    As /= np.sqrt(m)
    # planted signal in 3 groups only -> most groups screen out
    x_true = np.zeros(width)
    for g in (2, 11, 19):
        x_true[g * gsize:(g + 1) * gsize] = rng.standard_normal(gsize)
    b = (As.astype(np.float64) @ x_true
         + 0.01 * rng.standard_normal(m))
    pen = _NpPenalty("group_l2", 0.05, ng, None, width)
    xs0 = np.zeros(width)
    xs, keep_idx, sweeps, rel, gap, primal, r = _cd64_group(
        As, b, 0.0, pen, xs0, tol=1e-10, max_sweeps=500, gap_every=2)
    assert rel <= 1e-10, rel
    assert len(keep_idx) < width            # compaction really happened
    assert len(keep_idx) % gsize == 0       # whole groups only
    # independent recomputation on the FULL slab
    x_full = np.zeros(width)
    x_full[keep_idx] = xs
    r_chk = _residual_sparse32(As, x_full, b)
    z_chk = _gemv_t_mixed(As, r_chk)
    gap2, primal2, rel2, _ = _gap_from_parts(r_chk, b, 0.0, pen,
                                             x_full, z_chk)
    assert rel2 <= 1e-10, rel2
    np.testing.assert_allclose(r, r_chk, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("kind,lam2", [("l1", 0.0), ("l1", 1e-2),
                                       ("nonneg_l1", 0.0),
                                       ("nonneg_l1", 1e-2)])
def test_cd64_native_matches_python_path(monkeypatch, kind, lam2):
    """The native C sweep (GIL-released) must produce the same certified
    result as the pure-NumPy loop — across the soft-threshold/nonneg prox
    branches and the lam2 gradient term."""
    import numpy as np

    from convex_optimization_tpu.solvers.polish import _NpPenalty, _cd64
    from convex_optimization_tpu.utils import native as co_native

    rng = np.random.default_rng(7)
    m, w = 200, 160
    As = np.asfortranarray(
        (rng.standard_normal((m, w)) / np.sqrt(m)).astype(np.float32))
    assert As.dtype == np.float32       # NEP-50: f32/np-scalar upcasts!
    x_true = np.zeros(w)
    sel = rng.choice(w, 12, replace=False)
    x_true[sel] = np.abs(rng.standard_normal(12))   # nonneg-feasible truth
    b = As.astype(np.float64) @ x_true + 0.01 * rng.standard_normal(m)
    pen = _NpPenalty(kind, 0.03, 0, None, w)

    out_native = _cd64(As.copy(order="F"), b, lam2, pen, np.zeros(w),
                       tol=1e-10, max_sweeps=400)
    # force the NumPy loop
    monkeypatch.setattr(co_native, "cd64_sweeps",
                        lambda *a, **k: False)
    out_python = _cd64(As.copy(order="F"), b, lam2, pen, np.zeros(w),
                       tol=1e-10, max_sweeps=400)
    assert out_native[3] <= 1e-10 and out_python[3] <= 1e-10
    xn = np.zeros(w); xn[out_native[1]] = out_native[0]
    xp = np.zeros(w); xp[out_python[1]] = out_python[0]
    np.testing.assert_allclose(xn, xp, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("lam2", [0.0, 1e-2])
def test_cd64_group_native_matches_python_path(monkeypatch, lam2):
    """Native group CD sweep == NumPy group CD sweep (same update
    arithmetic, different reduction order only), incl. the lam2 term."""
    import numpy as np

    from convex_optimization_tpu.solvers.polish import _NpPenalty, _cd64_group
    from convex_optimization_tpu.utils import native as co_native

    rng = np.random.default_rng(11)
    m, ng, gsize = 128, 20, 8
    width = ng * gsize
    As = np.asfortranarray(
        (rng.standard_normal((m, width)) / np.sqrt(m)).astype(np.float32))
    assert As.dtype == np.float32       # NEP-50: f32/np-scalar upcasts!
    x_true = np.zeros(width)
    for g in (3, 9):
        x_true[g * gsize:(g + 1) * gsize] = rng.standard_normal(gsize)
    b = As.astype(np.float64) @ x_true + 0.01 * rng.standard_normal(m)
    pen = _NpPenalty("group_l2", 0.04, ng, None, width)

    # native L vs python L agree (f64-vs-f32 iteration rounding only)
    L_nat = co_native.group_power_l(As, gsize, iters=8, safety=1.02,
                                    lam2=lam2)
    assert L_nat is not None and L_nat.shape == (ng,)
    # pin L to the python fallback for BOTH runs so the sweep arithmetic
    # is isolated (L only affects step sizes)
    monkeypatch.setattr(co_native, "group_power_l", lambda *a, **k: None)
    nat = _cd64_group(As.copy(order="F"), b, lam2, pen, np.zeros(width),
                      tol=1e-10, max_sweeps=400)
    monkeypatch.setattr(co_native, "cd64_group_sweeps",
                        lambda *a, **k: False)
    py = _cd64_group(As.copy(order="F"), b, lam2, pen, np.zeros(width),
                     tol=1e-10, max_sweeps=400)
    assert nat[3] <= 1e-10 and py[3] <= 1e-10
    xn = np.zeros(width); xn[nat[1]] = nat[0]
    xp = np.zeros(width); xp[py[1]] = py[0]
    np.testing.assert_allclose(xn, xp, rtol=1e-9, atol=1e-12)


def test_native_atr_and_ax_sparse_parity():
    """co_atr_mixed (incl. lam2 term) and co_ax_sparse match the NumPy
    formulas exactly-to-rounding."""
    import numpy as np

    from convex_optimization_tpu.utils import native as co_native

    rng = np.random.default_rng(21)
    m, w = 160, 96
    As = np.asfortranarray(
        (rng.standard_normal((m, w)) / np.sqrt(m)).astype(np.float32))
    r = rng.standard_normal(m)
    xs = np.zeros(w)
    xs[rng.choice(w, 9, replace=False)] = rng.standard_normal(9)
    b = rng.standard_normal(m)

    z = co_native.atr_mixed(As, r, 0.37, xs)
    assert z is not None
    z_ref = -(As.astype(np.float64).T @ r) - 0.37 * xs
    np.testing.assert_allclose(z, z_ref, rtol=1e-13, atol=1e-14)
    # lam2=0 / xs=None branch
    z0 = co_native.atr_mixed(As, r, 0.0, None)
    np.testing.assert_allclose(z0, -(As.astype(np.float64).T @ r),
                               rtol=1e-13, atol=1e-14)

    rr = co_native.ax_sparse(As, xs, b)
    assert rr is not None
    np.testing.assert_allclose(rr, As.astype(np.float64) @ xs - b,
                               rtol=1e-13, atol=1e-13)


def test_native_gather_cols_bounds_check():
    """Out-of-range indices must raise IndexError (not read garbage)."""
    import numpy as np
    import pytest as _pytest

    from convex_optimization_tpu.utils import native as co_native

    As = np.asfortranarray(np.ones((8, 4), np.float32))
    if not co_native.have_native():
        _pytest.skip("no native toolchain")
    with _pytest.raises(IndexError):
        co_native.gather_cols(As, np.array([0, 4]), np.float32)
    with _pytest.raises(IndexError):
        co_native.gather_cols(As, np.array([-1]), np.float64)
