"""Smoke test of the certified lasso path on an NVIDIA GPU.

Run from the repository root on a machine with the card:

    python chip_smoke.py               # every one-card phase
    python chip_smoke.py --four-cards  # only the four-card sharded phase

Everything runs in this one process.  Each phase prints its checks, each
measured number beside its limit; any failed check ends the run with a
non-zero exit code.  The last line of a passing run is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a GPU, or without the rest of the repository beside this file, the
script exits non-zero and prints no such line.

One-card phases:

  parity    the fused sweep kernel against the plain sweep run in float64
            on the card, at m = 10,000 with 64 blocks of the width the route
            picks: l1, nonneg_l1 and weighted group_l2, with a keep mask and
            step_scale < 1, for L = 1 and L = 16 with and without a row mask;
            the plain refresh, witness and block power iteration against
            float64 products;
  timing    one sweep of each route at 10,000 x 100,000 (ms and GB/s);
  headline  the 10,000 x 100,000 lasso solved by ``solve(method=
            "bcd_pallas")`` and certified in float64 to 1e-6, as bench.py
            does;
  path_cv   config 2's shape (5,000 x 50,000): a 10-point ``bcd_batch``
            lambda path, then 5-fold CV, both on the batched kernel.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import warnings

REPO = os.path.dirname(os.path.abspath(__file__))
ONE_CARD_PHASES = ("parity", "timing", "headline", "path_cv")
FOUR_CARDS = "four_cards"


class CheckFailed(RuntimeError):
    pass


def result_line(kind: str, count: int) -> str:
    """The last line of a passing run."""
    return json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": kind, "count": count}})


def phases_for(four_cards: bool) -> tuple:
    """Phases one invocation runs: the four-card phase alone, or every
    one-card phase."""
    return (FOUR_CARDS,) if four_cards else ONE_CARD_PHASES


def check(name: str, value: float, limit: float) -> None:
    """Print ``value`` beside ``limit``; fail when it exceeds it."""
    ok = value <= limit
    print(f"  {'ok  ' if ok else 'FAIL'} {name}: {value:.3e} "
          f"(limit {limit:.1e})", flush=True)
    if not ok:
        raise CheckFailed(f"{name}: {value:.3e} > {limit:.1e}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


# ------------------------------------------------------------------ parity

def _rel(a, b) -> float:
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def phase_parity() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from convex_optimization_tpu.ops import route
    from convex_optimization_tpu.ops.bcd_sweep import batch_sweep, batch_sweep_ref
    from convex_optimization_tpu.ops.matvec import (
        ax_minus_b_batch_t, ax_minus_b_t, block_power_t, neg_at_r_batch_t,
        neg_at_r_t, to_tblock_major)

    m, nb = 10_000, 64
    B = route.pick_block_size(m, 100_000)[0]
    n = nb * B
    gsize = 16 if B % 16 == 0 else 8
    print(f"parity: m={m} B={B} blocks={nb} route="
          f"{route.sweep_route(jnp.float32)}", flush=True)
    rng = np.random.default_rng(0)
    A = rng.standard_normal((m, n)).astype(np.float32)
    A /= np.linalg.norm(A, axis=0, keepdims=True)
    A_t = to_tblock_major(jnp.asarray(A), nb)
    A_t64 = A_t.astype(jnp.float64)
    steps = (1.0 / block_power_t(A_t)).astype(jnp.float32)
    b = jnp.asarray(A[:, :: 20].sum(axis=1)
                    + 0.01 * rng.standard_normal(m), jnp.float32)
    lam_max = float(jnp.max(jnp.abs(-neg_at_r_t(A_t, b, jnp.zeros(n), 0.0))))
    weights = jnp.asarray(rng.uniform(0.5, 1.5, nb * B // gsize), jnp.float32)
    keep = jnp.asarray(rng.random(nb * B) > 0.2, jnp.float32)
    row_mask = jnp.asarray(rng.random(m) > 0.2, jnp.float32)

    # f32 sums in another order than the float64 reference: every CTA
    # reduces its own rows, the CTAs' partial block gradients meet in
    # atomics in run-dependent order, and 64 blocks of residual updates
    # accumulate on top; 1e-4 of the largest entry bounds that with room
    # (a wrong index or a missed update shows as O(1))
    tol = 1e-4
    cases = [
        ("l1", 1, False, 1.0, False),
        ("l1", 1, True, 0.5, False),
        ("nonneg_l1", 1, False, 1.0, False),
        ("group_l2", 1, True, 0.7, False),
        ("l1", 16, False, 1.0, False),
        ("l1", 16, True, 0.5, True),
        ("group_l2", 16, False, 1.0, True),
        ("nonneg_l1", 16, True, 1.0, True),
    ]
    for kind, L, masked, step_scale, rowmasked in cases:
        lam1s = jnp.asarray(np.geomspace(0.5, 0.05, L) * lam_max,
                            jnp.float32)
        X = jnp.asarray(0.01 * rng.standard_normal((nb, L, B)), jnp.float32)
        if kind == "nonneg_l1":
            X = jnp.abs(X)
        rm = row_mask if rowmasked else None
        R = ax_minus_b_batch_t(A_t, X, b)
        if rm is not None:
            R = rm[None, :] * R
        kw = dict(kind=kind, gsize=gsize if kind == "group_l2" else 1,
                  weights=weights if kind == "group_l2" else None,
                  mask=keep if masked else None, row_mask=rm)
        st = steps * step_scale
        Xk, Rk = jax.jit(lambda *a: batch_sweep(*a, **kw))(
            A_t, X, R, st, lam1s, 0.0)
        as64 = lambda v: None if v is None else jnp.asarray(v, jnp.float64)
        Xr, Rr = jax.jit(lambda *a: batch_sweep_ref(
            *a, kind=kw["kind"], gsize=kw["gsize"],
            weights=as64(kw["weights"]), mask=as64(kw["mask"]),
            row_mask=as64(rm)))(
            A_t64, X.astype(jnp.float64), R.astype(jnp.float64),
            st.astype(jnp.float64), lam1s.astype(jnp.float64), 0.0)
        tag = (f"{kind} L={L} keep_mask={masked} step_scale={step_scale} "
               f"row_mask={rowmasked}")
        check(f"sweep {tag} x", _rel(Xk, Xr), tol)
        check(f"sweep {tag} r", _rel(Rk, Rr), tol)

    # the plain products: float32 at HIGHEST against float64
    x = jnp.asarray(rng.standard_normal(n) * (rng.random(n) < 0.05),
                    jnp.float32)
    r64 = A_t64.reshape(n, m).T @ x.astype(jnp.float64) - b
    check("refresh A x - b", _rel(ax_minus_b_t(A_t, x, b), r64), 1e-5)
    z64 = -(A_t64.reshape(n, m) @ r64) - 0.1 * x
    check("witness -A^T r - lam2 x",
          _rel(neg_at_r_t(A_t, r64.astype(jnp.float32), x, 0.1), z64), 1e-5)
    X = jnp.asarray(rng.standard_normal((nb, 16, B)), jnp.float32)
    R64 = jnp.einsum("jlb,jbm->lm", X.astype(jnp.float64), A_t64) - b
    check("batched refresh", _rel(ax_minus_b_batch_t(A_t, X, b), R64), 1e-5)
    Z64 = -jnp.einsum("jbm,lm->jlb", A_t64, R64)
    check("batched witness",
          _rel(neg_at_r_batch_t(A_t, R64.astype(jnp.float32), X, 0.0), Z64),
          1e-5)
    # the same power iteration in both precisions: they part only by
    # rounding, amplified a little by 48 normalisations
    check("block power iteration",
          _rel(block_power_t(A_t), block_power_t(A_t64)), 1e-4)


# ------------------------------------------------------------------ timing

def _time_sweeps(fn, A_t, state, reps: int) -> float:
    """Seconds per call of ``fn(A_t, *state) -> state``, after one warm-up
    call, over ``reps`` chained calls ended by block_until_ready."""
    import jax

    state = jax.block_until_ready(fn(A_t, *state))   # compile + warm
    t0 = time.perf_counter()
    for _ in range(reps):
        state = fn(A_t, *state)
    jax.block_until_ready(state)
    return (time.perf_counter() - t0) / reps


def phase_timing(m: int = 10_000, n: int = 100_000) -> None:
    import jax
    import jax.numpy as jnp

    from convex_optimization_tpu.ops import route
    from convex_optimization_tpu.ops.bcd_sweep import batch_sweep
    from convex_optimization_tpu.ops.matvec import block_power_t

    B, _ = route.pick_block_size(m, n)
    nb = n // B
    k = jax.random.split(jax.random.PRNGKey(1), 2)
    A_t = jax.random.normal(k[0], (nb, B, m), jnp.float32) / jnp.sqrt(m)
    b = jax.random.normal(k[1], (m,), jnp.float32)
    steps = (1.0 / block_power_t(A_t, iters=8)).astype(jnp.float32)
    gb = m * n * 4 / 1e9
    print(f"timing: {m}x{n} B={B} blocks={nb} A={gb:.2f} GB", flush=True)

    def time_route(rt, A_t, steps, L, reps):
        nb_, B_, _ = A_t.shape
        lam1s = jnp.full((L,), 0.05, jnp.float32)
        X = jnp.zeros((nb_, L, B_), jnp.float32)
        R = jnp.broadcast_to(-b, (L, m))
        # A_t is an argument: closed over, it would be baked into the
        # executable as a 4 GB constant
        fn = jax.jit(lambda A_t, X, R: batch_sweep(
            A_t, X, R, steps, lam1s, 0.0, kind="l1", route=rt))
        t = _time_sweeps(fn, A_t, (X, R), reps)
        print(f"  sweep route={rt} B={B_} L={L}: {1e3 * t:.3f} ms/sweep "
              f"{gb / t:.1f} GB/s", flush=True)

    # the kernel against the plain route at the route's block width
    for L in (1, 16):
        for rt, reps in ((route.CUDA, 20), (route.XLA, 5)):
            time_route(rt, A_t, steps, L, reps)
    # the kernel's cost against the batch width (MAX_BATCH) and against the
    # block width: one grid barrier per block, so fewer, wider blocks
    for L in (4, 8):
        time_route(route.CUDA, A_t, steps, L, 20)
    rows = A_t.reshape(n, m)
    for B2 in (40, 160, 200):
        A2 = rows.reshape(n // B2, B2, m)
        steps2 = (1.0 / block_power_t(A2, iters=8)).astype(jnp.float32)
        time_route(route.CUDA, A2, steps2, 1, 20)


# ---------------------------------------------------------------- headline

def phase_headline(m: int = 10_000, n: int = 100_000) -> None:
    import convex_optimization_tpu as co
    from convex_optimization_tpu.core.datagen import make_lasso_instance_host
    from convex_optimization_tpu.core.objective import duality_gap
    from convex_optimization_tpu.solvers.polish import polish_support

    tol = 1e-6
    t0 = time.perf_counter()
    inst, A_np, b_np = make_lasso_instance_host(42, m, n)
    print(f"headline: {m}x{n} datagen+upload "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    res = co.solve(inst.problem, method="bcd_pallas", tol=tol,
                   max_iters=20_000, gap_every=10, stall_checks=15,
                   block_size=128)
    pr = polish_support(inst.problem, res.x, tol=tol, A_host=A_np,
                        b_host=b_np)
    if res.method != "bcd_pallas":
        raise CheckFailed(f"solve ran {res.method}, not bcd_pallas")
    print(f"  solve: sweeps={res.iterations} wall={res.wall_time_s:.3f} s "
          f"compile={res.compile_time_s:.3f} s f32 rel_gap="
          f"{res.rel_gap:.3e} | polish: wall={pr.wall_time_s:.3f} s "
          f"kept={pr.kept}", flush=True)
    check("polish certificate rel_gap", pr.rel_gap, tol)
    # independent float64 gap at the returned point, on the card
    gap = duality_gap(inst.problem, pr.x, precise=True)
    check("float64 rel_gap at x", float(gap.rel_gap), tol)


# ----------------------------------------------------------------- path_cv

def _no_fallback(caught) -> None:
    fell = [str(w.message) for w in caught if "gate failed" in str(w.message)]
    if fell:
        raise CheckFailed(f"batched route fell back: {fell[0]}")


def phase_path_cv(m: int = 5_000, n: int = 50_000) -> None:
    import numpy as np

    from convex_optimization_tpu.core.datagen import make_lasso_instance_host
    from convex_optimization_tpu.solvers.common import SolverConfig
    from convex_optimization_tpu.solvers.cv import cv_lambda_path
    from convex_optimization_tpu.solvers.lambda_path import lambda_path

    inst, A_np, b_np = make_lasso_instance_host(2, m, n)
    cfg = SolverConfig(tol=1e-6, max_iters=20_000, gap_every=10,
                       stall_checks=20)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        pr = lambda_path(inst.problem, cfg, path_len=10, method="bcd_batch")
        gaps = np.asarray(pr.gaps)
        wall = time.perf_counter() - t0
    _no_fallback(caught)
    print(f"path_cv: {m}x{n} lambda path method_used={pr.method_used} "
          f"wall={wall:.3f} s sweeps={np.asarray(pr.iters).tolist()}",
          flush=True)
    if pr.method_used != "bcd_batch":
        raise CheckFailed(f"lambda path ran {pr.method_used}")
    # per-point f32 certificates; the deep, dense end of the path stops at
    # the f32 noise floor (stall detection), between 1e-6 and ~1e-4
    check("path max f32 rel_gap", float(gaps.max()), 1e-3)
    # an independent solve at one path point: two certified points differ
    # in objective by at most the larger of their two gaps
    k = len(gaps) // 2
    import convex_optimization_tpu as co

    ref = co.solve(inst.problem.with_lam1(pr.lambdas[k]), "fista", tol=1e-6,
                   max_iters=20_000, stall_checks=15)
    lam = float(pr.lambdas[k])

    def objective(x):
        x = np.asarray(x, np.float64)
        r = A_np.astype(np.float64) @ x - b_np
        return 0.5 * r @ r + lam * np.abs(x).sum()

    p_path, p_ref = objective(pr.xs[k]), objective(ref.x)
    check(f"path point {k} objective vs FISTA",
          abs(p_path - p_ref) / p_ref,
          max(float(gaps[k]), ref.rel_gap) + 1e-6)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        cv = cv_lambda_path(inst.problem, cfg, k=5, path_len=10)
        mse = np.asarray(cv.mean_mse)
        wall = time.perf_counter() - t0
    _no_fallback(caught)
    print(f"  5-fold CV method_used={cv.method_used} wall={wall:.3f} s "
          f"best_lambda={cv.best_lambda:.4g} one_se={cv.one_se_lambda:.4g}",
          flush=True)
    if cv.method_used != "bcd_batch":
        raise CheckFailed(f"CV ran {cv.method_used}")
    if cv.val_mse.shape != (5, 10) or not np.all(np.isfinite(mse)):
        raise CheckFailed(f"CV validation curves: shape {cv.val_mse.shape}, "
                          f"finite={np.all(np.isfinite(mse))}")


# -------------------------------------------------------------- four cards

def phase_four_cards(m: int = 20_000, n: int = 200_000,
                     ngroups: int = 1_000) -> None:
    import jax
    import numpy as np

    import convex_optimization_tpu as co
    from convex_optimization_tpu.core.datagen import make_lasso_instance_host
    from convex_optimization_tpu.parallel.mesh import make_mesh
    from convex_optimization_tpu.solvers.polish import polish_support

    if len(jax.devices()) < 4:
        raise CheckFailed(f"--four-cards needs 4 devices, found "
                          f"{len(jax.devices())}")
    tol = 1e-6
    t0 = time.perf_counter()
    inst, A_np, b_np = make_lasso_instance_host(
        4, m, n, penalty_kind="group_l2", ngroups=ngroups)
    print(f"four_cards: {m}x{n} group_l2 ngroups={ngroups} datagen "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    kw = dict(tol=tol, max_iters=20_000, gap_every=10, stall_checks=15)
    runs = {
        "one card bcd_pallas": lambda: co.solve(inst.problem, "bcd_pallas",
                                                **kw),
        "4 cards bcd psum": lambda: co.solve(
            inst.problem, "bcd", mesh=make_mesh(4), use_pallas=True, **kw),
        "4 cards bcd ring": lambda: co.solve(
            inst.problem, "bcd", mesh=make_mesh(4), use_pallas=True,
            consensus="ring", **kw),
    }
    xs = {}
    for name, run in runs.items():
        res = run()
        pr = polish_support(inst.problem, res.x, tol=tol, A_host=A_np,
                            b_host=b_np)
        print(f"  {name}: method={res.method} sweeps={res.iterations} "
              f"wall={res.wall_time_s:.3f} s compile="
              f"{res.compile_time_s:.3f} s f32 rel_gap={res.rel_gap:.3e} "
              f"polish wall={pr.wall_time_s:.3f} s", flush=True)
        check(f"{name} float64 certificate", pr.rel_gap, tol)
        xs[name] = np.asarray(pr.x)
    ref = xs["one card bcd_pallas"]
    # two 1e-6-certified points agree in objective, not exactly in x; 1e-3
    # of the largest coefficient is what such pairs show at smaller sizes
    for name, x in xs.items():
        if name != "one card bcd_pallas":
            check(f"{name} x vs one card", _rel(x, ref), 1e-3)


PHASES = {"parity": phase_parity, "timing": phase_timing,
          "headline": phase_headline, "path_cv": phase_path_cv,
          FOUR_CARDS: phase_four_cards}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card column-sharded phase")
    args = ap.parse_args(argv)
    phases = phases_for(args.four_cards)

    sys.path.insert(0, REPO)
    try:
        from convex_optimization_tpu.utils.compile_cache import (
            enable_compile_cache)
    except ImportError as e:
        print(f"chip_smoke: the repository is not beside this script ({e})",
              file=sys.stderr)
        return 2
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devs[0].platform})",
              file=sys.stderr)
        return 1
    jax.config.update("jax_enable_x64", True)      # the float64 references
    cache = enable_compile_cache()
    print(f"card: {card_line()}")
    print(f"jax {jax.__version__} devices={len(devs)} "
          f"kind={devs[0].device_kind} XLA_FLAGS="
          f"{os.environ.get('XLA_FLAGS', '')!r} cache={cache}", flush=True)
    try:
        for name in phases:
            t0 = time.perf_counter()
            PHASES[name]()
            print(f"phase {name}: done in {time.perf_counter() - t0:.1f} s",
                  flush=True)
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(result_line(devs[0].device_kind, len(devs)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
