"""Headline benchmark: wall-clock to an f64-CERTIFIED 1e-6 relative duality
gap on a dense lasso (default 10k x 100k — the BASELINE.json north-star
size).  Two phases, both included in the reported time:

  1. the fused block-coordinate solver on the default device: one kernel
     launch per Gauss-Seidel sweep (ops/bcd_sweep.py), each column block
     of A read from device memory once and used for BOTH products in full
     f32, with stall detection at the f32 noise floor;
  2. support-restricted f64 polish (host f64 only on ~support-many
     columns; device f32-with-margin dual certificate elsewhere), which
     certifies rel_gap <= 1e-6 in float64 (solvers/polish.py).

Prints ONE JSON line:
  {"metric": ..., "value": <seconds>, "unit": "s", "vs_baseline": <speedup>}

vs_baseline is an honest like-for-like speedup: the baseline runs the SAME
algorithm our solve used (FISTA per-iteration or cyclic Gauss-Seidel BCD
per-sweep — both are the reference's algorithm families, SURVEY.md section
3.2/C9) implemented the reference's CPU way (NumPy), measured per unit on
the same instance and scaled by the iteration/sweep count our solve
actually used.  The baseline is NOT charged for a polish phase
(conservative: favors the baseline).

Env overrides: BENCH_M, BENCH_N, BENCH_TOL, BENCH_METHOD (bcd_pallas |
fista | bcd | admm), BENCH_BASE_SWEEPS.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np


def numpy_bcd_sweep_seconds(A: np.ndarray, b: np.ndarray, lam1: float,
                            block: int, sweeps: int = 2,
                            penalty_kind: str = "l1",
                            lam2: float = 0.0) -> float:
    """Measured seconds per cyclic Gauss-Seidel BCD sweep, NumPy on host.

    Per block: g_j = A_j^T r (+ lam2 x_j), prox with step 1/L_j
    (soft-threshold for l1; shift-and-clip for nonneg_l1 — the config-3
    variant), and the incremental residual update r += A_j dx — the
    reference's hot loop (SURVEY.md section 3.2) and the exact arithmetic
    of our fused kernel.
    """
    m, n = A.shape
    n_blocks = max(-(-n // block), 1)     # ceil: cover EVERY column
    # per-block Lipschitz (power iteration per block, setup — not timed)
    L = np.empty(n_blocks)
    rng = np.random.default_rng(0)
    bounds = [(j * block, min((j + 1) * block, n)) for j in range(n_blocks)]
    for j, (c0, c1) in enumerate(bounds):
        Aj = A[:, c0:c1]
        v = rng.standard_normal(Aj.shape[1]).astype(A.dtype)
        v /= np.linalg.norm(v)
        for _ in range(8):
            u = Aj.T @ (Aj @ v)
            v = u / max(np.linalg.norm(u), 1e-30)
        u = Aj @ v
        L[j] = 1.05 * float(u @ u) + lam2

    x = np.zeros(n, dtype=A.dtype)
    r = -b.copy()
    t0 = time.perf_counter()
    for _ in range(sweeps):
        for j, (c0, c1) in enumerate(bounds):
            sl = slice(c0, c1)
            Aj = A[:, sl]
            g = Aj.T @ r
            # python float: a np.float64 scalar would NEP-50-upcast the f32
            # vectors (and then A itself, via the matvec) to float64
            t = float(1.0 / L[j])
            if lam2:
                g = g + float(lam2) * x[sl]
            v = x[sl] - t * g
            if penalty_kind == "nonneg_l1":
                x_new = np.maximum(v - t * lam1, 0.0).astype(A.dtype)
            else:
                x_new = np.sign(v) * np.maximum(np.abs(v) - t * lam1, 0.0)
            r += Aj @ (x_new - x[sl])
            x[sl] = x_new
    t1 = time.perf_counter()
    return (t1 - t0) / sweeps


def numpy_fista_iter_seconds(A: np.ndarray, b: np.ndarray, lam1: float,
                             iters: int = 2) -> float:
    """Measured seconds per FISTA iteration, NumPy on host — the
    like-for-like baseline when OUR solve runs FISTA (same two passes over
    A per iteration, same prox)."""
    n = A.shape[1]
    v = np.random.default_rng(0).standard_normal(n).astype(A.dtype)
    v /= np.linalg.norm(v)
    for _ in range(8):
        u = A.T @ (A @ v)
        v = u / max(np.linalg.norm(u), 1e-30)
    u = A @ v
    L = 1.05 * float(u @ u)
    step = 1.0 / L
    x = np.zeros(n, dtype=A.dtype)
    x_prev = x.copy()
    r = -b.copy()
    r_prev = r.copy()
    t_mom = 1.0
    t0 = time.perf_counter()
    for _ in range(iters):
        # python floats throughout: np.float64 scalars would NEP-50-upcast
        # the f32 state and force an 8 GB/pass f64 cast of A (measured:
        # 166 s/iteration instead of ~2 s)
        t_next = float(0.5 * (1.0 + np.sqrt(1.0 + 4.0 * t_mom * t_mom)))
        beta = float((t_mom - 1.0) / t_next)
        y = x + beta * (x - x_prev)
        r_y = r + beta * (r - r_prev)
        g = A.T @ r_y
        w = y - step * g
        x_new = np.sign(w) * np.maximum(np.abs(w) - step * lam1, 0.0)
        r_new = A @ x_new - b
        x_prev, r_prev, x, r, t_mom = x, r, x_new, r_new, t_next
    t1 = time.perf_counter()
    return (t1 - t0) / iters


def _baseline_per_unit(method, A_np, b_np, lam1, base_sweeps):
    """Reference-style CPU baseline, cached per (shape, method, host): the
    measurement is deterministic per instance and costs minutes at the
    headline size."""
    m, n = A_np.shape
    cache_path = os.environ.get(
        "BENCH_BASELINE_CACHE",
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                     "bench_baseline_cache.json"))
    alg = "fista" if "fista" in method else "bcd"
    cache_key = f"{m}x{n}:seed42:block128:{os.uname().nodename}:{alg}"
    cache = {}
    try:
        with open(cache_path) as f:
            cache = json.load(f)
    except Exception:
        pass
    if cache_key in cache:
        return cache[cache_key]
    if alg == "fista":
        per_unit = numpy_fista_iter_seconds(A_np, b_np, lam1,
                                            iters=base_sweeps)
    else:
        per_unit = numpy_bcd_sweep_seconds(A_np, b_np, lam1, block=128,
                                           sweeps=base_sweeps)
    cache[cache_key] = per_unit
    try:
        os.makedirs(os.path.dirname(cache_path), exist_ok=True)
        with open(cache_path, "w") as f:
            json.dump(cache, f)
    except Exception:
        pass
    return per_unit


def main() -> None:
    m = int(os.environ.get("BENCH_M", 10_000))
    n = int(os.environ.get("BENCH_N", 100_000))
    tol = float(os.environ.get("BENCH_TOL", 1e-6))
    method = os.environ.get("BENCH_METHOD", "auto")
    base_sweeps = int(os.environ.get("BENCH_BASE_SWEEPS", 2))

    import jax

    if jax.devices()[0].platform != "gpu":
        # the benchmark measures the card; a CPU run would be a number of
        # another machine under the card's metric names
        sys.exit(f"bench.py: no GPU (JAX found "
                 f"{jax.devices()[0].platform})")
    from convex_optimization_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    from convex_optimization_tpu.ops import route

    if method == "auto":
        # the fused block-CD sweep wherever its gate admits the shape (one
        # read of A per sweep, Gauss-Seidel convergence); FISTA otherwise
        method = ("bcd_pallas" if route.pick_block_size(m, n, 128)
                  else "fista")

    from convex_optimization_tpu.core.datagen import make_lasso_instance_host
    from convex_optimization_tpu.api import solve
    from convex_optimization_tpu.solvers.polish import polish_support
    from convex_optimization_tpu.utils.metrics import effective_bandwidth

    # host-side generation (native threaded Gaussian fill) so the polish
    # phase and CPU baseline never fetch A back from the device
    inst, A_np, b_np = make_lasso_instance_host(42, m, n)
    problem = inst.problem
    lam1 = float(problem.penalty.lam1)

    # measure the CPU baseline FIRST, in a clean memory state: running it
    # after the solve+polish put it under memory pressure and inflated the
    # per-iteration time ~100x (measured), which would flatter vs_baseline
    per_unit = _baseline_per_unit(method, A_np, b_np, lam1, base_sweeps)

    res = solve(problem, method=method, tol=tol, max_iters=20_000,
                gap_every=10, stall_checks=15, block_size=128)
    # 'certified' ALWAYS means the f64 certificate — even when the f32
    # monitor already reads <= tol, its own error is O(log2(m) eps |P|)
    pr = polish_support(problem, res.x, tol=tol, A_host=A_np,
                        b_host=b_np, verbose=True)
    polish_wall = pr.wall_time_s
    final_gap = pr.rel_gap
    certified = pr.rel_gap <= tol
    polish_note = f" kept={pr.kept} f64_iters={pr.iterations}"
    if not certified:
        print(f"WARNING: not certified at tol={tol}; rel_gap={final_gap:.3e}",
              file=sys.stderr)

    total_wall = res.wall_time_s + polish_wall

    baseline_s = per_unit * max(res.iterations, 1)

    dev = jax.devices()[0]
    print(json.dumps({
        "metric": f"time_to_certified_{tol:g}_rel_gap_lasso_{m}x{n}",
        "value": round(total_wall, 4),
        "unit": "s",
        "vs_baseline": round(baseline_s / total_wall, 2)
            if total_wall > 0 else float("inf"),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    # passes over A per unit: the fused sweep reads A once, plus one
    # residual-refresh pass per gap check (gap_every=10); FISTA reads twice
    # per iteration
    passes = 1.0 + 1.0 / 10 if "bcd" in res.method else 2.0
    bw = effective_bandwidth(m, n, res.iterations, res.wall_time_s,
                             passes_per_iter=passes,
                             device_kind=dev.device_kind)
    print(
        f"# {res.method}: sweeps={res.iterations} "
        f"rel_gap={res.rel_gap:.2e} "
        f"wall={res.wall_time_s:.2f}s it/s={res.iters_per_sec:.1f} "
        f"bw={bw['achieved_gb_s']:.0f}GB/s "
        f"({100*bw['fraction_of_peak']:.0f}% of HBM peak) "
        f"compile={res.compile_time_s:.1f}s | polish: wall={polish_wall:.2f}s "
        f"final_gap={final_gap:.2e} certified={certified}{polish_note} | "
        f"baseline_per_unit={per_unit:.3f}s total={baseline_s:.1f}s | "
        f"device={dev.platform}:{dev.device_kind}",
        file=sys.stderr,
    )


if __name__ == "__main__":
    main()
