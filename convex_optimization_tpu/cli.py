"""Command-line driver (SURVEY.md C7 / section 5 config row).

The reference's user surface is "edit the constants module, run the driver
script"; this CLI maps 1:1 onto the five BASELINE.md benchmark configs plus
custom sizes, with structured JSONL metrics, snapshots, and resume.

    python -m convex_optimization_tpu.cli --config config1 --ci
    python -m convex_optimization_tpu.cli --m 2000 --n 8000 --method bcd
    python -m convex_optimization_tpu.cli --config config2 --jsonl out.jsonl
    python -m convex_optimization_tpu.cli --config config5 --mesh 8 --ci
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="convex_optimization_tpu",
        description="sparse-regression solver benchmark driver",
    )
    p.add_argument("--config", choices=["config1", "config2", "config3",
                                        "config4", "config5"],
                   help="named BASELINE.md benchmark config")
    p.add_argument("--ci", action="store_true",
                   help="run the CI-sized twin of the named config")
    p.add_argument("--m", type=int, help="rows (overrides config)")
    p.add_argument("--n", type=int, help="columns (overrides config)")
    p.add_argument("--penalty", default=None,
                   choices=["l1", "nonneg_l1", "group_l2"])
    p.add_argument("--ngroups", type=int, default=0)
    p.add_argument("--lam1-frac", type=float, default=0.1,
                   help="lam1 as a fraction of lambda_max")
    p.add_argument("--lam2", type=float, default=0.0,
                   help="ridge coefficient (elastic net)")
    p.add_argument("--method", default="fista",
                   choices=["fista", "ista", "bcd", "bcd_pallas", "admm",
                            "fista_ws", "bcd_ws", "bcd_batch"])
    p.add_argument("--cv-method", default="bcd_batch",
                   choices=["bcd_batch", "fista", "ista", "bcd",
                            "bcd_pallas"],
                   help="solver for --cv fold paths (bcd_batch = "
                        "batched fused sweeps, all folds sharing one "
                        "resident A)")
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("--max-iters", type=int, default=10_000)
    p.add_argument("--gap-every", type=int, default=10)
    p.add_argument("--screen", action="store_true",
                   help="enable gap-safe screening")
    p.add_argument("--lambda-path", type=int, default=0,
                   help="run a warm-started geometric path of this length")
    p.add_argument("--path-compact", action="store_true",
                   help="per-lambda gap-safe compaction along the path "
                        "(actual FLOP reduction at the sparse end)")
    p.add_argument("--cv", type=int, default=0, metavar="K",
                   help="K-fold cross-validation over the lambda path "
                        "(picks lambda by held-out MSE; path length from "
                        "--lambda-path, default 10)")
    p.add_argument("--mesh", type=int, default=0,
                   help="shard A over this many devices")
    p.add_argument("--mesh-axis", default="blocks",
                   choices=["blocks", "rows"],
                   help="blocks = column/TP-analog sharding (m-vector psum "
                        "per iter); rows = DP-analog (n-vector psum)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--jsonl", help="write per-check metrics to this file")
    p.add_argument("--checkpoint", help="write a snapshot here after solving")
    p.add_argument("--resume", action="store_true",
                   help="warm-start from --checkpoint if it exists")
    p.add_argument("--polish", action="store_true",
                   help="finish with the f64 certification phase "
                        "(solvers/polish.py polish_fast)")
    p.add_argument("--stall-checks", type=int, default=0,
                   help="exit after this many gap checks without a new "
                        "best (f32 noise-floor detection)")
    p.add_argument("--f64", action="store_true",
                   help="float64 instance (CPU verification path)")
    p.add_argument("--profile", metavar="DIR",
                   help="capture a jax.profiler trace of the solve to DIR")
    p.add_argument("--plot", metavar="PNG",
                   help="write the error-vs-iteration convergence plot "
                        "(or the per-lambda path summary) here — the "
                        "reference driver's matplotlib output, SURVEY.md C7")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import jax
    import jax.numpy as jnp

    from convex_optimization_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    if args.f64:
        jax.config.update("jax_enable_x64", True)

    from convex_optimization_tpu.api import solve
    from convex_optimization_tpu.core.datagen import (
        BENCH_CONFIGS,
        make_lasso_instance,
    )
    from convex_optimization_tpu.utils import checkpoint as ckpt
    from convex_optimization_tpu.utils import metrics as M

    # resolve the instance spec.  When --polish is requested on a separable
    # penalty, generate host-side (native runtime) and keep the host copies:
    # the polish phase then never pulls GB-scale columns back through the
    # device transport.
    A_host = b_host = None

    def _host_gen(m, n, penalty_kind, ngroups, lam1_frac, lam2):
        from convex_optimization_tpu.core.datagen import (
            make_lasso_instance_host,
        )

        return make_lasso_instance_host(
            args.seed, m, n, penalty_kind=penalty_kind, ngroups=ngroups,
            lam1_frac=lam1_frac, lam2=lam2,
        )

    if args.config:
        cfg = BENCH_CONFIGS[args.config]
        name = cfg.name + ("-ci" if args.ci else "")
        lambda_path = args.lambda_path or cfg.lambda_path
        screen = args.screen or cfg.screening
        mesh_n = args.mesh or 0
        if args.polish and not args.f64 and not args.ci \
                and cfg.penalty_kind in ("l1", "nonneg_l1"):
            inst, A_host, b_host = _host_gen(
                cfg.m, cfg.n, cfg.penalty_kind, cfg.ngroups,
                cfg.lam1_frac, cfg.lam2)
        else:
            inst = cfg.instance(
                jax.random.PRNGKey(args.seed), ci=args.ci,
                dtype=jnp.float64 if args.f64 else jnp.float32)
    else:
        if not (args.m and args.n):
            print("either --config or both --m/--n are required",
                  file=sys.stderr)
            return 2
        name = f"custom-{args.m}x{args.n}"
        lambda_path = args.lambda_path
        screen = args.screen
        mesh_n = args.mesh
        kind = args.penalty or "l1"
        if args.polish and not args.f64 and kind in ("l1", "nonneg_l1"):
            inst, A_host, b_host = _host_gen(
                args.m, args.n, kind, args.ngroups, args.lam1_frac,
                args.lam2)
        else:
            inst = make_lasso_instance(
                jax.random.PRNGKey(args.seed), args.m, args.n,
                penalty_kind=kind, ngroups=args.ngroups,
                lam1_frac=args.lam1_frac, lam2=args.lam2,
                dtype=jnp.float64 if args.f64 else jnp.float32,
            )

    problem = inst.problem
    solve_kw: dict = dict(
        method=args.method, tol=args.tol, max_iters=args.max_iters,
        gap_every=args.gap_every,
    )
    if args.stall_checks:
        solve_kw["stall_checks"] = args.stall_checks
    if screen:
        solve_kw["screen_every"] = 1
    if mesh_n:
        from convex_optimization_tpu.parallel.mesh import make_mesh

        solve_kw["mesh"] = make_mesh(mesh_n, axis=args.mesh_axis)

    if args.resume and args.checkpoint:
        import os

        if os.path.exists(args.checkpoint):
            snap = ckpt.load_snapshot(args.checkpoint)
            solve_kw["x0"] = jnp.asarray(snap.x, dtype=problem.dtype)
            problem = problem.with_lam1(snap.lam1)
            print(f"resumed from {args.checkpoint} (lam_index="
                  f"{snap.lam_index})", file=sys.stderr)

    if args.cv:
        from convex_optimization_tpu.solvers.common import SolverConfig
        from convex_optimization_tpu.solvers.cv import cv_lambda_path

        scfg = SolverConfig(max_iters=args.max_iters, tol=args.tol,
                            gap_every=args.gap_every,
                            screen_every=1 if screen else 0,
                            stall_checks=args.stall_checks)
        with M.WallTimer() as t:
            cvres = cv_lambda_path(
                problem, scfg, k=args.cv, path_len=lambda_path or 10,
                seed=args.seed, method=args.cv_method)
            jax.block_until_ready(cvres.mean_mse)
        out = {
            "name": name, "mode": "cv", "k": args.cv,
            "method_used": cvres.method_used,
            "wall_s": float(t),
            "lambdas": [float(v) for v in cvres.lambdas],
            "mean_mse": [float(v) for v in cvres.mean_mse],
            "se_mse": [float(v) for v in cvres.se_mse],
            "best_lambda": cvres.best_lambda,
            "one_se_lambda": cvres.one_se_lambda,
            "nnz_best": int(jnp.sum(cvres.x != 0)),
            "nnz_one_se": int(jnp.sum(cvres.x_one_se != 0)),
        }
        print(f"[{name}] cv k={args.cv}: best_lambda="
              f"{cvres.best_lambda:.4g} (mse "
              f"{float(cvres.mean_mse[cvres.best_index]):.4g}), 1-SE "
              f"lambda={cvres.one_se_lambda:.4g}, wall={float(t):.2f}s",
              file=sys.stderr)
        print(json.dumps(out))
        if args.plot:
            from convex_optimization_tpu.utils.plotting import plot_cv

            if plot_cv(cvres.lambdas, cvres.mean_mse, cvres.se_mse,
                       cvres.best_lambda, cvres.one_se_lambda, args.plot,
                       title=f"{name}: {args.cv}-fold CV"):
                print(f"[{name}] wrote {args.plot}", file=sys.stderr)
        return 0

    if lambda_path:
        from convex_optimization_tpu.solvers.common import SolverConfig
        from convex_optimization_tpu.solvers.lambda_path import lambda_path as run_path

        scfg = SolverConfig(max_iters=args.max_iters, tol=args.tol,
                            gap_every=args.gap_every,
                            screen_every=1 if screen else 0,
                            stall_checks=args.stall_checks)
        path_kw = {}
        if args.method != "fista":
            path_kw["method"] = args.method   # bcd/bcd_pallas paths reuse
                                              # one compiled GS program
        if args.path_compact:
            path_kw["compact"] = True
        if mesh_n:
            from convex_optimization_tpu.parallel.mesh import make_mesh

            path_kw["mesh"] = make_mesh(mesh_n, axis=args.mesh_axis)
        with M.WallTimer() as t:
            pr = run_path(problem, scfg, path_len=lambda_path, **path_kw)
            jax.block_until_ready((pr.xs, pr.gaps))
        rows = []
        for i in range(lambda_path):
            rows.append({
                "lam1": float(pr.lambdas[i]),
                "rel_gap": float(pr.gaps[i]),
                "iters": int(pr.iters[i]),
                "nnz": int(jnp.sum(pr.xs[i] != 0)),
            })
            if pr.kept is not None:
                rows[-1]["kept"] = int(pr.kept[i])
            print(f"[{name}] path[{i}] lam1={rows[-1]['lam1']:.4g} "
                  f"iters={rows[-1]['iters']} rel_gap={rows[-1]['rel_gap']:.2e} "
                  f"nnz={rows[-1]['nnz']}", file=sys.stderr)
        print(json.dumps({"name": name, "mode": "lambda_path",
                          "wall_s": float(t), "path": rows}))
        if args.plot:
            from convex_optimization_tpu.utils.plotting import plot_path

            if plot_path([r["lam1"] for r in rows],
                         [max(r["rel_gap"], 0.0) for r in rows],
                         [r["iters"] for r in rows],
                         [r["nnz"] for r in rows], args.plot,
                         title=f"{name}: lambda path"):
                print(f"[{name}] wrote {args.plot}", file=sys.stderr)
        if args.checkpoint:
            ckpt.save_snapshot(args.checkpoint, jax.device_get(pr.xs[-1]),
                               float(pr.lambdas[-1]),
                               lam_index=lambda_path - 1,
                               meta={"name": name})
        return 0

    profile_ctx = None
    if args.profile:
        profile_ctx = jax.profiler.trace(args.profile)
        profile_ctx.__enter__()
    res = solve(problem, **solve_kw)
    if profile_ctx is not None:
        profile_ctx.__exit__(None, None, None)

    M.summary_line(name, res)
    dev = jax.devices()[0]
    out = {
        "name": name, "method": res.method, "m": problem.m, "n": problem.n,
        "iterations": res.iterations, "rel_gap": res.rel_gap,
        "converged": res.converged, "wall_s": res.wall_time_s,
        "iters_per_sec": res.iters_per_sec, "nnz": res.nnz,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    if dev.device_kind in M.HBM_PEAK_BYTES_S:
        bw = M.effective_bandwidth(problem.m, problem.n, res.iterations,
                                   res.wall_time_s,
                                   device_kind=dev.device_kind)
        out["achieved_gb_s"] = bw["achieved_gb_s"]
        out["fraction_of_hbm_peak"] = bw["fraction_of_peak"]
    x_out = res.x
    if args.polish and not (res.converged and res.rel_gap <= args.tol):
        from convex_optimization_tpu.solvers.polish import polish_support

        pr = polish_support(problem, res.x, tol=args.tol,
                            A_host=A_host, b_host=b_host)
        out.update({
            "polish_wall_s": pr.wall_time_s,
            "certified_rel_gap": pr.rel_gap,
            "certified": pr.rel_gap <= args.tol,
            "polish_kept": pr.kept,
        })
        x_out = pr.x
        print(f"[{name}] polish: gap={pr.rel_gap:.2e} kept={pr.kept} "
              f"wall={pr.wall_time_s:.2f}s", file=sys.stderr)
    print(json.dumps(out))

    if args.plot:
        from convex_optimization_tpu.utils.plotting import plot_history

        if plot_history(res.history, args.plot,
                        title=f"{name}: {res.method} "
                              f"{problem.m}x{problem.n}"):
            print(f"[{name}] wrote {args.plot}", file=sys.stderr)
    if args.jsonl:
        with open(args.jsonl, "w") as f:
            M.write_jsonl(M.records_from_history(res.history,
                                                 res.wall_time_s),
                          f, meta=out)
    if args.checkpoint:
        ckpt.save_snapshot(args.checkpoint, jax.device_get(x_out),
                           float(jax.device_get(
                               jnp.asarray(problem.penalty.lam1))),
                           iteration=res.iterations, meta={"name": name})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
