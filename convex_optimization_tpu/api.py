"""User-facing API (L5): ``solve(problem, method=...) -> Result``.

The reference's user surface is "run the driver script" (SURVEY.md section
3.1); this framework exposes a library call that picks the solver, handles
Lipschitz precompute, runs the single jitted solve, and returns a Result
with the solution, the certified gap, and the convergence history.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Optional

import jax
import jax.numpy as jnp

from convex_optimization_tpu.core.problem import Problem
from convex_optimization_tpu.solvers.common import SolverConfig
# importlib: the solvers package re-exports functions named `fista`/`bcd`
# that shadow the submodule attributes, so a plain `from ... import fista`
# would bind the jitted function, not the module
import importlib

fista_mod = importlib.import_module("convex_optimization_tpu.solvers.fista")
bcd_mod = importlib.import_module("convex_optimization_tpu.solvers.bcd")
from convex_optimization_tpu.ops.power_iter import (
    spectral_norm_sq,
    block_spectral_norms_sq,
)


# ADMM scale fence: above this min(m, n) the f32 device eigh of an
# ill-conditioned Gram stalls the solve ~1e-2 rel gap.  Module constant so
# tests can exercise the fence without a real >4096-dim eigendecomposition.
ADMM_FENCE_DIM = 4096


@dataclasses.dataclass
class Result:
    x: jax.Array
    gap: float               # absolute duality gap at the last check
    rel_gap: float           # relative duality gap (the convergence criterion)
    primal: float
    iterations: int          # FISTA iterations or BCD sweeps
    converged: bool
    wall_time_s: float       # solve wall-clock (excludes compilation)
    compile_time_s: float
    iters_per_sec: float
    history: dict            # trimmed convergence history (numpy arrays)
    method: str
    config: SolverConfig
    @property
    def nnz(self) -> int:
        return int(jnp.sum(self.x != 0))


def _pad_columns(problem: Problem, pad: int) -> Problem:
    """Append ``pad`` zero columns to A (one-time device copy).  The padded
    coordinates are provably zero at any optimum (zero columns), and the
    callers additionally freeze them via the solver keep mask."""
    import dataclasses

    import jax.numpy as jnp

    A = jnp.pad(problem.A, ((0, 0), (0, pad)))
    pen = problem.penalty
    if pen.kind == "group_l2":
        gsize = problem.n // pen.ngroups
        assert pad % gsize == 0, "padding must be whole groups"
        extra = pad // gsize
        w = pen.weights
        if w is not None:
            w = jnp.concatenate([w, jnp.ones((extra,), w.dtype)])
        pen = dataclasses.replace(pen, ngroups=pen.ngroups + extra, weights=w)
    return dataclasses.replace(problem, A=A, penalty=pen)


def _bcd_setup(problem: Problem, cfg: SolverConfig, x0, col_norms,
               method: str):
    """Block size, layout and per-block Lipschitz constants of a BCD solve.

    ``method='bcd_pallas'`` (or ``cfg.use_pallas``) runs the fused sweep
    (ops/route.py picks its implementation) on the transposed layout A_t,
    zero-padding columns when no block width divides n.  When the sweep's
    gate or the device memory budget refuses the problem, it warns and runs
    plain ``'bcd'`` instead; the returned method (Result.method) records
    the substitution.

    Returns (problem, cfg, A_t, block_L, keep_mask, x0, col_norms, method)
    for the problem actually solved (padded or not)."""
    from convex_optimization_tpu.ops import route
    from convex_optimization_tpu.ops.matvec import (
        block_power_t,
        to_tblock_major,
    )

    multiple = 1
    if problem.penalty.kind == "group_l2":
        multiple = problem.n // problem.penalty.ngroups
    if cfg.use_pallas:
        picked = route.pick_block_size(problem.m, problem.n, cfg.block_size,
                                       multiple, dtype=problem.dtype)
        if picked is None:
            reason = (f"no fused-sweep block for (m={problem.m}, "
                      f"n={problem.n}, {jnp.dtype(problem.dtype).name})")
        else:
            bs, pad = picked
            # A and A_t stay resident, plus the padded copy when padding
            copies = 2 if pad == 0 else 3
            reason = (None if route.fits_device_memory(
                problem.m, problem.n + pad, problem.dtype, copies)
                else f"{copies} copies of A exceed the device memory budget")
        if reason is None:
            keep = None
            if pad:
                # padded coordinates are frozen at 0 by the keep mask and
                # sliced off the returned solution
                problem = _pad_columns(problem, pad)
                keep = jnp.arange(problem.n) < problem.n - pad
                if x0 is not None:
                    x0 = jnp.pad(x0, (0, pad))
                if col_norms is not None:
                    col_norms = problem.col_norms()
            A_t = to_tblock_major(problem.A, problem.n // bs)
            block_L = jax.jit(block_power_t)(A_t)
            return problem, cfg, A_t, block_L, keep, x0, col_norms, method
        warnings.warn(f"bcd_pallas gate failed ({reason}); running plain "
                      f"bcd — Result.method records the substitution",
                      stacklevel=3)
        method = "bcd"
        cfg = dataclasses.replace(cfg, use_pallas=False)
    bs = bcd_mod.pick_block_size(problem.n, cfg.block_size,
                                 multiple_of=multiple)
    block_L = block_spectral_norms_sq(problem.A, problem.n // bs)
    return problem, cfg, None, block_L, None, x0, col_norms, method


def solve(
    problem: Problem,
    method: str = "fista",
    *,
    x0: Optional[jax.Array] = None,
    cfg: Optional[SolverConfig] = None,
    mesh: Optional[jax.sharding.Mesh] = None,
    certify: bool = False,
    **cfg_overrides: Any,
) -> Result:
    """Solve a composite problem.
    method: 'fista' | 'ista' | 'bcd' | 'bcd_pallas' | 'admm' |
    'fista_ws' | 'bcd_ws' (working-set outer loop, solvers/working_set.py).

    When ``mesh`` is given, the sharded solver matching the mesh's axis
    names is used (see parallel/); otherwise everything runs on the default
    device.  ``certify=True`` finishes with the f64 polish phase whenever
    the f32 solve stalls above tol, so Result.rel_gap is an f64-grade
    certificate (solvers/polish.py).  Extra kwargs override SolverConfig
    fields (e.g. tol=1e-8, max_iters=5000).
    """
    if mesh is not None:
        from convex_optimization_tpu.parallel.sharded import solve_sharded

        res = solve_sharded(problem, method=method, mesh=mesh, x0=x0,
                            cfg=cfg, **cfg_overrides)
        return _maybe_certify(problem, res, certify)

    if cfg is None:
        cfg = SolverConfig()
    if method == "ista":
        cfg_overrides.setdefault("momentum", False)
    if method == "bcd_pallas":
        cfg_overrides.setdefault("use_pallas", True)
    admm_force = bool(cfg_overrides.pop("admm_force", False))
    admm_setup_mode = cfg_overrides.pop("admm_setup", "device")
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)

    if method in ("fista_ws", "bcd_ws"):
        from convex_optimization_tpu.solvers.working_set import (
            make_ws_route,
            solve_working_set,
        )

        inner = "bcd" if method == "bcd_ws" else "fista"
        # one run: route setup (layout, spectral norm) is set-up time; the
        # rest, compiles of the bucket programs included, is the solve
        t0 = time.perf_counter()
        route = make_ws_route(problem)
        x_ws, info, meta = solve_working_set(problem, cfg, x0=x0,
                                             inner=inner, route=route)
        t1 = time.perf_counter()
        wall, n_it = meta["wall_s"], meta["inner_iters"]
        res = Result(
            x=x_ws, gap=float(info.gap), rel_gap=float(info.rel_gap),
            primal=float(info.primal), iterations=n_it,
            converged=bool(info.rel_gap <= cfg.tol), wall_time_s=wall,
            compile_time_s=max((t1 - t0) - wall, 0.0),
            iters_per_sec=(n_it / wall if wall > 0 else 0.0),
            history=dict(meta),
            method=method, config=cfg,
        )
        return _maybe_certify(problem, res, certify)

    col_norms = problem.col_norms() if cfg.screen_every > 0 else None
    orig_n = problem.n  # the bcd_pallas branch may zero-pad columns
    user_problem = problem  # unpadded view, for the certify phase

    # Each branch yields the jitted fn, its dynamic arguments for a state,
    # and its static keyword arguments.
    static = {"cfg": cfg}
    if method in ("fista", "ista"):
        L_total = spectral_norm_sq(problem.A) + problem.lam2
        make_state = lambda x: fista_mod.init_state(problem, x, cfg)
        jfn = fista_mod.fista
        jargs = lambda s: ((problem, L_total, s),
                           {"col_norms": col_norms, "A_t": None})
    elif method in ("bcd", "bcd_pallas"):
        (solve_problem, cfg, A_t, block_L, base_mask, x0, col_norms,
         method) = _bcd_setup(problem, cfg, x0, col_norms, method)
        static = {"cfg": cfg}
        make_state = lambda x: fista_mod.init_state(solve_problem, x, cfg,
                                                    keep_mask=base_mask)
        jfn = bcd_mod.bcd
        jargs = lambda s: ((solve_problem, block_L, s),
                           {"col_norms": col_norms, "A_t": A_t})
    elif method == "admm":
        from convex_optimization_tpu.solvers import admm as admm_mod

        # Scale fence: the exact x-update rests on an f32 eigh of the
        # min(m,n)-dim Gram; beyond ~4k dims the f32 eigenbasis of an
        # ill-conditioned Gram is inaccurate enough that the solve stalls
        # near 1e-2 relative gap while silently burning max_iters.  Pass
        # admm_force=True to run anyway (e.g. for well-conditioned A or
        # loose tolerances), or admm_setup='host' for the host-f64
        # eigendecomposition path (admm_setup_host: f32 loop unchanged,
        # f64-accurate eigenbasis).  At scale the f32 gap MONITOR of that
        # path can read far above the iterate's true gap (an f32-witness
        # artifact), so certification must come from the polish phase.
        if (min(problem.m, problem.n) > ADMM_FENCE_DIM and not admm_force
                and admm_setup_mode != "host"):
            warnings.warn(
                "admm at min(m, n) > 4096 stalls ~1e-2 rel gap (f32 eigh "
                "accuracy) — falling back to FISTA. "
                "Pass admm_force=True to run ADMM anyway, or "
                "admm_setup='host' for the host-f64 eigh setup.",
                stacklevel=2)
            return solve(problem, "fista", x0=x0, cfg=cfg, mesh=mesh,
                         certify=certify)
        fac = (admm_mod.admm_setup_host(problem)
               if admm_setup_mode == "host"
               else admm_mod.admm_setup(problem))
        make_state = lambda x: admm_mod.init_state(problem, x, cfg)
        jfn = admm_mod.admm
        jargs = lambda s: ((problem, fac, s), {})
    elif method == "bcd_batch":
        raise ValueError(
            "method 'bcd_batch' solves a LAMBDA GRID, not a single point — "
            "use lambda_path(problem, cfg, method='bcd_batch') or the CLI's "
            "--method bcd_batch --lambda-path N")
    else:
        raise ValueError(f"unknown method {method!r}")

    # compile ahead of time (set-up), then one execution ended by
    # block_until_ready is the solve's wall clock
    args, kwargs = jargs(make_state(x0))
    t0 = time.perf_counter()
    compiled = jfn.lower(*args, **kwargs, **static).compile()
    t1 = time.perf_counter()
    final = jax.block_until_ready(compiled(*args, **kwargs))
    wall = time.perf_counter() - t1
    iters = int(final.k)

    # return the BEST-certified iterate: an f32 solve oscillates at its
    # noise floor, and the last check can read ~2x worse than the best
    x_out = final.x_best
    res = Result(
        x=x_out if x_out.shape[0] == orig_n else x_out[:orig_n],
        gap=float(final.best_gap),
        rel_gap=float(final.best_rel_gap),
        primal=float(final.best_primal),
        iterations=iters,
        converged=bool(final.best_rel_gap <= cfg.tol),
        wall_time_s=wall,
        compile_time_s=t1 - t0,
        iters_per_sec=iters / wall if wall > 0 else float("inf"),
        history=final.history.trimmed(),
        method=method,
        config=cfg,
    )
    return _maybe_certify(user_problem, res, certify)


def _maybe_certify(problem: Problem, res: "Result", certify: bool) -> "Result":
    """certify=True: if the f32 solve stalled above tol, finish with the f64
    polish phase and fold its certificate into the Result."""
    import dataclasses as _dc

    if not certify or (res.converged and res.rel_gap <= res.config.tol):
        return res
    from convex_optimization_tpu.solvers.polish import polish_support

    pr = polish_support(problem, res.x, tol=res.config.tol)
    # pr.x stays a float64 numpy array: casting back to the problem dtype
    # (f32) would re-introduce representation error above deep tolerances
    return _dc.replace(
        res,
        x=pr.x,
        gap=pr.gap, rel_gap=pr.rel_gap, primal=pr.primal,
        converged=pr.rel_gap <= res.config.tol,
        wall_time_s=res.wall_time_s + pr.wall_time_s,
    )
