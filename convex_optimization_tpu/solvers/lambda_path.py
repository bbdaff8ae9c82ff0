"""Warm-started lambda path (SURVEY.md C10, section 3.5 / config 2).

Solves a geometric sequence lam_max -> lam_min, warm-starting each solve at
the previous solution.  lam1 is *data* (a traced leaf of the Penalty pytree),
so every path point reuses ONE compiled solver — the host loop costs nothing
but dispatch.  Gap-safe screening masks sharpen as the path descends; the
mask is carried forward (a coordinate screened at larger lam1 is NOT
necessarily zero at smaller lam1, so masks are re-derived, not inherited —
only the warm-start x is inherited).

``compact=True`` additionally SHRINKS the problem per path point
(SURVEY.md section 7.2 step 6): a gap-safe screen at the warm start
discards columns, and the solve runs on the compacted columns only — an
actual FLOP reduction, unlike in-solver masking.  Kept counts are bucketed
(padded up with extra columns) so re-jits amortize across path points of
similar active size.

CAVEAT: at the standard geometric spacing the warm start's gap at the NEXT
lam1 is large (order (lam_k-1 - lam_k) * ||x||_1), so the safe radius keeps
nearly every column and each point pays a fresh re-jit.  Use compact=True
only for DENSELY spaced paths (small lam steps, e.g. 50+ points), where the
warm-start gap is small and the screen bites; otherwise prefer
compact=False (in-solver masks are free).  ``method='bcd_batch'``
(solvers/batched_path.py) shares one stream of A among every grid point
per sweep; dense grids run in warm-started chunks of 16.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from convex_optimization_tpu.core.problem import Problem
from convex_optimization_tpu.core.objective import lambda_max
from convex_optimization_tpu.solvers.common import SolverConfig
from convex_optimization_tpu.solvers.fista import fista, init_state


class PathResult(NamedTuple):
    lambdas: jax.Array      # (path_len,)
    xs: jax.Array           # (path_len, n) solutions
    gaps: jax.Array         # (path_len,) final relative gaps
    iters: jax.Array        # (path_len,) iterations used
    kept: jax.Array | None = None   # (path_len,) columns solved per point
                                    # (compact=True only; else None)
    method_used: str | None = None  # the solver that ACTUALLY ran (VERDICT
                                    # r4 Weak #4: gate fallbacks must be
                                    # observable, not silent)
    converged: jax.Array | None = None  # (path_len,) bool: certified
                                        # <= tol (False = stalled/capped)


def _bucket(k: int, n: int) -> int:
    """Round the kept count up to a re-jit bucket (smaller buckets for
    small problems so compaction still bites)."""
    bucket = min(512, max(64, n // 8))
    return min(n, -(-max(k, 1) // bucket) * bucket)


def lambda_path(
    problem: Problem,
    cfg: SolverConfig,
    *,
    path_len: int = 10,
    lam_min_frac: float = 0.01,
    lambdas: jax.Array | None = None,
    compact: bool = False,
    mesh: jax.sharding.Mesh | None = None,
    method: str = "fista",
    admm_setup: str = "device",
) -> PathResult:
    """Warm-started path with one compiled solver program.

    lam1 is DATA (a traced Penalty leaf), so every path point reuses the
    single jitted program regardless of ``method``:
      * 'fista' / 'ista' — the original path solver;
      * 'bcd' / 'bcd_pallas' — Gauss-Seidel sweeps; 'bcd_pallas' runs the
        fused sweep (one read of A per sweep), and the transposed relayout
        + block Lipschitz constants are hoisted ONCE for the whole path.
        CAVEAT: at the dense end of a deep path (lam ~ 0.01
        lam_max) plain GS lacks FISTA's momentum and can need many more
        sweeps than FISTA needs iterations — prefer 'fista' when the path
        descends far into the dense regime.

    With ``mesh`` the path runs column-sharded (FISTA or, with
    method='bcd'/'bcd_pallas', per-card fused GS sweeps): warm starts
    never leave the device mesh."""
    if method == "bcd_batch" and compact:
        # loud-failure convention (ADVICE r4 / api.solve parity): the batch
        # solver iterates the full grid simultaneously — per-point column
        # compaction has no analog; silently substituting FISTA poisoned
        # bake-off numbers
        raise ValueError(
            "method='bcd_batch' does not support compact=True (the batched "
            "grid shares one A stream; compaction is per-point).  Use "
            "compact=False, or method='bcd_ws' for support-compacted path "
            "points.")
    if mesh is not None:
        if compact:
            raise NotImplementedError("compact paths are single-device")
        if method == "bcd_batch":
            from convex_optimization_tpu.solvers.batched_path import (
                batched_lambda_path,
            )

            return batched_lambda_path(problem, cfg, path_len=path_len,
                                       lam_min_frac=lam_min_frac,
                                       lambdas=lambdas, mesh=mesh)
        return _lambda_path_sharded(problem, cfg, mesh, path_len,
                                    lam_min_frac, lambdas, method=method)
    if lambdas is None:
        lmax = lambda_max(problem.A, problem.b, problem.penalty)
        # start just below lam_max (at lam_max the solution is exactly 0)
        lambdas = jnp.geomspace(0.95 * lmax, lam_min_frac * lmax, path_len)
    lambdas = jnp.asarray(lambdas)

    from convex_optimization_tpu.ops.power_iter import spectral_norm_sq

    col_norms = problem.col_norms() if (cfg.screen_every > 0 or compact) \
        else None

    xs, gaps, iters, kept = [], [], [], []
    x_warm = None

    if not compact and method == "bcd_batch":
        # every path point iterates SIMULTANEOUSLY against one streamed
        # read of A per sweep (ops/bcd_sweep.py) — total passes = max over
        # points instead of sum over points; falls back to the sequential
        # bcd_pallas path when the batch gate fails
        from convex_optimization_tpu.solvers.batched_path import (
            batched_lambda_path,
        )

        return batched_lambda_path(problem, cfg, lambdas=lambdas,
                                   path_len=path_len,
                                   lam_min_frac=lam_min_frac)

    if not compact and method in ("fista_ws", "bcd_ws"):
        # working-set path: each point re-solves a compacted subproblem
        # whose support overlaps the previous point's, so the route
        # (A_t + spectral norm) is computed ONCE and
        # every bucket-shape program — burn-in, screen, gather, compact
        # solve — persists across the whole path (module-level jits in
        # solvers/working_set.py).  lam1 is data, so path points only ever
        # add NEW shapes when the support outgrows a bucket.
        from convex_optimization_tpu.solvers.working_set import (
            make_ws_route,
            solve_working_set,
        )

        route = make_ws_route(problem)
        inner = "bcd" if method == "bcd_ws" else "fista"
        for lam in lambdas:
            p = problem.with_lam1(lam)
            x_w, info, meta = solve_working_set(
                p, cfg, x0=x_warm, inner=inner, route=route)
            x_warm = x_w
            xs.append(x_w)
            gaps.append(info.rel_gap)
            iters.append(jnp.asarray(meta["inner_iters"], jnp.int32))
            kept.append(meta["ws_size"])
        gaps = jnp.stack(gaps)
        return PathResult(lambdas=lambdas, xs=jnp.stack(xs),
                          gaps=gaps, iters=jnp.stack(iters),
                          kept=jnp.asarray(kept), method_used=method,
                          converged=gaps <= cfg.tol)

    if not compact and method == "admm":
        # the eigenbasis factorization is lam-independent (solvers/admm.py
        # docstring): ONE setup + one compiled program serve the whole
        # path; lam1 is data and every rho rescale is free in the
        # eigenbasis.
        from convex_optimization_tpu.solvers import admm as admm_mod

        # same scale fence as api.solve: the f32 device eigh of a >4096-dim
        # Gram stalls ~1e-2 rel gap (BASELINE.md); route to the host-f64
        # setup via admm_setup='host', or fall back to the FISTA path
        from convex_optimization_tpu.api import ADMM_FENCE_DIM

        if min(problem.m, problem.n) > ADMM_FENCE_DIM:
            if admm_setup == "host":
                fac = admm_mod.admm_setup_host(problem)
            else:
                import warnings

                warnings.warn(
                    "lambda_path(method='admm') at min(m, n) > 4096: f32 "
                    "eigh stalls ~1e-2 rel gap (BASELINE.md) — falling "
                    "back to the FISTA path.  Pass admm_setup='host' for "
                    "the host-f64 setup.", stacklevel=2)
                return lambda_path(problem, cfg, path_len=path_len,
                                   lam_min_frac=lam_min_frac,
                                   lambdas=lambdas)
        else:
            fac = (admm_mod.admm_setup_host(problem)
                   if admm_setup == "host"
                   else admm_mod.admm_setup(problem))
        rho_warm = None
        for lam in lambdas:
            p = problem.with_lam1(lam)
            # warm-start BOTH x and rho: rho0 defaults to the point's own
            # lam1 scale for the first point (admm.init_state — 'keeps the
            # first prox threshold lam1/rho ~ 1'), and later points inherit
            # the previous point's balanced rho — restarting rho cold at a
            # new lam triggers a rebalancing transient during which the gap
            # plateaus and stall detection aborts the point (measured: the
            # deepest path point exited at 5e-2 rel gap after 50 iters)
            state = admm_mod.init_state(p, x_warm, cfg, rho0=rho_warm)
            state = admm_mod.admm(p, fac, state, cfg)
            x_warm = state.x_best
            rho_warm = state.rho
            xs.append(state.x_best)
            gaps.append(state.best_rel_gap)
            iters.append(state.k)
        gaps = jnp.stack(gaps)
        return PathResult(lambdas=lambdas, xs=jnp.stack(xs),
                          gaps=gaps, iters=jnp.stack(iters),
                          method_used="admm", converged=gaps <= cfg.tol)

    if not compact and method in ("bcd", "bcd_pallas"):
        import dataclasses as _dc

        from convex_optimization_tpu.solvers.bcd import bcd, pick_block_size
        from convex_optimization_tpu.ops import route
        from convex_optimization_tpu.ops.matvec import (
            block_power_t,
            to_tblock_major,
        )
        from convex_optimization_tpu.ops.power_iter import (
            block_spectral_norms_sq,
        )

        multiple = 1
        if problem.penalty.kind == "group_l2":
            multiple = problem.n // problem.penalty.ngroups
        bs = None
        if method == "bcd_pallas":
            # pad-free fused-sweep block FIRST, capped at 128: blocks wider
            # than that slow Gauss-Seidel convergence (a near-square
            # block's 1/L_j step degenerates toward ISTA)
            picked = route.pick_block_size(
                problem.m, problem.n, min(cfg.block_size, 128), multiple,
                dtype=problem.dtype)
            if picked is not None and picked[1] == 0 and \
                    route.fits_device_memory(problem.m, problem.n,
                                             problem.dtype, copies=2):
                bs = picked[0]
            else:
                import warnings

                warnings.warn(
                    f"bcd_pallas gate failed (no pad-free fused-sweep block "
                    f"for m={problem.m}, n={problem.n}, "
                    f"{jnp.dtype(problem.dtype).name}, or no device memory "
                    f"for A_t); running the plain bcd path — method_used "
                    f"records it", stacklevel=2)
                method = "bcd"
        cfg = _dc.replace(cfg, use_pallas=bs is not None)
        A_t = None
        if bs is not None:
            A_t = to_tblock_major(problem.A, problem.n // bs)
            block_L = jax.jit(block_power_t)(A_t)
        else:
            bs = pick_block_size(problem.n, cfg.block_size,
                                 multiple_of=multiple)
            block_L = block_spectral_norms_sq(problem.A, problem.n // bs)
        for lam in lambdas:
            p = problem.with_lam1(lam)
            # warm start: the residual comes from A_t when it is resident
            state = init_state(p, None, cfg)
            if x_warm is not None:
                if A_t is not None:
                    from convex_optimization_tpu.ops.matvec import (
                        ax_minus_b_t,
                    )

                    r_w = ax_minus_b_t(A_t, x_warm, p.b)
                else:
                    r_w = p.residual(x_warm)
                state = state._replace(x=x_warm, r=r_w, x_prev=x_warm,
                                       r_prev=r_w, x_best=x_warm)
            state = bcd(p, block_L, state, cfg, col_norms, A_t)
            x_warm = state.x_best
            xs.append(state.x_best)
            gaps.append(state.best_rel_gap)
            iters.append(state.k)
        gaps = jnp.stack(gaps)
        return PathResult(lambdas=lambdas, xs=jnp.stack(xs),
                          gaps=gaps, iters=jnp.stack(iters),
                          method_used=method, converged=gaps <= cfg.tol)

    L_total = spectral_norm_sq(problem.A) + problem.lam2

    if not compact:
        for lam in lambdas:
            p = problem.with_lam1(lam)
            state = init_state(p, x_warm, cfg)
            state = fista(p, L_total, state, cfg, col_norms)
            x_warm = state.x
            xs.append(state.x)
            gaps.append(state.rel_gap)
            iters.append(state.k)
        gaps = jnp.stack(gaps)
        return PathResult(lambdas=lambdas, xs=jnp.stack(xs),
                          gaps=gaps, iters=jnp.stack(iters),
                          method_used=method, converged=gaps <= cfg.tol)

    # --- compacting path ---
    from convex_optimization_tpu.core.objective import duality_gap, dual_witness

    n = problem.n
    is_group = problem.penalty.kind == "group_l2"
    gsize = n // problem.penalty.ngroups if is_group else 1
    ngroups = problem.penalty.ngroups if is_group else n
    gw_full = None
    if is_group:
        gw_full = problem.penalty.weights
        if gw_full is None:
            gw_full = jnp.ones((ngroups,), problem.dtype)
    x_warm = jnp.zeros((n,), problem.dtype)
    eps = float(np.finfo(np.float32).eps)
    m = problem.m
    gamma = (np.ceil(np.log2(max(m, 2))) + 4) * eps

    for lam in lambdas:
        p = problem.with_lam1(lam)
        # gap-safe screen AT THE WARM START for this lam, with f32
        # inflation (see solvers/polish.py for the bound)
        r = p.residual(x_warm)
        z = dual_witness(p, x_warm, r)
        info = duality_gap(p, x_warm, r, z=z)
        r_norm = jnp.linalg.norm(r)
        # the f32 gap carries the same O(log2(m) eps |primal|) reduction
        # error as the witnesses — inflate by gamma (matches polish_fast),
        # not a bare 4 eps (4.5x too small at m=10k: an unsafe discard)
        gap_safe = 1.25 * jnp.abs(info.gap) + gamma * jnp.abs(info.primal)
        # cushion covers the SOLVED point's witness too (the polish_fast
        # extension argument), so the compact certificate stays valid for
        # the full problem at this lam
        radius = (jnp.sqrt(2.0 * gap_safe)
                  + jnp.sqrt(2.0 * cfg.tol * jnp.abs(info.primal) * 1.5))
        if is_group:
            # group sphere test (round 3, closes the r2 NotImplementedError):
            # discard group g when ||(alpha z)_g|| + margin_g + radius
            # * ||cn_g|| < lam w_g — the screen_keep group bound with the
            # same cushioned radius; kept WHOLE groups keep gathers aligned
            wg = (info.alpha * z).reshape(ngroups, gsize)
            gn = jnp.linalg.norm(wg, axis=1)
            gcol = jnp.sqrt(jnp.sum(col_norms.reshape(ngroups, gsize) ** 2,
                                    axis=1))
            gmargin = info.alpha * gamma * r_norm * gcol
            gkeep = ~(gn + gmargin + radius * gcol < lam * gw_full)
            keep = jnp.repeat(gkeep, gsize)
        else:
            margin = gamma * col_norms * r_norm
            witness = jnp.abs(info.alpha * z) + info.alpha * margin
            keep = ~(witness + radius * col_norms < lam)
        keep_np = np.asarray(jax.device_get(keep))
        idx = np.nonzero(keep_np)[0]
        if is_group:
            # bucket in GROUP units so gathers stay group-aligned
            gidx = np.nonzero(np.asarray(jax.device_get(gkeep)))[0]
            g_b = -(-_bucket(len(gidx) * gsize, n) // gsize)
            if g_b > len(gidx):
                extra = np.setdiff1d(np.arange(ngroups),
                                     gidx)[:g_b - len(gidx)]
                gidx = np.sort(np.concatenate([gidx, extra]))
            idx = (gidx[:, None] * gsize + np.arange(gsize)).ravel()
        else:
            k_b = _bucket(len(idx), n)
            if k_b > len(idx):   # pad the bucket with arbitrary extra columns
                extra = np.setdiff1d(np.arange(n), idx)[:k_b - len(idx)]
                idx = np.sort(np.concatenate([idx, extra]))
        idx_dev = jnp.asarray(idx)

        import dataclasses

        pen_small = p.penalty.with_lam1(lam)
        if is_group:
            pen_small = dataclasses.replace(
                pen_small, ngroups=len(idx) // gsize,
                weights=gw_full[jnp.asarray(gidx)])
        p_small = dataclasses.replace(
            p, A=p.A[:, idx_dev],
            penalty=pen_small,
        )
        state = init_state(p_small, x_warm[idx_dev], cfg)
        state = fista(p_small, L_total, state, cfg,
                      col_norms[idx_dev] if col_norms is not None else None)
        x_full = jnp.zeros((n,), problem.dtype).at[idx_dev].set(state.x)
        x_warm = x_full
        xs.append(x_full)
        gaps.append(state.rel_gap)
        iters.append(state.k)
        kept.append(len(idx))

    gaps = jnp.stack(gaps)
    return PathResult(
        lambdas=lambdas, xs=jnp.stack(xs), gaps=gaps,
        iters=jnp.stack(iters), kept=jnp.asarray(kept),
        method_used="fista_compact", converged=gaps <= cfg.tol,
    )


def _lambda_path_sharded(problem, cfg, mesh, path_len, lam_min_frac,
                         lambdas, method: str = "fista"):
    """Column-sharded warm-started path: one compiled shard_map program for
    all path points (lam1 and the state are the only changing inputs).
    ``method`` picks the per-point solver — 'fista'/'ista' or
    'bcd'/'bcd_pallas' (per-chip fused Gauss-Seidel sweeps, Jacobi merged
    across chips; closes the round-2 FISTA-only asymmetry)."""
    import dataclasses

    from jax.sharding import NamedSharding, PartitionSpec as P

    from convex_optimization_tpu.ops.power_iter import (
        block_spectral_norms_sq,
        spectral_norm_sq,
    )
    from convex_optimization_tpu.parallel.mesh import BLOCKS, ROWS
    from convex_optimization_tpu.parallel.sharded import (
        _state_specs,
        sharded_bcd,
        sharded_fista,
    )
    from convex_optimization_tpu.solvers.bcd import pick_block_size

    if lambdas is None:
        lmax = lambda_max(problem.A, problem.b, problem.penalty)
        lambdas = jnp.geomspace(0.95 * lmax, lam_min_frac * lmax, path_len)
    lambdas = jnp.asarray(lambdas)

    if method not in ("fista", "ista", "bcd", "bcd_pallas"):
        # loud-failure convention: an unknown method must not silently run
        # sharded FISTA (ADVICE r4: that is exactly how mesh+bcd_batch
        # poisoned numbers before it had a real sharded route)
        raise ValueError(
            f"sharded lambda_path supports 'fista'/'ista'/'bcd'/"
            f"'bcd_pallas' (and 'bcd_batch' via its own route); "
            f"got {method!r}")
    rows_mesh = ROWS in mesh.axis_names and BLOCKS not in mesh.axis_names
    is_bcd = method in ("bcd", "bcd_pallas")
    if is_bcd:
        cfg = dataclasses.replace(cfg, use_pallas=(method == "bcd_pallas"))
    multiple = 1
    if problem.penalty.kind == "group_l2":
        multiple = problem.n // problem.penalty.ngroups

    if rows_mesh:
        from convex_optimization_tpu.parallel.row_sharded import (
            _state_specs_rows,
            sharded_bcd_rows,
            sharded_fista_rows,
        )

        n_shards = mesh.shape[ROWS]
        if problem.m % n_shards != 0:
            raise ValueError(
                f"m={problem.m} must divide over {n_shards} shards")
        A = jax.device_put(problem.A, NamedSharding(mesh, P(ROWS, None)))
        b = jax.device_put(problem.b, NamedSharding(mesh, P(ROWS)))
        sspecs = _state_specs_rows()
    else:
        n_shards = mesh.shape[BLOCKS]
        if problem.n % n_shards != 0:
            raise ValueError(
                f"n={problem.n} must divide over {n_shards} shards")
        A = jax.device_put(problem.A, NamedSharding(mesh, P(None, BLOCKS)))
        b = jax.device_put(problem.b, NamedSharding(mesh, P()))
        sspecs = _state_specs()
    problem = dataclasses.replace(problem, A=A, b=b)

    def make_state(xinit):
        s = init_state(problem, xinit, cfg)
        return jax.device_put(
            s,
            jax.tree.map(lambda sp: NamedSharding(mesh, sp), sspecs,
                         is_leaf=lambda v: isinstance(v, P)),
        )

    state = make_state(None)
    if is_bcd:
        bs = pick_block_size(
            problem.n if rows_mesh else problem.n // n_shards,
            cfg.block_size, multiple_of=multiple)
        block_L = block_spectral_norms_sq(problem.A, problem.n // bs)
        builder = sharded_bcd_rows if rows_mesh else sharded_bcd
        jfn, args = builder(problem, block_L, state, cfg, mesh)
    else:
        L_total = spectral_norm_sq(problem.A) + problem.lam2
        builder = sharded_fista_rows if rows_mesh else sharded_fista
        jfn, args = builder(problem, L_total, state, cfg, mesh)
    # args = (A, b, lam1, ..., state): every builder keeps lam1 at
    # LAM1_ARG_INDEX (asserted by check_lam1_slot at build time AND
    # re-verified here by object identity) — swap it (and the warm state)
    # per path point
    from convex_optimization_tpu.parallel.mesh import LAM1_ARG_INDEX as _LI

    assert args[_LI] is problem.penalty.lam1, (
        "builder args reordered: lam1 not at the λ-path swap index")
    xs, gaps, iters = [], [], []
    for lam in lambdas:
        out = jfn(*args[:_LI], lam, *args[_LI + 1:-1], state)
        state = make_state(out.x_best)      # warm start, reset counters
        xs.append(out.x_best)               # gap below describes THIS point
        gaps.append(out.best_rel_gap)
        iters.append(out.k)

    gaps = jnp.stack(gaps)
    return PathResult(
        lambdas=lambdas, xs=jnp.stack(xs), gaps=gaps,
        iters=jnp.stack(iters), method_used=f"{method}+sharded",
        converged=gaps <= cfg.tol,
    )
