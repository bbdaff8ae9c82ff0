"""Working-set solver (celer/BLITZ-style outer loop, SURVEY.md C11 taken to
its conclusion): solve restricted subproblems on the device and expand by
full-width KKT checks.

Why: at the 10k x 100k north star the full-width solvers stream all 4 GB of
A every sweep while gap-safe screening certifies ~93% of the columns zero
(VERDICT r2 Weak #3).  The working-set loop pays a few full passes (burn-in
+ screens + KKT checks) and runs the many remaining sweeps on a ~10x
smaller device-resident subproblem — per-sweep HBM traffic collapses
proportionally.

Round structure:
  0. a short full-width burn-in (decent x, honest gap estimate);
  1. gap-safe screen at x -> working set W (bucketed to stable sizes so
     each bucket shape compiles once);
  2. inner solve on A[:, W] (device gather; warm-started) to tol or stall
     — FISTA or Gauss-Seidel BCD sweeps (``inner=``);
  3. full-width dual check: z = A^T r.  Violations (|z_j| > lam1 for j
     outside W) are added and we repeat; otherwise the FULL-width gap at
     the expanded-back x is the honest result.

The final reported gap is always computed full-width, so correctness never
depends on the screen being tight — a loose screen only costs an extra
round.  All separable penalties plus group lasso (round 3): group working
sets are WHOLE groups — the screen, buckets, and A_t gathers stay
group-aligned and the compacted penalty carries the kept groups' weights.

TRANSPOSED-LAYOUT ROUTE.  Where the fused sweep can serve the problem
(ops/route.py: f32, a pad-free block width, device memory for the A_t copy;
on by default on the GPU, ``force_kernels=True`` elsewhere), every
full-size product reads the transposed block-major layout ``A_t``:

  * burn-in, screens, and KKT checks: `ax_minus_b_t` / `neg_at_r_t` on the
    full-width A_t;
  * bucket gathers: a row gather on A_t viewed as (n, m) — each original
    column is one CONTIGUOUS m-length row of the transposed layout, so the
    gather is a plain take, not a strided column gather;
  * compact solves: the gathered working set IS already in A_t layout, so
    the restricted FISTA/BCD runs on it directly (BCD through the fused
    sweep);
  * residuals are threaded between phases (init_state's ``r0``), so no
    compact program needs A itself.

The compacted Problem carries a NaN placeholder for ``A``: on this route
no compact program may trace ``problem.A`` (matvecs, witness, and residual
init all come from A_t / the threaded r0) — if a code path ever does, the
NaNs poison the result loudly instead of silently computing with wrong
data.

All jitted helpers live at module level so their compiled programs persist
across `solve_working_set` calls: a warm-started lambda path re-solving
overlapping supports pays each bucket shape's compile once per process.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

from convex_optimization_tpu.core.problem import Problem
from convex_optimization_tpu.core.objective import (
    dual_witness,
    duality_gap,
)
from convex_optimization_tpu.solvers.common import SolverConfig
from convex_optimization_tpu.solvers.fista import fista, init_state
from convex_optimization_tpu.ops.power_iter import spectral_norm_sq
from convex_optimization_tpu.ops import route as route_mod
from convex_optimization_tpu.ops.matvec import (
    ax_minus_b_t,
    block_power_t,
    neg_at_r_t,
    spectral_norm_sq_t,
    to_tblock_major,
)


def _bucket(k: int, n: int, bucket: int) -> int:
    return min(n, -(-max(k, 1) // bucket) * bucket)


def _kernel_route(problem: Problem, force_kernels: bool):
    """(A_t_full, B_full) when the transposed-layout route serves this
    problem's full-width programs, else (None, 0): on a GPU backend for
    float32 (``force_kernels`` turns it on elsewhere, e.g. for the CPU
    tests), with a pad-free (group-aligned) fused-sweep block and device
    memory for the A_t copy (ops/route.py)."""
    if not (force_kernels
            or route_mod.sweep_route(problem.dtype) == route_mod.CUDA):
        return None, 0
    multiple = (problem.n // problem.penalty.ngroups
                if problem.penalty.kind == "group_l2" else 1)
    picked = route_mod.pick_block_size(problem.m, problem.n, 128,
                                       multiple_of=multiple,
                                       dtype=problem.dtype)
    if picked is None or picked[1] != 0:
        return None, 0
    # A + A_t + the (<= bucketed working set) gathered slab
    if not route_mod.fits_device_memory(problem.m, problem.n, problem.dtype,
                                        copies=2.5):
        return None, 0
    B = picked[0]
    return to_tblock_major(problem.A, problem.n // B), B


# ---- module-level jitted helpers (compiled programs persist across
# solve_working_set calls: lambda paths reuse every bucket shape) ----

_spec_t_j = jax.jit(spectral_norm_sq_t)
_block_power_j = jax.jit(block_power_t)
_resid_t_j = jax.jit(lambda a_t, x, b: ax_minus_b_t(a_t, x, b))
_init_j = jax.jit(init_state, static_argnames="cfg")
_gather_cols = jax.jit(lambda A, idx: A[:, idx])
_gather_vec = jax.jit(lambda x, idx: x[idx])


@functools.partial(jax.jit, static_argnames=("n",))
def _scatter_vec(xs, idx, n):
    return jnp.zeros((n,), xs.dtype).at[idx].set(xs)


@functools.partial(jax.jit, static_argnames=("nb", "bs"))
def _gather_t(view, idx, nb, bs):
    """Compact slab in A_t layout: row c of the (n, m) view IS column c of
    A, contiguous (to_tblock_major ordering)."""
    return view[idx].reshape(nb, bs, view.shape[1])


def _keep_and_info(problem, x, r, z):
    cn = problem.col_norms()
    info = duality_gap(problem, x, r, z=z)
    keep = problem.penalty.screen_keep(
        z, info.alpha, info.gap, cn,
        r_norm=jnp.sqrt(jnp.vdot(r, r)), primal=info.primal)
    return keep | (x != 0), info               # never drop active coords


@jax.jit
def _screen_kernel_j(problem, x, A_t):
    r = ax_minus_b_t(A_t, x, problem.b)
    z = neg_at_r_t(A_t, r, x, problem.lam2)
    keep, info = _keep_and_info(problem, x, r, z)
    return keep, info, r


@jax.jit
def _screen_xla_j(problem, x):
    r = problem.residual(x)
    z = dual_witness(problem, x, r)
    keep, info = _keep_and_info(problem, x, r, z)
    return keep, info, r


def make_ws_route(problem: Problem, force_kernels: bool = False) -> dict:
    """Precompute the lam-independent pieces of the working-set solver —
    the transposed layout (or None off the kernel route) and the spectral
    norm — for reuse across solve_working_set calls on the same A (lambda
    paths pass this as ``route=``).  The full-width block-Lipschitz vector
    (bcd burn-ins) is filled in lazily on first use and cached in the same
    dict — also lam-independent, and a full pass over A per computation."""
    A_t_full, _ = _kernel_route(problem, force_kernels)
    L_total = (_spec_t_j(A_t_full) if A_t_full is not None
               else spectral_norm_sq(problem.A)) + problem.lam2
    return {"A_t": A_t_full, "L_total": L_total, "block_L": None}


def solve_working_set(problem: Problem, cfg: SolverConfig, *,
                      x0: Optional[jax.Array] = None,
                      init_iters: int = 100, bucket: int = 2048,
                      max_rounds: int = 8, inner: str = "fista",
                      force_kernels: bool = False,
                      route=None):
    """Returns (x_full, final GapInfo, wall breakdown dict).

    Used by api.solve(method='fista_ws' | 'bcd_ws').  ``inner`` picks the
    restricted solver: 'fista' (momentum, reuses the full-width L as a
    sound Lipschitz bound — one program per bucket) or 'bcd' (Gauss-Seidel
    sweeps via the fused sweep — fewer sweeps to the f32 floor, plus
    one per-bucket block-Lipschitz program).  'bcd' requires the kernel
    route; buckets fall back to 'fista' where its block gate fails.

    ``route``: a make_ws_route dict from a previous call on the SAME A
    (lambda paths: the relayout, spectral norm, and block-Lipschitz vector
    are lam-independent, so the path computes them once and every point
    reuses them along with all compiled bucket programs).
    """
    n, m = problem.n, problem.m
    # group lasso (round 3): working sets are WHOLE groups — screens,
    # buckets, and gathers all stay group-aligned, and the compacted
    # penalty carries the kept groups' weights
    gsize = (n // problem.penalty.ngroups
             if problem.penalty.kind == "group_l2" else 1)
    # adaptive bucket: 2048 is right at the 100k north star but rounds a
    # 55-column working set up to ALL of a n=2000 problem (the full-width
    # fallback then burns max_iters — measured on the config1 CI path).
    # Multiples of 128 keep every bucket VPU-block-eligible.
    bucket = min(bucket, max(128, (n // 8) // 128 * 128))
    t0 = time.perf_counter()

    def _group_align(idx):
        """Expand a column index set to whole groups (sorted)."""
        if gsize == 1 or len(idx) == 0:
            return idx
        g = np.unique(idx // gsize)
        return (g[:, None] * gsize + np.arange(gsize)).ravel()

    if route is None:
        route = make_ws_route(problem, force_kernels)
    A_t_full, L_total = route["A_t"], route["L_total"]

    if A_t_full is not None:
        A_t_view = A_t_full.reshape(n, m)

        def screen(x):
            keep, info, r = _screen_kernel_j(problem, x, A_t_full)
            idx = np.nonzero(np.asarray(jax.device_get(keep)))[0]
            return _group_align(idx), info, r
    else:
        def screen(x):
            keep, info, r = _screen_xla_j(problem, x)
            idx = np.nonzero(np.asarray(jax.device_get(keep)))[0]
            return _group_align(idx), info, r

    def _compact_block(k_b: int) -> int:
        """Largest fused-sweep (group-aligned) block size for a
        k_b-column compact slab (0 if none: XLA fallback for that
        bucket)."""
        picked = route_mod.pick_block_size(m, k_b, 128, multiple_of=gsize,
                                           dtype=problem.dtype)
        if picked is None or picked[1] != 0:
            return 0
        return picked[0]

    def _compact_penalty(idx):
        """Penalty for the compacted problem (kept groups' weights)."""
        if gsize == 1:
            return problem.penalty
        gsel = idx[::gsize] // gsize
        w = problem.penalty.weights
        return dataclasses.replace(
            problem.penalty, ngroups=len(idx) // gsize,
            weights=None if w is None else w[jnp.asarray(gsel)])

    # phase 0: ADAPTIVE full-width burn-in — the screen only bites once the
    # gap is moderate, so take full-width batches (ONE static config =
    # one compiled program, called repeatedly with warm starts) until the
    # working set would actually shrink the problem.  The running residual
    # is threaded into every init (r0), so warm starts never trace the
    # A @ x dot.
    cfg0 = dataclasses.replace(cfg, max_iters=init_iters,
                               gap_every=min(cfg.gap_every, init_iters),
                               stall_checks=0, screen_every=0)
    if inner == "bcd" and A_t_full is not None:
        # GS burn-in: the fused sweep reads A ONCE per sweep (vs FISTA's 2
        # passes/iteration) and converges faster per pass — the burn-in is
        # the full-width cost of this solver, so burn with the cheaper unit
        from convex_optimization_tpu.solvers.bcd import bcd

        if route["block_L"] is None:
            route["block_L"] = _block_power_j(A_t_full)
        block_L_full = route["block_L"]
        cfg0b = dataclasses.replace(cfg0, use_pallas=True)

        def burn(st):
            return bcd(problem, block_L_full, st, cfg0b, None, A_t_full)
    else:
        def burn(st):
            return fista(problem, L_total, st, cfg0, None, A_t_full)

    if x0 is None:
        x = jnp.zeros((n,), problem.dtype)
        r_cur = -problem.b
    else:
        x = x0
        r_cur = (_resid_t_j(A_t_full, x, problem.b)
                 if A_t_full is not None else None)
    total_inner = 0
    idx_np, info, r_full = None, None, None
    t_setup = time.perf_counter() - t0
    for _burn in range(10):
        st = (_init_j(problem, x, cfg0, r0=r_cur) if r_cur is not None
              else _init_j(problem, x, cfg0))
        s = burn(st)
        x, r_cur = s.x, s.r
        total_inner += int(s.k)
        idx_np, info, r_full = screen(x)
        if bool(info.rel_gap <= cfg.tol) or len(idx_np) <= 0.6 * n:
            break
    t_burn = time.perf_counter() - t0 - t_setup

    rounds = 0
    prev_gap = float("inf")
    for rounds in range(1, max_rounds + 1):
        g = float(info.rel_gap)
        if g <= cfg.tol or g > 0.9 * prev_gap:
            break      # converged, or stalled at the f32 floor
        prev_gap = g
        k_b = _bucket(len(idx_np), n, bucket)
        if gsize > 1:
            k_b = min(n, -(-k_b // gsize) * gsize)    # whole groups
        if k_b >= n:
            # working set is everything: fall back to the plain solve
            # (with stall detection: the full-width f32 floor can sit just
            # above tol, and the final screen recomputes the honest gap)
            cfgf = dataclasses.replace(cfg, screen_every=0,
                                       stall_checks=cfg.stall_checks or 5)
            st = (_init_j(problem, x, cfgf, r0=r_full)
                  if A_t_full is not None else _init_j(problem, x, cfgf))
            s = fista(problem, L_total, st, cfgf, None, A_t_full)
            x = s.x_best
            total_inner += int(s.k)
            # refresh idx_np too: meta['ws_size'] must describe the FINAL
            # state, not the pre-fallback working set
            idx_np, info, r_full = screen(x)
            break
        if k_b > len(idx_np):
            if gsize > 1:
                kept_g = np.unique(idx_np // gsize) if len(idx_np) else \
                    np.empty((0,), np.int64)
                extra_g = np.setdiff1d(np.arange(n // gsize), kept_g)[
                    :(k_b - len(idx_np)) // gsize]
                extra = (extra_g[:, None] * gsize
                         + np.arange(gsize)).ravel()
            else:
                extra = np.setdiff1d(np.arange(n),
                                     idx_np)[:k_b - len(idx_np)]
            idx_np = np.sort(np.concatenate([idx_np, extra]))
        idx = jnp.asarray(idx_np)
        # compact solves always get stall detection: they bottom out at the
        # f32 noise floor of the SUBPROBLEM, and the honest full-width
        # re-screen follows anyway — burning max_iters there is pure waste
        # (measured: 10k iters on a 55-column bucket at tol=1e-6)
        cfg_ws = dataclasses.replace(cfg, screen_every=0,
                                     stall_checks=cfg.stall_checks or 5)

        b_ws = _compact_block(k_b) if A_t_full is not None else 0
        if b_ws:
            # device-resident compact solve in A_t layout
            A_t_ws = _gather_t(A_t_view, idx, nb=k_b // b_ws, bs=b_ws)
            # NaN placeholder: no compact program on this route may trace
            # problem.A (see module docstring).  A TINY stand-in + static
            # shape_override instead of a real (m, k_b) NaN buffer, which
            # would cost another slab of device memory
            p_ws = dataclasses.replace(
                problem, A=jnp.full((8, 8), jnp.nan, problem.dtype),
                shape_override=(m, k_b),
                penalty=_compact_penalty(idx_np))
            # r_full from the screen equals A[:,W] x_W - b exactly (x is 0
            # off W), so the warm init needs no residual matvec
            st0 = _init_j(p_ws, _gather_vec(x, idx), cfg_ws, r0=r_full)
            if inner == "bcd":
                from convex_optimization_tpu.solvers.bcd import bcd

                cfg_b = dataclasses.replace(cfg_ws, use_pallas=True)
                block_L = _block_power_j(A_t_ws)
                s_ws = bcd(p_ws, block_L, st0, cfg_b, None, A_t_ws)
            else:
                s_ws = fista(p_ws, L_total, st0, cfg_ws, None, A_t_ws)
        else:
            # plain route (f64, no eligible block, or the route is off)
            p_ws = dataclasses.replace(problem,
                                       A=_gather_cols(problem.A, idx),
                                       penalty=_compact_penalty(idx_np))
            s_ws = fista(p_ws, L_total,
                         _init_j(p_ws, _gather_vec(x, idx), cfg_ws),
                         cfg_ws, None)
        total_inner += int(s_ws.k)
        x = _scatter_vec(s_ws.x_best, idx, n)
        # full-width re-screen + honest gap for the next round / the result
        idx_np, info, r_full = screen(x)

    wall = time.perf_counter() - t0
    return x, info, {"rounds": rounds, "inner_iters": total_inner,
                     "wall_s": wall, "setup_s": t_setup, "burn_s": t_burn,
                     "kernel_routed": A_t_full is not None,
                     "ws_size": int(len(idx_np)) if idx_np is not None
                     else n}
