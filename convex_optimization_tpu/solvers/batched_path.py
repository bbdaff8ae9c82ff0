"""Batched-lambda path solver: all path points iterate SIMULTANEOUSLY
against one streamed read of A per sweep (the batched fused sweep,
ops/bcd_sweep.py).

The sequential warm-started path (solvers/lambda_path.py) pays one
pass of A per sweep per point; its total cost is sum_k sweeps(lam_k)
passes.  This solver runs cyclic Gauss-Seidel block prox on an (L, n) batch
of iterates — every lambda in the grid at once, each with its own
threshold — so the total cost is max_k sweeps(lam_k) passes: the deep
points' sweeps carry every other point for free.  Points start cold, but an
IN-JIT CASCADE WARM START recovers most of the sequential path's
warm-start benefit: at every gap check, each point adopts its larger-lambda
neighbor's iterate whenever that iterate is primal-better at its own lambda
(evaluated for free from the already-reduced parts; GS prox descent is
monotone from any start, so adoption is always sound).  Certification
semantics match lambda_path: per-point f32 duality-gap certificates with
best-iterate tracking and stall detection at the f32 floor.

Every program in the solve reads the transposed layout A_t (batched sweep,
batched exact refresh, batched witness, block power iteration).

Usage: ``batched_lambda_path(problem, cfg, path_len=10)`` — a drop-in for
``lambda_path`` returning the same PathResult shape (per-point solutions,
gaps, iteration counts).
"""

from __future__ import annotations

import functools
import warnings
from typing import NamedTuple

import jax
import jax.numpy as jnp

from convex_optimization_tpu.core.problem import Problem
from convex_optimization_tpu.core.objective import gap_from_parts, lambda_max
from convex_optimization_tpu.solvers.common import SolverConfig
from convex_optimization_tpu.solvers.lambda_path import PathResult
from convex_optimization_tpu.ops import route as route_mod
from convex_optimization_tpu.ops.bcd_sweep import batch_sweep
from convex_optimization_tpu.ops.matvec import (
    ax_minus_b_batch_t,
    block_power_t,
    neg_at_r_batch_t,
    to_tblock_major,
)
from convex_optimization_tpu.ops.route import MAX_BATCH


class _BatchState(NamedTuple):
    X: jax.Array            # (n_blocks, L, B) iterates
    R: jax.Array            # (L, m) residuals
    X_best: jax.Array       # (n_blocks, L, B) best-certified iterates
    R_best: jax.Array       # (L, m) EXACT residual at X_best (the gap
                            # check refreshes R right before certifying, so
                            # storing it here gives chunk warm starts a free
                            # residual — no extra refresh program)
    best_gap: jax.Array     # (L,)
    best_rel: jax.Array     # (L,)
    best_primal: jax.Array  # (L,)
    iters_done: jax.Array   # (L,) sweep count when each point was best
    since_best: jax.Array   # (L,) gap checks without a new best
    k: jax.Array            # () total sweeps run


def _penalty_parts(kind: str, gsize: int, weights, X, Z):
    """Per-lambda base penalty value and base dual norm (lam1 factored
    out): value_l = lam1_l * base_val_l, dual_norm_l = base_dual_l / lam1_l.
    X, Z are (n_blocks, L, B)."""
    if kind == "l1":
        base_val = jnp.sum(jnp.abs(X), axis=(0, 2))
        base_dual = jnp.max(jnp.abs(Z), axis=(0, 2))
    elif kind == "nonneg_l1":
        base_val = jnp.sum(X, axis=(0, 2))           # X >= 0 by prox
        base_dual = jnp.maximum(jnp.max(Z, axis=(0, 2)), 0.0)
    elif kind == "group_l2":
        nb, L, B = X.shape
        gpb = B // gsize
        Xg = X.reshape(nb, L, gpb, gsize)
        Zg = Z.reshape(nb, L, gpb, gsize)
        w = weights.reshape(nb, 1, gpb)
        gn_x = jnp.sqrt(jnp.sum(Xg * Xg, axis=3))    # (nb, L, gpb)
        gn_z = jnp.sqrt(jnp.sum(Zg * Zg, axis=3))
        base_val = jnp.sum(w * gn_x, axis=(0, 2))
        base_dual = jnp.max(gn_z / w, axis=(0, 2))
    else:
        raise ValueError(f"unknown penalty kind {kind!r}")
    return base_val, base_dual


def _init_batch_state(nb, B, m, L, b, x0, r0, dtype, rm=None):
    """Cold (zeros / -b) or warm (broadcast x0/r0 over L) initial state.
    nb is shard-LOCAL under shard_map; x0 (nb, B) / r0 (m,).  With a row
    mask ``rm`` the cold residual is the MASKED -b (the masked-problem
    invariant: residual rows stay rm ⊙ (Ax - b) throughout); a warm r0
    must already be masked (it always is — it comes from a masked run's
    R_best)."""
    if x0 is None:
        X0 = jnp.zeros((nb, L, B), dtype)
        b_eff = b if rm is None else rm * b
        R0 = jnp.broadcast_to(-b_eff[None, :], (L, m)).astype(dtype)
    else:
        X0 = jnp.broadcast_to(x0[:, None, :], (nb, L, B)).astype(dtype)
        R0 = jnp.broadcast_to(r0[None, :], (L, m)).astype(dtype)
    inf = jnp.full((L,), jnp.inf, dtype)
    return _BatchState(
        X=X0, R=R0, X_best=X0, R_best=R0, best_gap=inf, best_rel=inf,
        best_primal=inf, iters_done=jnp.zeros((L,), jnp.int32),
        since_best=jnp.zeros((L,), jnp.int32),
        k=jnp.zeros((), jnp.int32))


def _run_batched_loop(state0, lam1s, cfg: SolverConfig, sweep_once,
                      gap_check):
    """The batched-path while_loop shared by the single-card and sharded
    solvers: gap_every sweeps -> certify -> best-iterate tracking ->
    cascade warm start.  sweep_once(X, R) -> (X, R);
    gap_check(X, R) -> (R_exact, GapInfo over (L,), rho_aug, base_val)."""
    L = lam1s.shape[0]

    def body(state):
        X, R = jax.lax.fori_loop(
            0, cfg.gap_every, lambda _, c: sweep_once(*c),
            (state.X, state.R))
        R, info, rho_aug, base_val = gap_check(X, R)
        k = state.k + cfg.gap_every
        improved = info.rel_gap < state.best_rel
        sel = improved[None, :, None]
        X_best = jnp.where(sel, X, state.X_best)
        R_best = jnp.where(improved[:, None], R, state.R_best)
        best_rel = jnp.where(improved, info.rel_gap, state.best_rel)
        best_gap = jnp.where(improved, info.gap, state.best_gap)
        best_primal = jnp.where(improved, info.primal, state.best_primal)
        iters_done = jnp.where(improved, k, state.iters_done)
        since_best = jnp.where(improved, 0, state.since_best + 1)

        # cascade warm start (the in-batch analog of the sequential path's
        # warm starts): point l adopts point l-1's CURRENT iterate whenever
        # that iterate is primal-better AT lam_l.  Evaluating the neighbor
        # at lam_l is free — P_l(x_{l-1}) = 0.5*rho_aug_{l-1}
        # + lam1_l * base_val_{l-1} from the parts already reduced.  GS
        # block prox is monotone from any start, so adoption never hurts;
        # the deep (small-lambda) points inherit the shallow solutions as
        # those converge instead of grinding from 0 (measured in rehearsal:
        # the cold deep tail dominated total sweeps).  lambdas DESCEND, so
        # the shift direction is l-1 -> l.
        prev_aug = jnp.concatenate([rho_aug[:1], rho_aug[:-1]])
        prev_val = jnp.concatenate([base_val[:1], base_val[:-1]])
        primal_of_prev = 0.5 * prev_aug + lam1s * prev_val
        not_first = jnp.arange(L) > 0
        adopt = (primal_of_prev < info.primal) & not_first \
            & (state.best_rel > cfg.tol)
        X = jnp.where(adopt[None, :, None],
                      jnp.concatenate([X[:, :1], X[:, :-1]], axis=1), X)
        R = jnp.where(adopt[:, None],
                      jnp.concatenate([R[:1], R[:-1]], axis=0), R)

        return _BatchState(X=X, R=R, X_best=X_best, R_best=R_best,
                           best_gap=best_gap,
                           best_rel=best_rel, best_primal=best_primal,
                           iters_done=iters_done, since_best=since_best,
                           k=k)

    def cond(state):
        converged = state.best_rel <= cfg.tol
        stalled = (state.since_best >= cfg.stall_checks
                   if cfg.stall_checks > 0
                   else jnp.zeros_like(converged))
        done = jnp.all(converged | stalled)
        return (state.k < cfg.max_iters) & ~done

    return jax.lax.while_loop(cond, body, state0)


@functools.partial(jax.jit,
                   static_argnames=("kind", "gsize", "cfg", "route"))
def _solve_batched(A_t, b, lam1s, lam2, steps, weights, state0, rm, *,
                   kind, gsize, cfg: SolverConfig, route):
    """The single jitted batched-path program.  Warm starts are encoded
    in ``state0`` by the caller (_init_batch_state).  rm (m,) solves the ROW-MASKED problem
    (rm ⊙ A, rm ⊙ b) against the same resident A — the mask gates the
    kernel's residual updates and the refresh, and every gap quantity is
    then automatically the masked problem's (R stays masked, so A^T R,
    ||R||^2 and R·b are exactly the masked-problem values)."""
    n_blocks, B, m = A_t.shape
    L = lam1s.shape[0]
    dtype = A_t.dtype
    w_flat = (weights if kind == "group_l2"
              else jnp.zeros((n_blocks, 1, 1), dtype))

    def sweep_once(X, R):
        return batch_sweep(A_t, X, R, steps, lam1s, lam2, kind=kind,
                           gsize=gsize, weights=w_flat, row_mask=rm,
                           route=route)

    def gap_check(X, R):
        # exact refresh pins the incremental residual drift, then one
        # batched witness pass; gap_from_parts broadcasts over (L,)
        R = ax_minus_b_batch_t(A_t, X, b)
        if rm is not None:
            R = rm[None, :] * R       # rm⊙(AX - b): tiny fused (L, m) op
        Z = neg_at_r_batch_t(A_t, R, X, lam2)
        base_val, base_dual = _penalty_parts(kind, gsize, weights, X, Z)
        rho_aug = (jnp.sum(R * R, axis=1)
                   + lam2 * jnp.sum(X * X, axis=(0, 2)))
        # <rho, b> = <b - Ax, b> = ||b||^2 - <r + b, b> = -<r, b>
        rho_dot_b = -jnp.dot(R, b, precision=jax.lax.Precision.HIGHEST)
        info = gap_from_parts(
            rho_dot_b=rho_dot_b,
            rho_aug_sq=rho_aug,
            g_value=lam1s * base_val,
            dual_norm_value=base_dual / jnp.maximum(lam1s, 1e-30),
        )
        return R, info, rho_aug, base_val

    return _run_batched_loop(state0, lam1s, cfg, sweep_once, gap_check)


def _base_val_diff(kind: str, gsize: int, weights, X, Xn):
    """Per-lambda base-penalty difference sum(base(Xn) - base(X)), reduced
    elementwise-diff-then-sum: an f32 difference of two large sums cancels
    catastrophically and deadlocks the sharded line search (the
    sharded_bcd value_diff note, parallel/sharded.py)."""
    if kind == "l1":
        return jnp.sum(jnp.abs(Xn) - jnp.abs(X), axis=(0, 2))
    if kind == "nonneg_l1":
        return jnp.sum(Xn - X, axis=(0, 2))         # X, Xn >= 0 by prox
    nb, L, B = X.shape
    gpb = B // gsize
    w = weights.reshape(nb, 1, gpb)
    gn_n = jnp.sqrt(jnp.sum(Xn.reshape(nb, L, gpb, gsize) ** 2, axis=3))
    gn_o = jnp.sqrt(jnp.sum(X.reshape(nb, L, gpb, gsize) ** 2, axis=3))
    return jnp.sum(w * (gn_n - gn_o), axis=(0, 2))


def _setup_sharded(problem: Problem, cfg: SolverConfig, mesh, B: int,
                   n_blocks: int, multiple: int, route: str):
    """Column-sharded batched-path programs.

    Layout: A_t slabs (nb_loc, B, m) one per card over mesh axis 'blocks';
    X / X_best shard with the blocks; R / R_best (L, m) replicated.  Each
    sweep every card streams its OWN slab once for ALL L grid points
    (Gauss-Seidel within the slab), then one (L, m) psum merges the
    residual deltas.  Summing the cards' deltas is Jacobi across cards and
    can overshoot when slabs correlate, so the merged direction gets the
    same exact per-lambda line search + 1/p Jacobi floor as sharded_bcd
    (parallel/sharded.py) — monotone descent per point, gamma -> 1 as
    cross-card interference vanishes.  The per-card sweep, refresh, witness
    and power iteration all run on the local slab."""
    from jax import lax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from convex_optimization_tpu.parallel.mesh import BLOCKS

    n_shards = mesh.shape[BLOCKS]
    kind = problem.penalty.kind
    lam2 = problem.lam2
    dtype = problem.dtype
    m = problem.m

    A_t = jax.device_put(to_tblock_major(problem.A, n_blocks),
                         NamedSharding(mesh, P(BLOCKS, None, None)))
    b = jax.device_put(problem.b, NamedSharding(mesh, P()))
    # per-block Lipschitz by power iteration, run per card on its own slab
    # under shard_map (block Lipschitz is block-local)
    blockL = jax.jit(jax.shard_map(
        block_power_t, mesh=mesh, in_specs=P(BLOCKS, None, None),
        out_specs=P(BLOCKS), check_vma=False))(A_t)
    steps = (cfg.step_scale / (blockL + lam2)).astype(dtype)
    weights = None
    if kind == "group_l2":
        weights = jax.device_put(
            problem.penalty._gweights(dtype).reshape(n_blocks, 1,
                                                     B // multiple),
            NamedSharding(mesh, P(BLOCKS, None, None)))

    bspec = P(BLOCKS, None, None)
    sspec = _BatchState(
        X=bspec, R=P(), X_best=bspec, R_best=P(), best_gap=P(),
        best_rel=P(), best_primal=P(), iters_done=P(), since_best=P(),
        k=P())
    w_spec = bspec if kind == "group_l2" else P()
    w_dummy = (weights if weights is not None
               else jnp.zeros((1, 1, 1), dtype))

    def local_solve(A_loc, b, lam1s, steps_loc, w_loc, state0, rm):
        w_pen = w_loc if kind == "group_l2" else None
        zeros_b = jnp.zeros((m,), dtype)

        def sweep_once(X, R):
            Xn, Rv = batch_sweep(A_loc, X, R, steps_loc, lam1s, lam2,
                                 kind=kind, gsize=multiple, weights=w_pen,
                                 row_mask=rm, route=route)
            dX = Xn - X
            dR = lax.psum(Rv - R, BLOCKS)                        # (L, m)
            # exact per-lambda line search on the aggregated direction
            # (same derivation as sharded_bcd, per path point): for
            # gamma in [0,1], P_l(X + g dX) <= 0.5||R_l + g dR_l||^2
            # (+ lam2 part) + (1-g) G_l(X) + g G_l(Xn), minimized in
            # closed form; floor at 1/p = always-monotone Jacobi average
            lin = (jnp.sum(R * dR, axis=1)
                   + lam2 * lax.psum(jnp.sum(X * dX, axis=(0, 2)), BLOCKS))
            den = (jnp.sum(dR * dR, axis=1)
                   + lam2 * lax.psum(jnp.sum(dX * dX, axis=(0, 2)), BLOCKS))
            dG = lam1s * lax.psum(
                _base_val_diff(kind, multiple, w_pen, X, Xn), BLOCKS)
            gamma_ls = jnp.clip(-(lin + dG) / jnp.maximum(den, 1e-30),
                                0.0, 1.0)
            gamma = jnp.maximum(gamma_ls, 1.0 / n_shards)
            return X + gamma[None, :, None] * dX, R + gamma[:, None] * dR

        def gap_check(X, R):
            # exact refresh: per-chip partial A_loc X_loc (b = 0 in the
            # kernel), one (L, m) psum, THEN subtract b exactly once
            Rp = ax_minus_b_batch_t(A_loc, X, zeros_b)
            R = lax.psum(Rp, BLOCKS) - b[None, :]
            if rm is not None:
                R = rm[None, :] * R   # masked problem: R = rm⊙(AX - b)
            Z = neg_at_r_batch_t(A_loc, R, X, lam2)
            bv_loc, bd_loc = _penalty_parts(kind, multiple, w_pen, X, Z)
            base_val = lax.psum(bv_loc, BLOCKS)
            base_dual = lax.pmax(bd_loc, BLOCKS)
            rho_aug = (jnp.sum(R * R, axis=1)
                       + lam2 * lax.psum(jnp.sum(X * X, axis=(0, 2)),
                                         BLOCKS))
            rho_dot_b = -jnp.dot(R, b, precision=lax.Precision.HIGHEST)
            info = gap_from_parts(
                rho_dot_b=rho_dot_b,
                rho_aug_sq=rho_aug,
                g_value=lam1s * base_val,
                dual_norm_value=base_dual / jnp.maximum(lam1s, 1e-30),
            )
            return R, info, rho_aug, base_val

        return _run_batched_loop(state0, lam1s, cfg, sweep_once, gap_check)

    programs: dict = {}

    def init_state(lam_c, x_warm, r_warm, rm):
        """Eager sharded _BatchState: X/X_best ride the blocks axis, the
        (L, m) residual rows are replicated — tiny arrays, built once per
        chunk."""
        L = int(lam_c.shape[0])
        if x_warm is None:
            X0 = jnp.zeros((n_blocks, L, B), dtype)
            b_eff = b if rm is None else rm * b
            R0 = jnp.broadcast_to(-b_eff[None, :], (L, m)).astype(dtype)
        else:
            X0 = jnp.broadcast_to(x_warm[:, None, :],
                                  (n_blocks, L, B)).astype(dtype)
            R0 = jnp.broadcast_to(r_warm[None, :], (L, m)).astype(dtype)
        X0 = jax.device_put(X0, NamedSharding(mesh, bspec))
        rep = NamedSharding(mesh, P())
        R0 = jax.device_put(R0, rep)
        inf = jax.device_put(jnp.full((L,), jnp.inf, dtype), rep)
        zi = jax.device_put(jnp.zeros((L,), jnp.int32), rep)
        return _BatchState(
            X=X0, R=R0, X_best=X0, R_best=R0, best_gap=inf, best_rel=inf,
            best_primal=inf, iters_done=zi, since_best=zi,
            k=jax.device_put(jnp.zeros((), jnp.int32), rep))

    def solve_chunk(lam_c, x_warm, r_warm, rm=None):
        Lc = int(lam_c.shape[0])
        masked = rm is not None
        key = (Lc, masked)
        if key not in programs:
            base = (bspec, P(), P(), P(BLOCKS), w_spec, sspec)
            rm_specs = (P(),) if masked else ()

            def fn(A_loc, b_, lam1s, steps_loc, w_loc, state_loc, *rest):
                rm_ = rest[0] if masked else None
                return local_solve(A_loc, b_, lam1s, steps_loc, w_loc,
                                   state_loc, rm_)

            # check_vma=False: the kernel's foreign-function outputs carry
            # no vma, so the VMA checker rejects it inside shard_map; the
            # sharded == unsharded equivalence test is the correctness guard
            # (same rule as sharded_bcd's fused slabs)
            programs[key] = jax.jit(jax.shard_map(
                fn, mesh=mesh, in_specs=base + rm_specs,
                out_specs=sspec, check_vma=False))
        rm_args = ((jnp.asarray(rm, dtype),) if masked else ())
        return programs[key](A_t, b, lam_c, steps, w_dummy,
                             init_state(lam_c, x_warm, r_warm, rm), *rm_args)

    return solve_chunk, A_t


def _batch_gate_reason(problem: Problem, picked, chunk: int,
                       n_shards: int = 1) -> str | None:
    """None when the batched sweep can run; else a human-readable reason
    (gate failures must be observable)."""
    n_loc = problem.n // n_shards
    if picked is None or picked[1] != 0:
        return (f"no pad-free fused-sweep block for (m={problem.m}, "
                f"n={problem.n}, {jnp.dtype(problem.dtype).name})")
    gsize = (problem.n // problem.penalty.ngroups
             if problem.penalty.kind == "group_l2" else 1)
    reason = route_mod.sweep_gate(problem.m, n_loc, picked[0], chunk,
                                  problem.dtype, gsize)
    if reason is not None:
        return f"L={chunk}: {reason}"
    # the hoisted A_t is a second persistent full-size copy next to A
    if not route_mod.fits_device_memory(problem.m, n_loc, problem.dtype,
                                        copies=2):
        return (f"A + hoisted A_t exceed the per-card memory budget "
                f"(m={problem.m}, n_local={n_loc})")
    return None


class PreparedBatch(NamedTuple):
    """One-time batched-solver setup, reusable across grids and row masks
    (K-fold CV: ONE A_t hoist + block power iteration + program cache
    serves all k fold paths and the full-data refit)."""
    solve_chunk: object       # (lam_c, x_warm, r_warm, rm) -> _BatchState
    A_t: object               # hoisted (n_blocks, B, m) layout
    B: int
    n_blocks: int
    reason: str | None        # not None => gate failed, solve_chunk None
    route: str                # sweep implementation (ops/route.py)


def prepare_batched_solver(
    problem: Problem,
    cfg: SolverConfig,
    *,
    mesh: jax.sharding.Mesh | None = None,
    chunk: int = MAX_BATCH,
) -> PreparedBatch:
    """Gate + hoist for the batched path (ops/route.py picks the sweep
    implementation).  Gating at chunk=MAX_BATCH is conservative for any
    smaller chunk.  When the gate fails, returns reason with
    solve_chunk=None (callers fall back loudly)."""
    multiple = 1
    if problem.penalty.kind == "group_l2":
        multiple = problem.n // problem.penalty.ngroups
    n_shards = 1
    if mesh is not None:
        from convex_optimization_tpu.parallel.mesh import BLOCKS

        n_shards = mesh.shape[BLOCKS]
    picked = route_mod.pick_block_size(problem.m, problem.n, 128,
                                       multiple_of=multiple, L=chunk,
                                       dtype=problem.dtype)
    reason = _batch_gate_reason(problem, picked, chunk, n_shards)
    if reason is None and (problem.n // picked[0]) % n_shards != 0:
        reason = (f"n_blocks={problem.n // picked[0]} does not divide over "
                  f"{n_shards} shards")
    route = route_mod.sweep_route(problem.dtype)
    if reason is not None:
        return PreparedBatch(None, None, 0, 0, reason, route)

    B = picked[0]
    n_blocks = problem.n // B

    if mesh is not None:
        solve_chunk, A_t = _setup_sharded(problem, cfg, mesh, B, n_blocks,
                                          multiple, route)
    else:
        A_t = to_tblock_major(problem.A, n_blocks)
        block_L = jax.jit(block_power_t)(A_t)
        # full-data block Lipschitz: a row mask only REMOVES rows, so the
        # full-data L upper-bounds every masked block's L — masked solves
        # take (slightly) conservative, always-sound steps with no
        # per-fold power iteration
        steps = (cfg.step_scale / (block_L + problem.lam2)).astype(
            problem.dtype)
        weights = None
        if problem.penalty.kind == "group_l2":
            weights = problem.penalty._gweights(problem.dtype).reshape(
                n_blocks, 1, B // multiple)

        def solve_chunk(lam_c, x_warm, r_warm, rm=None):
            state = _init_batch_state(
                n_blocks, B, problem.m, int(lam_c.shape[0]), problem.b,
                x_warm, r_warm, problem.dtype, rm)
            return _solve_batched(
                A_t, problem.b, lam_c, problem.lam2, steps, weights, state,
                rm, kind=problem.penalty.kind, gsize=multiple, cfg=cfg,
                route=route)

    return PreparedBatch(solve_chunk, A_t, B, n_blocks, None, route)


def batched_lambda_path(
    problem: Problem,
    cfg: SolverConfig,
    *,
    path_len: int = 10,
    lam_min_frac: float = 0.01,
    lambdas: jax.Array | None = None,
    mesh: jax.sharding.Mesh | None = None,
    row_mask: jax.Array | None = None,
    prepared: PreparedBatch | None = None,
) -> PathResult:
    """Solve the whole lambda grid simultaneously; see module docstring.

    Falls back to the sequential ``lambda_path`` when the batched sweep's
    gate fails (non-f32 dtype, no pad-free block size, L > MAX_BATCH, a
    tile past shared memory, or A + A_t past the device memory budget) —
    with a warning, and ``PathResult.method_used`` records the solver that
    actually ran.

    With ``mesh`` the grid runs column-sharded (one A_t slab per card,
    every card streams its slab once per sweep for ALL grid points, one
    (L, m) psum consensus per sweep).

    With ``row_mask`` ((m,), 0/1) the path solves the ROW-MASKED problem
    (rm ⊙ A, rm ⊙ b) against the SAME device-resident A — no masked copy
    exists anywhere (the mask rides the kernels' resident residual rows).
    Pass ``prepared`` (from :func:`prepare_batched_solver`) to reuse one
    A_t hoist across calls, e.g. across CV folds."""
    if lambdas is None:
        b_eff = (problem.b if row_mask is None
                 else problem.b * jnp.asarray(row_mask, problem.dtype))
        # (rm⊙A)^T (rm⊙b) = A^T (rm⊙b) for a 0/1 mask: masked lam_max
        # needs no masked copy of A either
        lmax = lambda_max(problem.A, b_eff, problem.penalty)
        lambdas = jnp.geomspace(0.95 * lmax, lam_min_frac * lmax, path_len)
    lambdas = jnp.asarray(lambdas, problem.dtype)
    L = int(lambdas.shape[0])

    # dense grids run in consecutive chunks of <= MAX_BATCH points, each
    # chunk warm-started from the previous chunk's deepest solution (GS
    # prox descent is monotone from any start); equal-size chunks keep the
    # number of distinct program shapes at <= 2 (body chunks + remainder)
    n_chunks = -(-L // MAX_BATCH)
    chunk = -(-L // n_chunks)

    prep = prepared
    if prep is None:
        prep = prepare_batched_solver(problem, cfg, mesh=mesh,
                                      chunk=min(L, chunk))
    if prep.reason is not None:
        warnings.warn(
            f"bcd_batch gate failed ({prep.reason}); falling back to the "
            f"sequential bcd_pallas path — PathResult.method_used records "
            f"the substitution", stacklevel=2)
        from convex_optimization_tpu.solvers.lambda_path import lambda_path

        p_eff = problem
        if row_mask is not None:
            # masked-copy fallback: only reachable where the kernel gate
            # fails (small/odd shapes), so the full-size masked copy is
            # small by construction
            import dataclasses

            rm = jnp.asarray(row_mask, problem.dtype)
            p_eff = dataclasses.replace(problem, A=problem.A * rm[:, None],
                                        b=problem.b * rm)
        return lambda_path(p_eff, cfg, lambdas=lambdas,
                           method="bcd_pallas", mesh=mesh)

    rm = (None if row_mask is None
          else jnp.asarray(row_mask, problem.dtype).reshape(problem.m))

    xs_parts, gaps_parts, iters_parts = [], [], []
    x_warm = r_warm = None
    for c0 in range(0, L, chunk):
        lam_c = lambdas[c0:c0 + chunk]
        final = prep.solve_chunk(lam_c, x_warm, r_warm, rm)
        Lc = lam_c.shape[0]
        xs_parts.append(final.X_best.transpose(1, 0, 2).reshape(
            Lc, problem.n))
        gaps_parts.append(final.best_rel)
        iters_parts.append(final.iters_done)
        if c0 + chunk < L:
            # warm-start the next chunk at the deepest certified point;
            # R_best is that point's EXACT refreshed residual (no extra
            # program; for masked runs it is masked, preserving the
            # invariant)
            x_warm = final.X_best[:, Lc - 1, :]
            r_warm = final.R_best[Lc - 1]

    gaps = jnp.concatenate(gaps_parts)
    return PathResult(
        lambdas=lambdas,
        xs=jnp.concatenate(xs_parts, axis=0),
        gaps=gaps,
        iters=jnp.concatenate(iters_parts),
        method_used="bcd_batch" if mesh is None else "bcd_batch+sharded",
        converged=gaps <= cfg.tol,
    )
