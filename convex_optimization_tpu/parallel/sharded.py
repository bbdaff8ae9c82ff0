"""Column-sharded solvers under shard_map (SURVEY.md sections 2.2/2.3, 7.2 L3).

Design: A's columns (feature blocks) are sharded over the 1-D mesh axis
``"blocks"``; each chip owns a column slab ``A_loc`` and the matching slice of
``x``.  The residual ``r = A x - b`` is replicated and kept in consensus by ONE
``psum`` of an m-vector per iteration:

    r_new = psum(A_loc @ x_new_loc) - b

The duality-gap monitor combines local partials exactly the way the local
path does (core.objective.gap_from_parts): penalty value and ||x||^2 via
psum, the dual norm via pmax — so the sharded solve is bit-for-tolerance
equivalent to the unsharded one (tested in tests/test_sharding.py).

The ENTIRE while_loop lives inside one shard_map'd jitted program: no
per-iteration host dispatch; XLA hands the collectives to NCCL.
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

from convex_optimization_tpu.core.objective import gap_from_parts
from convex_optimization_tpu.core.problem import Problem
from convex_optimization_tpu.models.penalties import Penalty
from convex_optimization_tpu.ops.power_iter import spectral_norm_sq
from convex_optimization_tpu.ops.bcd_sweep_ref import bcd_sweep_ref
from convex_optimization_tpu.parallel.collectives import ring_psum
from convex_optimization_tpu.parallel.mesh import (BLOCKS, ROWS,
                                                     check_lam1_slot)
from convex_optimization_tpu.solvers.common import (
    History,
    SolveState,
    SolverConfig,
    record_check,
)


def _consensus_fn(cfg: SolverConfig):
    """The residual-consensus all-reduce: flat psum, ppermute ring, or
    reduce-scatter + all-gather (the Ulysses/all-to-all layout-swap
    analog, SURVEY.md 2.2)."""
    if cfg.consensus == "ring":
        return lambda v: ring_psum(v, BLOCKS)
    if cfg.consensus == "reduce_scatter":
        from convex_optimization_tpu.parallel.collectives import (
            reduce_scatter_gather,
        )

        return lambda v: reduce_scatter_gather(v, BLOCKS)
    if cfg.consensus != "psum":
        raise ValueError(f"unknown consensus {cfg.consensus!r}")
    return lambda v: lax.psum(v, BLOCKS)


def _state_specs() -> SolveState:
    """PartitionSpec pytree for SolveState: x-like sharded, rest replicated."""
    return SolveState(
        x=P(BLOCKS), r=P(), x_prev=P(BLOCKS), r_prev=P(),
        t_mom=P(), k=P(), rel_gap=P(), gap=P(), primal=P(),
        keep_mask=P(BLOCKS),
        history=History(*([P()] * 7)),
        best_rel_gap=P(), stall=P(),
        x_best=P(BLOCKS), best_gap=P(), best_primal=P(),
    )


def _local_penalty(penalty: Penalty, n_shards: int, lam1, weights_loc) -> Penalty:
    """Shard-local view of the penalty (group counts divide over shards)."""
    if penalty.kind == "group_l2":
        return Penalty(lam1=lam1, kind="group_l2",
                       ngroups=penalty.ngroups // n_shards, weights=weights_loc)
    return Penalty(lam1=lam1, kind=penalty.kind)


def _gap_check_local(pen_loc: Penalty, lam2, A_loc, b, s: SolveState,
                     col_norms_loc, screen: bool) -> SolveState:
    """Duality gap from psum/pmax-combined partials; updates history/mask."""
    x_loc, r = s.x, s.r
    z_loc = -(A_loc.T @ r) - lam2 * x_loc
    dn = lax.pmax(pen_loc.dual_norm(z_loc), BLOCKS)
    x_sq = lax.psum(jnp.vdot(x_loc, x_loc), BLOCKS)
    g_val = lax.psum(pen_loc.value(x_loc), BLOCKS)
    info = gap_from_parts(
        rho_dot_b=-jnp.vdot(r, b),
        rho_aug_sq=jnp.vdot(r, r) + lam2 * x_sq,
        g_value=g_val,
        dual_norm_value=dn,
    )
    nnz = lax.psum(jnp.sum(s.x != 0), BLOCKS).astype(jnp.int32)
    keep = s.keep_mask
    if screen:
        keep = keep & pen_loc.screen_keep(
            z_loc, info.alpha, info.gap, col_norms_loc,
            r_norm=jnp.sqrt(jnp.vdot(r, r)), primal=info.primal)
    return record_check(s, info, x_loc, nnz, keep)


def sharded_fista(problem: Problem, L_total, state0: SolveState,
                  cfg: SolverConfig, mesh: jax.sharding.Mesh,
                  col_norms: jax.Array | None = None):
    """FISTA with columns of A sharded over mesh axis 'blocks'.

    Returns (jitted_fn, args): call ``jitted_fn(*args)`` (or AOT-lower it)
    to run the whole solve as one shard_map'd program."""
    n_shards = mesh.shape[BLOCKS]
    pen = problem.penalty
    lam2 = problem.lam2
    kind = pen.kind
    screen = cfg.screen_every > 0
    if col_norms is None:
        col_norms = problem.col_norms() if screen else jnp.zeros(problem.n,
                                                                 problem.dtype)
    weights = pen.weights
    if kind == "group_l2" and weights is None:
        weights = jnp.ones((pen.ngroups,), problem.dtype)

    w_spec = P(BLOCKS) if kind == "group_l2" else P()
    if weights is None:
        weights = jnp.zeros((1,), problem.dtype)  # dummy, replicated

    def local_solve(A_loc, b, lam1, weights_loc, L_tot, cn_loc,
                    s: SolveState) -> SolveState:
        pen_loc = _local_penalty(pen, n_shards, lam1, weights_loc
                                 if kind == "group_l2" else None)
        allreduce = _consensus_fn(cfg)

        def step(s: SolveState) -> SolveState:
            x, r, x_prev, r_prev, t = s.x, s.r, s.x_prev, s.r_prev, s.t_mom
            if cfg.momentum:
                t_next = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * t * t))
                beta = (t - 1.0) / t_next
                y = x + beta * (x - x_prev)
                r_y = r + beta * (r - r_prev)
            else:
                t_next, y, r_y = t, x, r
            g = A_loc.T @ r_y + lam2 * y
            stp = 1.0 / L_tot
            x_new = pen_loc.prox(y - stp * g, stp)
            x_new = jnp.where(s.keep_mask, x_new, 0.0)
            r_new = allreduce(A_loc @ x_new) - b
            if cfg.momentum and cfg.adaptive_restart:
                dot = lax.psum(jnp.vdot(y - x_new, x_new - x), BLOCKS)
                do_restart = dot > 0.0
                t_next = jnp.where(do_restart, 1.0, t_next)
                x_prev_out = jnp.where(do_restart, x_new, x)
                r_prev_out = jnp.where(do_restart, r_new, r)
            else:
                x_prev_out, r_prev_out = x, r
            return s._replace(x=x_new, r=r_new, x_prev=x_prev_out,
                              r_prev=r_prev_out, t_mom=t_next, k=s.k + 1)

        def body(s):
            s = lax.fori_loop(0, cfg.gap_every, lambda _, st: step(st), s)
            return _gap_check_local(pen_loc, lam2, A_loc, b, s, cn_loc, screen)

        def cond(s):
            go = (s.k < cfg.max_iters) & (s.rel_gap > cfg.tol)
            if cfg.stall_checks > 0:
                go = go & (s.stall < cfg.stall_checks)
            return go

        s = _gap_check_local(pen_loc, lam2, A_loc, b, s, cn_loc, screen)
        if cfg.unroll_checks:
            # static unroll with a convergence mask: exists to let the
            # ring-consensus path run at all on XLA:CPU, which SIGABRTs on
            # ppermute inside a while_loop body (use small max_iters!)
            for _ in range(-(-cfg.max_iters // cfg.gap_every)):
                go = cond(s)
                s_next = body(s)
                s = jax.tree.map(
                    lambda old, new: jnp.where(go, new, old), s, s_next)
            return s
        return lax.while_loop(cond, body, s)

    sspec = _state_specs()
    # ring consensus leaves results 'varying' in the VMA system (there is
    # no varying->invariant cast), so VMA checking is disabled for it; the
    # ring==psum equivalence test is the correctness guard.
    f = jax.shard_map(
        local_solve, mesh=mesh,
        in_specs=(P(None, BLOCKS), P(), P(), w_spec, P(), P(BLOCKS), sspec),
        out_specs=sspec,
        check_vma=(cfg.consensus == "psum"),
    )
    args = check_lam1_slot((problem.A, problem.b, pen.lam1, weights,
                            L_total, col_norms, state0), pen)
    return jax.jit(f), args


def sharded_bcd(problem: Problem, block_L, state0: SolveState,
                cfg: SolverConfig, mesh: jax.sharding.Mesh,
                col_norms: jax.Array | None = None):
    """Block-CD, Gauss-Seidel within each chip's column slab, Jacobi across
    chips (SURVEY.md section 7.1): each sweep every chip runs the fused local
    sweep against the consensus residual, then one psum merges the residual
    deltas.  cfg.step_scale damps the steps for cross-chip safety."""
    n_shards = mesh.shape[BLOCKS]
    pen = problem.penalty
    lam2 = problem.lam2
    kind = pen.kind
    screen = cfg.screen_every > 0
    if col_norms is None:
        col_norms = problem.col_norms() if screen else jnp.zeros(problem.n,
                                                                 problem.dtype)
    weights = pen.weights
    if kind == "group_l2" and weights is None:
        weights = jnp.ones((pen.ngroups,), problem.dtype)
    w_spec = P(BLOCKS) if kind == "group_l2" else P()
    if weights is None:
        weights = jnp.zeros((1,), problem.dtype)

    n_blocks = block_L.shape[0]
    if n_blocks % n_shards != 0:
        raise ValueError("n_blocks must divide evenly over mesh devices")
    nb_loc = n_blocks // n_shards
    n_loc = problem.n // n_shards
    bs_loc = n_loc // nb_loc
    gsize = problem.n // pen.ngroups if kind == "group_l2" else 1

    def _fused_slab(n_h: int) -> bool:
        """True when a slab of n_h columns runs the fused sweep (the same
        kernel as the single-card solve, on the slab inside shard_map)."""
        if not cfg.use_pallas:
            return False
        from convex_optimization_tpu.ops.route import sweep_gate

        reason = sweep_gate(problem.m, n_h, bs_loc, 1, problem.dtype, gsize)
        if reason is not None:
            import warnings

            warnings.warn(f"fused sweep gate failed on a {n_h}-column slab "
                          f"({reason}); the slab runs the plain sweep",
                          stacklevel=3)
        return reason is None

    # ring consensus: split the local sweep in two halves and issue the
    # first half's chunked ring reduction BEFORE the second half computes.
    # The first ppermute chain has no data dependency on the second half's
    # sweep, so the latency-hiding scheduler overlaps consensus with
    # compute (the ring-attention / PP-overlap analog, SURVEY.md 2.2).
    # The arithmetic is identical to the unsplit sweep: the local sweep is
    # sequential over blocks either way, and
    #   allreduce(dr) = allreduce(dr_half1) + allreduce(dr_half2).
    split = cfg.consensus == "ring" and nb_loc >= 2
    # the fused sweep's foreign-function outputs carry no vma, so the VMA
    # checker rejects them inside shard_map: a program with a fused slab
    # runs with the checks off, and the sharded == unsharded equivalence
    # test is the correctness guard
    fused_slabs = {nb_h: _fused_slab(nb_h * bs_loc)
                   for nb_h in ({nb_loc // 2, nb_loc - nb_loc // 2}
                                if split else {nb_loc})}

    def local_solve(A_loc, b, lam1, weights_loc, bL_loc, cn_loc,
                    s: SolveState) -> SolveState:
        pen_loc = _local_penalty(pen, n_shards, lam1, weights_loc
                                 if kind == "group_l2" else None)
        allreduce = _consensus_fn(cfg)

        def make_slab(lo: int, hi: int):
            """Sweep closure for local blocks [lo, hi) (static bounds)."""
            nb_h = hi - lo
            cols = slice(lo * bs_loc, hi * bs_loc)
            A_h = A_loc[:, cols]
            if kind == "group_l2":
                gpb = pen_loc.ngroups // nb_loc
                pen_h = Penalty(
                    lam1=lam1, kind=kind, ngroups=gpb * nb_h,
                    weights=(None if pen_loc.weights is None
                             else pen_loc.weights[lo * gpb:hi * gpb]))
            else:
                pen_h = pen_loc
            prob_h = Problem(A=A_h, b=b, penalty=pen_h, lam2=lam2)
            bL_h = bL_loc[lo:hi]
            fused = fused_slabs[nb_h]
            A_t_h = None
            if fused:
                from convex_optimization_tpu.ops.matvec import (
                    to_tblock_major,
                )

                A_t_h = to_tblock_major(A_h, nb_h)
            order_h = jnp.arange(nb_h, dtype=jnp.int32)

            def sweep_h(x_h, r_in, keep_h):
                if fused:
                    from convex_optimization_tpu.ops.bcd_sweep import (
                        bcd_sweep,
                    )

                    return bcd_sweep(
                        prob_h, x_h, r_in, bL_h,
                        step_scale=cfg.step_scale, keep_mask=keep_h,
                        A_t=A_t_h)
                return bcd_sweep_ref(
                    prob_h, x_h, r_in, bL_h, order_h,
                    step_scale=cfg.step_scale, keep_mask=keep_h)

            return cols, sweep_h

        if split:
            mid = nb_loc // 2
            slabs = [make_slab(0, mid), make_slab(mid, nb_loc)]
        else:
            slabs = [make_slab(0, nb_loc)]

        def sweep(s: SolveState) -> SolveState:
            x_loc, r = s.x, s.r
            # r is replicated; the local sweep produces a device-varying
            # residual, so mark the carry varying for shard_map's VMA checks
            r_in = (lax.pcast(r, (BLOCKS,), to="varying")
                    if cfg.consensus == "psum" else r)  # no-op w/o VMA
            if len(slabs) == 1:
                cols0, sweep0 = slabs[0]
                x_new, r_virtual = sweep0(x_loc, r_in, s.keep_mask)
            else:
                from convex_optimization_tpu.parallel.collectives import (
                    ring_psum_chunked,
                )

                xs_new, drs = [], []
                r_cur = r_in
                for cols_h, sweep_fn_h in slabs:
                    x_h, r_next = sweep_fn_h(x_loc[cols_h], r_cur,
                                             s.keep_mask[cols_h])
                    # issue this half's consensus immediately: its ring
                    # steps are independent of the NEXT half's compute
                    drs.append(ring_psum_chunked(r_next - r_cur, BLOCKS, 2))
                    xs_new.append(x_h)
                    r_cur = r_next
                x_new = jnp.concatenate(xs_new)
                r_virtual = r_cur
            # Chips sweep their own blocks Gauss-Seidel against the shared
            # residual; summing all chips' updates (Jacobi across chips) can
            # overshoot when column slabs correlate.  Safeguard: exact line
            # search on the aggregated direction.  For gamma in [0,1],
            #   P(x + g*dx) <= 0.5*||r + g*dr||^2(+lam2 part)
            #                  + (1-g)*G0 + g*G1          (convexity of g)
            # minimized in closed form -> monotone descent, and gamma -> 1
            # as cross-chip interference vanishes.  One m-vector psum (needed
            # anyway) + three scalar psums.
            dx = x_new - x_loc
            if len(slabs) == 1:
                dr = allreduce(r_virtual - r_in)
            else:
                dr = drs[0]
                for d in drs[1:]:
                    dr = dr + d
            lin = jnp.vdot(r, dr) + lam2 * lax.psum(jnp.vdot(x_loc, dx), BLOCKS)
            den = jnp.vdot(dr, dr) + lam2 * lax.psum(jnp.vdot(dx, dx), BLOCKS)
            # value_diff avoids f32 difference-of-large-sums cancellation,
            # which otherwise deadlocks the line search (gamma=0) while the
            # gap is still ~1e-3
            dG = lax.psum(pen_loc.value_diff(x_loc, dx), BLOCKS)
            gamma_ls = jnp.clip(-(lin + dG) / jnp.maximum(den, 1e-30), 0.0, 1.0)
            # Floor at 1/p: by convexity P(x + dx/p) <= (1/p) sum_k P(x+dx_k)
            # <= P(x), so gamma = 1/p is ALWAYS monotone descent (Jacobi
            # averaging) — this removes the gamma=0 deadlock fixpoint where
            # the summed direction fails the (loose) secant test even though
            # every chip's own sweep descended.
            gamma = jnp.maximum(gamma_ls, 1.0 / n_shards)
            x_out = x_loc + gamma * dx
            r_out = r + gamma * dr
            return s._replace(x=x_out, r=r_out, k=s.k + 1)

        def body(s):
            s = lax.fori_loop(0, cfg.gap_every, lambda _, st: sweep(st), s)
            return _gap_check_local(pen_loc, lam2, A_loc, b, s, cn_loc, screen)

        def cond(s):
            go = (s.k < cfg.max_iters) & (s.rel_gap > cfg.tol)
            if cfg.stall_checks > 0:
                go = go & (s.stall < cfg.stall_checks)
            return go

        s = _gap_check_local(pen_loc, lam2, A_loc, b, s, cn_loc, screen)
        if cfg.unroll_checks:
            # static unroll with a convergence mask: exists to let the
            # ring-consensus path run at all on XLA:CPU, which SIGABRTs on
            # ppermute inside a while_loop body (use small max_iters!)
            for _ in range(-(-cfg.max_iters // cfg.gap_every)):
                go = cond(s)
                s_next = body(s)
                s = jax.tree.map(
                    lambda old, new: jnp.where(go, new, old), s, s_next)
            return s
        return lax.while_loop(cond, body, s)

    sspec = _state_specs()
    f = jax.shard_map(
        local_solve, mesh=mesh,
        in_specs=(P(None, BLOCKS), P(), P(), w_spec, P(BLOCKS), P(BLOCKS), sspec),
        out_specs=sspec,
        check_vma=(cfg.consensus == "psum"  # see sharded_fista note
                   and not any(fused_slabs.values())),
    )
    args = check_lam1_slot((problem.A, problem.b, pen.lam1, weights,
                            block_L, col_norms, state0), pen)
    return jax.jit(f), args


def _solve_grid_sharded(problem: Problem, method: str,
                        mesh: jax.sharding.Mesh, x0, cfg: SolverConfig):
    """DP x TP dispatch: A tiled over ('rows', 'blocks')."""
    from convex_optimization_tpu.api import Result
    from convex_optimization_tpu.solvers.fista import init_state
    from convex_optimization_tpu.parallel.grid_sharded import (
        grid_sharded_bcd,
        grid_sharded_fista,
        _state_specs_grid,
    )

    if method not in ("fista", "ista", "bcd", "bcd_pallas"):
        raise ValueError(
            f"grid sharding supports fista/ista/bcd, got {method!r}")
    R, C = mesh.shape[ROWS], mesh.shape[BLOCKS]
    if problem.m % R != 0 or problem.n % C != 0:
        raise ValueError(
            f"(m={problem.m}, n={problem.n}) must divide over ({R}, {C})")
    if problem.penalty.kind == "group_l2" \
            and problem.penalty.ngroups % C != 0:
        raise ValueError("ngroups must divide over block shards")

    A = jax.device_put(problem.A, NamedSharding(mesh, P(ROWS, BLOCKS)))
    b = jax.device_put(problem.b, NamedSharding(mesh, P(ROWS)))
    problem = dataclasses.replace(problem, A=A, b=b)

    def make_state(xinit):
        s = init_state(problem, xinit, cfg)
        return jax.device_put(
            s,
            jax.tree.map(lambda sp: NamedSharding(mesh, sp),
                         _state_specs_grid(),
                         is_leaf=lambda v: isinstance(v, P)),
        )

    if method in ("bcd", "bcd_pallas"):
        # grid GS sweep is plain-XLA (per-block ROWS psums preclude the
        # fused single-card sweep); bcd_pallas accepted, same program
        from convex_optimization_tpu.ops.power_iter import (
            block_spectral_norms_sq,
        )
        from convex_optimization_tpu.solvers.bcd import pick_block_size

        gsz = (problem.n // problem.penalty.ngroups
               if problem.penalty.kind == "group_l2" else 1)
        # bs divides n/C (so n_blocks tiles over the C column shards) and
        # contains whole groups
        bs = pick_block_size(problem.n // C, cfg.block_size,
                             multiple_of=gsz)
        block_L = block_spectral_norms_sq(problem.A, problem.n // bs)
        jfn, args = grid_sharded_bcd(problem, block_L, make_state(x0), cfg,
                                     mesh)
    else:
        L_total = spectral_norm_sq(problem.A) + problem.lam2
        jfn, args = grid_sharded_fista(problem, L_total, make_state(x0), cfg,
                                       mesh)
    final, wall, compile_s = _timed_run(jfn, args)
    iters = int(final.k)
    return Result(
        x=final.x_best, gap=float(final.best_gap),
        rel_gap=float(final.best_rel_gap),
        primal=float(final.best_primal), iterations=iters,
        converged=bool(final.best_rel_gap <= cfg.tol), wall_time_s=wall,
        compile_time_s=compile_s,
        iters_per_sec=iters / wall if wall > 0 else float("inf"),
        history=jax.tree.map(lambda a: jax.device_get(a), final.history).trimmed(),
        method=f"grid_sharded_{method}", config=cfg,
    )


def _solve_row_sharded(problem: Problem, method: str,
                       mesh: jax.sharding.Mesh, x0, cfg: SolverConfig):
    """DP-analog dispatch: rows of A and b sharded over axis 'rows'."""
    from convex_optimization_tpu.api import Result
    from convex_optimization_tpu.solvers.fista import init_state
    from convex_optimization_tpu.parallel.row_sharded import (
        sharded_bcd_rows,
        sharded_fista_rows,
        _state_specs_rows,
    )

    if method not in ("fista", "ista", "bcd", "bcd_pallas"):
        raise ValueError(
            f"row sharding supports fista/ista/bcd, got {method!r}")
    n_shards = mesh.shape[ROWS]
    if problem.m % n_shards != 0:
        raise ValueError(f"m={problem.m} must divide over {n_shards} shards")

    A = jax.device_put(problem.A, NamedSharding(mesh, P(ROWS, None)))
    b = jax.device_put(problem.b, NamedSharding(mesh, P(ROWS)))
    problem = dataclasses.replace(problem, A=A, b=b)

    def make_state(xinit):
        s = init_state(problem, xinit, cfg)
        return jax.device_put(
            s,
            jax.tree.map(lambda sp: NamedSharding(mesh, sp),
                         _state_specs_rows(),
                         is_leaf=lambda v: isinstance(v, P)),
        )

    if method in ("bcd", "bcd_pallas"):
        # rows-sharded GS sweep is plain-XLA (the fused kernel needs the
        # whole column resident on one chip, which row sharding denies);
        # bcd_pallas is accepted and served by the same program
        from convex_optimization_tpu.ops.power_iter import (
            block_spectral_norms_sq,
        )
        from convex_optimization_tpu.solvers.bcd import pick_block_size

        multiple = 1
        if problem.penalty.kind == "group_l2":
            multiple = problem.n // problem.penalty.ngroups
        bs = pick_block_size(problem.n, cfg.block_size, multiple_of=multiple)
        block_L = block_spectral_norms_sq(problem.A, problem.n // bs)
        jfn, args = sharded_bcd_rows(problem, block_L, make_state(x0), cfg,
                                     mesh)
    else:
        L_total = spectral_norm_sq(problem.A) + problem.lam2
        jfn, args = sharded_fista_rows(problem, L_total, make_state(x0), cfg,
                                       mesh)
    final, wall, compile_s = _timed_run(jfn, args)
    iters = int(final.k)
    return Result(
        x=final.x_best, gap=float(final.best_gap),
        rel_gap=float(final.best_rel_gap),
        primal=float(final.best_primal), iterations=iters,
        converged=bool(final.best_rel_gap <= cfg.tol), wall_time_s=wall,
        compile_time_s=compile_s,
        iters_per_sec=iters / wall if wall > 0 else float("inf"),
        history=jax.tree.map(lambda a: jax.device_get(a), final.history).trimmed(),
        method=f"row_sharded_{method}", config=cfg,
    )


def _timed_run(jfn, args):
    """Compile ahead of time (set-up), then one execution ended by
    block_until_ready.  Returns (final state, wall s, compile s)."""
    t0 = time.perf_counter()
    compiled = jfn.lower(*args).compile()
    t1 = time.perf_counter()
    final = jax.block_until_ready(compiled(*args))
    return final, time.perf_counter() - t1, t1 - t0


def solve_sharded(problem: Problem, method: str, mesh: jax.sharding.Mesh,
                  x0=None, cfg: Optional[SolverConfig] = None,
                  **cfg_overrides):
    """Distributed entry used by api.solve(mesh=...).  Returns api.Result."""
    from convex_optimization_tpu.api import Result
    from convex_optimization_tpu.solvers.fista import init_state
    from convex_optimization_tpu.solvers.bcd import pick_block_size
    from convex_optimization_tpu.ops.power_iter import block_spectral_norms_sq

    if cfg is None:
        cfg = SolverConfig()
    if method == "ista":
        cfg_overrides.setdefault("momentum", False)
    if method == "bcd_pallas":
        method = "bcd"
        cfg_overrides.setdefault("use_pallas", True)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)

    if ROWS in mesh.axis_names and BLOCKS in mesh.axis_names:
        return _solve_grid_sharded(problem, method, mesh, x0, cfg)
    if ROWS in mesh.axis_names:
        return _solve_row_sharded(problem, method, mesh, x0, cfg)

    n_shards = mesh.shape[BLOCKS]
    if problem.n % n_shards != 0:
        raise ValueError(f"n={problem.n} must divide over {n_shards} shards")
    if problem.penalty.kind == "group_l2":
        if problem.penalty.ngroups % n_shards != 0:
            raise ValueError("ngroups must divide over shards")

    # place data
    A = jax.device_put(problem.A, NamedSharding(mesh, P(None, BLOCKS)))
    b = jax.device_put(problem.b, NamedSharding(mesh, P()))
    problem = dataclasses.replace(problem, A=A, b=b)

    def make_state(xinit):
        s = init_state(problem, xinit, cfg)
        return jax.device_put(
            s,
            jax.tree.map(lambda sp: NamedSharding(mesh, sp), _state_specs(),
                         is_leaf=lambda v: isinstance(v, P)),
        )

    state0 = make_state(x0)

    if method in ("fista", "ista"):
        L_total = spectral_norm_sq(problem.A) + problem.lam2
        jfn, args = sharded_fista(problem, L_total, state0, cfg, mesh)
    elif method == "bcd":
        multiple = 1
        if problem.penalty.kind == "group_l2":
            multiple = problem.n // problem.penalty.ngroups
        bs = pick_block_size(problem.n // n_shards, cfg.block_size,
                             multiple_of=multiple)
        n_blocks = problem.n // bs
        block_L = block_spectral_norms_sq(problem.A, n_blocks)
        jfn, args = sharded_bcd(problem, block_L, state0, cfg, mesh)
    else:
        raise ValueError(f"unknown sharded method {method!r}")

    final, wall, compile_s = _timed_run(jfn, args)
    iters = int(final.k)
    return Result(
        x=final.x_best, gap=float(final.best_gap),
        rel_gap=float(final.best_rel_gap),
        primal=float(final.best_primal), iterations=iters,
        converged=bool(final.best_rel_gap <= cfg.tol), wall_time_s=wall,
        compile_time_s=compile_s,
        iters_per_sec=iters / wall if wall > 0 else float("inf"),
        history=jax.tree.map(lambda a: jax.device_get(a), final.history).trimmed(),
        method=f"sharded_{method}", config=cfg,
    )
