"""f64 post-solve refinement ("polish") on the screened support.

Why this exists: f32 iteration arithmetic has a relative-duality-gap floor
of a few 1e-6 at scale (the noise is injected by rounded matvecs each step,
not by the monitor; SURVEY.md section 7.4 anticipated exactly this).  To CERTIFY the 1e-6 grade
[B:2] the solve finishes with a small float64 phase:

  1. gap-safe screen at the f32 solution with an f64 certificate — at gap
     ~5e-6 the safe sphere is tight, so the kept set is a small superset of
     the support;
  2. compact the problem to the kept columns;
  3. solve the compacted problem in float64 on the host, warm-started at
     the f32 solution (cyclic coordinate descent ``_cd64`` on the support
     path; FISTA ``_fista64`` on the screened-set paths);
  4. scatter back and re-certify in f64.

The whole phase is plain NumPy on the host: the compacted problem is tiny
(tens of f64 iterations at ~1 GFLOP total), so a jitted loop would cost
more in XLA compile time than it could ever save (50 f64 iterations are
<1 s of flops but tens of seconds of while_loop compilation on a 1-core
host).  Moving it onto the device in f64 is an open performance item.

Screening safety (models/penalties.py screen_keep) guarantees the discarded
coordinates are exactly zero at the optimum, so the compacted solve's
certificate is valid for the full problem.
"""

from __future__ import annotations

import resource
import time
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp


class PolishResult(NamedTuple):
    x: np.ndarray          # (n,) float64 polished solution
    rel_gap: float         # f64-certified relative duality gap (full problem)
    gap: float
    primal: float
    kept: int              # columns that survived screening
    iterations: int        # f64 FISTA iterations
    wall_time_s: float


class _NpPenalty:
    """NumPy twin of models.penalties.Penalty (f64, host-side)."""

    def __init__(self, kind: str, lam1: float, ngroups: int,
                 weights: np.ndarray | None, n: int):
        self.kind, self.lam1, self.ngroups, self.n = kind, lam1, ngroups, n
        if kind == "group_l2":
            self.w = (np.ones(ngroups) if weights is None
                      else np.asarray(weights, np.float64))
        else:
            self.w = None

    def _g(self, x):
        return x.reshape(self.ngroups, -1)

    def value(self, x):
        if self.kind in ("l1", "nonneg_l1"):
            return self.lam1 * np.abs(x).sum()
        gn = np.linalg.norm(self._g(x), axis=1)
        return self.lam1 * (self.w * gn).sum()

    def prox(self, v, t):
        tl = t * self.lam1
        if self.kind == "l1":
            return np.sign(v) * np.maximum(np.abs(v) - tl, 0.0)
        if self.kind == "nonneg_l1":
            return np.maximum(v - tl, 0.0)
        vg = self._g(v)
        gn = np.linalg.norm(vg, axis=1, keepdims=True)
        scale = np.maximum(0.0, 1.0 - tl * self.w[:, None]
                           / np.maximum(gn, 1e-300))
        return (vg * scale).reshape(v.shape)

    def dual_norm(self, z):
        if self.kind == "l1":
            return np.max(np.abs(z)) / self.lam1
        if self.kind == "nonneg_l1":
            return max(np.max(z), 0.0) / self.lam1
        gn = np.linalg.norm(self._g(z), axis=1)
        return np.max(gn / self.w) / self.lam1

    def keep_mask(self, z, alpha, gap, col_norms):
        """Gap-safe sphere test (matches Penalty.screen_keep)."""
        radius = np.sqrt(max(2.0 * gap, 0.0))
        witness = alpha * z
        if self.kind == "l1":
            discard = np.abs(witness) + radius * col_norms < self.lam1
        elif self.kind == "nonneg_l1":
            discard = witness + radius * col_norms < self.lam1
        else:
            gn = np.linalg.norm(self._g(witness), axis=1)
            gcol = np.sqrt((self._g(col_norms**2)).sum(axis=1))
            gdiscard = gn + radius * gcol < self.lam1 * self.w
            discard = np.repeat(gdiscard, self.n // self.ngroups)
        return ~discard

    def compact(self, keep):
        """Group-align the keep mask; return (aligned keep, compacted pen)."""
        if self.kind != "group_l2":
            return keep, _NpPenalty(self.kind, self.lam1, 0, None,
                                    int(keep.sum()))
        gsize = self.n // self.ngroups
        gkeep = keep.reshape(-1, gsize).any(axis=1)
        keep = np.repeat(gkeep, gsize)
        return keep, _NpPenalty("group_l2", self.lam1, int(gkeep.sum()),
                                self.w[gkeep], int(keep.sum()))


def _gap_from_parts(r, b, lam2, pen, x, z):
    """(gap, primal, rel_gap, alpha) in f64 from precomputed r and z.

    alpha = the OPTIMAL feasible scaling on the residual ray (see
    core.objective.gap_from_parts): unconstrained maximizer of the dual
    parabola clipped to feasibility — uniformly tighter than the round-1
    1/max(1, dual_norm) and still sound."""
    feas = 1.0 / max(float(pen.dual_norm(z)), 1e-300)
    aug = float(r @ r + lam2 * (x @ x))
    alpha = min(max(float(-(r @ b)) / max(aug, 1e-300), 0.0), feas)
    primal = 0.5 * aug + float(pen.value(x))
    dual = alpha * float(-(r @ b)) - 0.5 * alpha * alpha * aug
    gap = primal - dual
    rel = gap / max(abs(primal), np.finfo(np.float64).tiny)
    return gap, primal, rel, alpha


#: which path the last _gather_cols call took ("native" | "numpy");
#: surfaced in the polish verbose tick so a slow gather can be attributed
#: to a path, not guessed at post hoc.
_last_gather_path = "?"


def _gather_cols(A, idx, dtype=np.float64):
    """Column gather (+ cast) with contiguous reads AND writes.

    ``A[:, idx].astype(f64)`` first materializes a C-ordered fancy-index
    copy — with the column-major host matrices every write lands a full
    row-stride apart, which is slow.  Gathering column-by-column into a preallocated F-ordered output
    keeps each 4m-byte read and 8m-byte write contiguous and fuses the f64
    cast; the Python loop overhead is microseconds per column.
    """
    # native path: one GIL-released C call for the whole index set
    global _last_gather_path
    if isinstance(A, np.ndarray):
        from convex_optimization_tpu.utils import native as co_native

        out = co_native.gather_cols(A, np.asarray(idx), dtype)
        if out is not None:
            _last_gather_path = "native"
            return out
    _last_gather_path = "numpy"
    m = A.shape[0]
    # np.zeros, NOT np.empty: faulting fresh pages in during the strided
    # gather writes can stall on THP compaction, while calloc-backed zero
    # pages fault at full speed
    out = np.zeros((m, len(idx)), dtype, order="F")
    # BATCHED columns per numpy call: a per-column Python loop makes ~7000
    # GIL-releasing micro-copies, each a chance for another thread to take
    # the core.  A 64-column fancy-index batch keeps its C-ordered temp
    # cache-sized (m x 64 x 4 = 2.5 MB at the headline) so both the gather
    # and the F-order assignment stay cache-resident, with ~100x fewer GIL
    # windows.
    bs = 64
    for k in range(0, len(idx), bs):
        out[:, k:k + bs] = A[:, idx[k:k + bs]]
    return out


def _sparse_residual(A, x, b, chunk=4096):
    """r = A x - b in f64 exploiting sparsity of x (A may be f32)."""
    nz = np.nonzero(x)[0]
    if len(nz) == 0:
        return -b.astype(np.float64)
    r = _gather_cols(A, nz) @ x[nz]
    return r - b


def _witness_and_colnorms(A, r, lam2, x, chunk_cols=2048,
                          need_colnorms=True):
    """One chunked pass over A (kept f32 in memory, cast per chunk):
    z = -A^T r - lam2 x and col_norms = sqrt(sum A_j^2 + lam2), both f64.
    Avoids materializing a full f64 copy of A (2x bytes, 2x passes)."""
    n = A.shape[1]
    z = np.empty(n, np.float64)
    cn = np.empty(n, np.float64) if need_colnorms else None
    for c0 in range(0, n, chunk_cols):
        c1 = min(c0 + chunk_cols, n)
        blk = A[:, c0:c1].astype(np.float64)
        z[c0:c1] = -(blk.T @ r)
        if need_colnorms:
            cn[c0:c1] = np.sqrt((blk * blk).sum(axis=0) + lam2)
    if lam2 != 0.0:
        z -= lam2 * x
    return z, cn


def polish_fast(problem, x, *, tol: float = 1e-6, max_iters: int = 20_000,
                gap_every: int = 4, A_host: np.ndarray | None = None,
                b_host: np.ndarray | None = None) -> PolishResult:
    """Certified refinement with ZERO full-width f64 passes over A.

    The expensive parts of ``polish`` are two host passes over all n
    columns (screen witness + final dual-feasibility check).  Both are
    eliminated by a safe-screening argument:

      * the dual objective D(theta) = <theta, b> - ||theta||^2/2 is
        1-strongly concave, so any feasible theta0 with gap g0 satisfies
        ||theta0 - theta*|| <= sqrt(2 g0);
      * the compact solve's witness theta_hat has
        ||theta_hat - theta*|| <= sqrt(2 g_hat), so
        ||theta_hat - theta0|| <= R := sqrt(2 g0) + sqrt(2 g_hat);
      * therefore screening AT theta0 WITH RADIUS R certifies
        |A_j^T theta_hat| < lam1 for every discarded column j — the compact
        certificate extends verbatim to the full problem (discarded coords
        are zero in x_full, so P and D are unchanged).

    The screen itself runs on the DEVICE in f32 (one fast pass over A),
    with every f32 quantity inflated by a deterministic rounding bound
    before use; g_hat <= tol * P is known a priori.  Only the compacted
    columns are ever touched on the host in f64.
    """
    import jax.numpy as jnp

    from convex_optimization_tpu.core.objective import dual_witness, gap_from_parts

    t0 = time.perf_counter()
    m, n = problem.A.shape
    lam1 = float(jax.device_get(jnp.asarray(problem.penalty.lam1)))
    lam2 = float(problem.lam2)
    weights = problem.penalty.weights
    w = None if weights is None else np.asarray(jax.device_get(weights))
    pen = _NpPenalty(problem.penalty.kind, lam1, problem.penalty.ngroups, w, n)

    if A_host is not None:
        # --- host pass: everything in chunked f64, ZERO device programs.
        # One chunked f64 host pass over A makes the rounding margins
        # trivially tight (f64 eps); the device variant below serves
        # callers without a host copy of A.
        x_np0 = np.asarray(jax.device_get(x), np.float64)
        b64 = np.asarray(jax.device_get(problem.b) if b_host is None
                         else b_host, np.float64)
        r0 = _sparse_residual(A_host, x_np0, b64)
        z0, cn = _witness_and_colnorms(A_host, r0, lam2, x_np0)
        gap0, primal0, rel0, alpha0 = _gap_from_parts(
            r0, b64, lam2, pen, x_np0, z0)
        r_norm = float(np.linalg.norm(r0))
        eps = float(np.finfo(np.float64).eps)
    else:
        # --- device pass: f32 witness, gap, col norms (HBM-speed) ---
        x_dev = jnp.asarray(x, problem.dtype)
        r_dev = problem.residual(x_dev)
        z_dev = dual_witness(problem, x_dev, r_dev)
        info = gap_from_parts(
            rho_dot_b=-jnp.vdot(r_dev, problem.b),
            rho_aug_sq=jnp.vdot(r_dev, r_dev)
            + lam2 * jnp.vdot(x_dev, x_dev),
            g_value=problem.penalty.value(x_dev),
            dual_norm_value=problem.penalty.dual_norm(z_dev),
        )
        cn_dev = problem.col_norms()
        z0 = np.asarray(jax.device_get(z_dev), np.float64)
        cn = np.asarray(jax.device_get(cn_dev), np.float64)
        r_norm = float(jax.device_get(jnp.linalg.norm(r_dev)))
        gap0 = float(jax.device_get(info.gap))
        primal0 = float(jax.device_get(info.primal))
        alpha0 = float(jax.device_get(info.alpha))
        eps = float(np.finfo(np.float32).eps)

    # deterministic rounding inflation: |delta z_j| <= gamma ||A_j|| ||r||
    # (tree-reduction bound for the f32 device pass; vanishingly small for
    # the f64 host pass), col norms and the gap inflated likewise
    gamma = (np.ceil(np.log2(max(m, 2))) + 4) * eps
    cn_safe = cn * (1.0 + 4 * eps) + 1e-12
    z_err = gamma * cn_safe * r_norm
    # the f32 gap itself carries the same O(log2(m) eps |primal|) reduction
    # error as the witnesses — inflate by gamma, not a bare 4 eps
    gap_safe = 1.25 * abs(gap0) + gamma * abs(primal0)

    # screening radius: R0 (at theta0) + R_hat (tol-level compact gap)
    radius = (np.sqrt(2.0 * gap_safe)
              + np.sqrt(2.0 * tol * abs(primal0) * 1.5))
    witness = np.abs(alpha0 * z0) + alpha0 * z_err
    if pen.kind == "l1":
        discard = witness + radius * cn_safe < lam1
    elif pen.kind == "nonneg_l1":
        discard = (alpha0 * z0 + alpha0 * z_err
                   + radius * cn_safe < lam1)
    else:  # group_l2
        gw = np.linalg.norm(pen._g(witness), axis=1)
        gcn = np.sqrt((pen._g(cn_safe ** 2)).sum(axis=1))
        gdiscard = gw + radius * gcn < lam1 * pen.w
        discard = np.repeat(gdiscard, n // pen.ngroups)
    keep = ~discard
    keep, pen_s = pen.compact(keep)
    idx = np.nonzero(keep)[0]
    if len(idx) == 0:
        # every column certified zero: keep one arbitrary column so the
        # machinery below runs (it will drive that coordinate to 0 and the
        # certificate covers the full problem)
        keep[:1] = True
        idx = np.array([0])
        keep, pen_s = pen.compact(keep)

    # --- host: f64 compact solve only (no full-width passes) ---
    if A_host is None:
        # device gather doubles as the transport for As; reuse it for the
        # compact-slab Lipschitz bound (f32 power iteration, inflated)
        from convex_optimization_tpu.ops.power_iter import spectral_norm_sq

        A_sub_dev = problem.A[:, jnp.asarray(idx)]
        L64 = 1.05 * float(jax.device_get(spectral_norm_sq(A_sub_dev))) \
            + lam2
        As = np.asarray(jax.device_get(A_sub_dev), np.float64)
        del A_sub_dev
    else:
        # with a host copy the device gather would be a pure HBM liability
        # (a (m, kept) buffer next to A and the solver's A_t OOM'd the
        # chip at the config-4 twin, measured); _fista64's backtracking
        # replaces the explicit L
        L64 = None
        As = _gather_cols(A_host, idx)
    b = np.asarray(jax.device_get(problem.b) if b_host is None else b_host,
                   dtype=np.float64)
    xs = np.asarray(jax.device_get(x), np.float64)[idx]

    cushion = float(np.sqrt(2.0 * tol * abs(primal0) * 1.5))
    xs, sub_idx, k, rel, gap, primal, r = _fista64(
        As, b, lam2, pen_s, xs, tol, max_iters, gap_every,
        rescreen_cushion=cushion, L=L64,
    )
    x_full = np.zeros(n, dtype=np.float64)
    x_full[idx[sub_idx]] = xs
    return PolishResult(
        x=x_full, rel_gap=float(rel), gap=float(gap), primal=float(primal),
        kept=int(len(idx)), iterations=k,
        wall_time_s=time.perf_counter() - t0,
    )


def _fista64(As, b, lam2, pen_s, xs, tol, max_iters, gap_every,
             rescreen_cushion: float = 0.0, L: float | None = None):
    """f64 FISTA (adaptive restart) on the compacted problem.  Returns
    (x, keep_idx, iters, rel_gap, gap, primal, r) where keep_idx maps the
    returned (possibly further-compacted) columns to the INPUT columns.

    rescreen_cushion > 0 enables gap-safe RE-SCREENING at every check: the
    radius shrinks with the gap, so columns drop fast as the solve tightens
    and the per-iteration matvec cost collapses toward the true support.
    The cushion (caller passes sqrt(2 * tol * P)-scale) keeps every screen
    valid for the FINAL witness, preserving the certificate-extension
    argument of polish_fast.
    """
    n_s = As.shape[1]
    keep_idx = np.arange(n_s)
    # f32-STORED matrices run with chunked mixed-precision gemvs (f64
    # arithmetic on exactly-representable f32 values): a dense
    # As.astype(f64) copy of a GB-scale slab pays the first-touch
    # page-fault pathology (measured 355 s for 4 iterations at the
    # config-4 twin) and doubles every gemv's stream bytes
    if As.dtype == np.float32:
        matT = lambda v: -_gemv_t_mixed(As, v)      # As.T @ v
        mat = lambda v: _gemv_mixed(As, v)          # As @ v
    else:
        matT = lambda v: As.T @ v
        mat = lambda v: As @ v
    col_norms = np.sqrt(
        np.einsum("ij,ij->j", As, As, dtype=np.float64) + lam2)

    backtrack = L is None
    if backtrack:
        # Backtracking (Beck-Teboulle: L only ever doubles) from the cheap
        # LOWER bound max_j ||A_j||^2 <= ||A||^2, instead of a power
        # iteration of GB-scale f64 passes.  A doubling costs one extra
        # gemv pair; log2(L*/L0) is ~5-8 doublings in practice.
        L = max(float((col_norms ** 2).max()), 1e-12)
    # NOTE: dropping columns never increases the spectral norm, so this L
    # stays a valid (and tight) bound across every re-screening shrink.
    step = 1.0 / L
    x_prev = xs.copy()
    r = mat(xs) - b
    r_prev = r.copy()
    t_mom = 1.0
    k = 0
    rel = gap = primal = np.inf
    while k < max_iters:
        for _ in range(gap_every):
            t_next = 0.5 * (1.0 + np.sqrt(1.0 + 4.0 * t_mom * t_mom))
            beta = (t_mom - 1.0) / t_next
            y = xs + beta * (xs - x_prev)
            r_y = r + beta * (r - r_prev)
            g = matT(r_y) + lam2 * y
            while True:
                x_new = pen_s.prox(y - step * g, step)
                r_new = mat(x_new) - b
                if not backtrack:
                    break
                # majorizer test for the smooth part f = 0.5||.||^2 aug:
                # f(x_new) <= f(y) + <grad f(y), d> + (L/2)||d||^2
                d = x_new - y
                lhs = 0.5 * (r_new @ r_new + lam2 * (x_new @ x_new))
                rhs = (0.5 * (r_y @ r_y + lam2 * (y @ y))
                       + float(g @ d) + 0.5 * L * float(d @ d))
                if lhs <= rhs * (1.0 + 1e-12) + 1e-300:
                    break
                L *= 2.0
                step = 1.0 / L
            if float((y - x_new) @ (x_new - xs)) > 0.0:
                t_next, x_prev, r_prev = 1.0, x_new, r_new
            else:
                x_prev, r_prev = xs, r
            xs, r, t_mom = x_new, r_new, t_next
            k += 1
        zs = -matT(r) - lam2 * xs
        gap, primal, rel, alpha = _gap_from_parts(r, b, lam2, pen_s, xs, zs)
        if rel <= tol:
            break
        if rescreen_cushion > 0.0 and pen_s.kind in ("l1", "nonneg_l1"):
            radius = np.sqrt(2.0 * max(gap, 0.0)) + rescreen_cushion
            w = alpha * zs
            if pen_s.kind == "l1":
                drop = np.abs(w) + radius * col_norms < pen_s.lam1
            else:
                drop = w + radius * col_norms < pen_s.lam1
            if drop.any():
                keep = ~drop
                As = _gather_cols(As, np.nonzero(keep)[0], As.dtype)
                xs, x_prev = xs[keep], x_prev[keep]
                col_norms = col_norms[keep]
                keep_idx = keep_idx[keep]
                # residuals are x-independent of dropped zero coords only
                # if they were zero — they are (provably, by the screen)
                if As.dtype == np.float32:
                    matT = lambda v, A_=As: -_gemv_t_mixed(A_, v)
                    mat = lambda v, A_=As: _gemv_mixed(A_, v)
                else:
                    matT = lambda v, A_=As: A_.T @ v
                    mat = lambda v, A_=As: A_ @ v
                r = mat(xs) - b
                r_prev = r.copy()
                t_mom = 1.0  # restart momentum after the geometry change
                # step stays valid: L(subset) <= L (see note above)
    return xs, keep_idx, k, rel, gap, primal, r


def _gemv_t_mixed(As32, r64, lam2=0.0, xs64=None, chunk=1024):
    """z = -(As^T r) - lam2 x in f64 from f32-stored As, chunked so the
    implicit f32->f64 upcast temp stays ~80 MB (NumPy would otherwise
    materialize a full f64 copy of As per call).  Native GIL-released
    path when the slab layout allows (utils/native.py)."""
    from convex_optimization_tpu.utils import native as co_native

    if (isinstance(As32, np.ndarray)
            and As32.dtype == np.float32 and As32.flags.f_contiguous):
        r64c = np.ascontiguousarray(r64)
        xs_c = None if xs64 is None else np.ascontiguousarray(xs64)
        z = co_native.atr_mixed(As32, r64c, float(lam2), xs_c)
        if z is not None:
            return z
    width = As32.shape[1]
    z = np.empty(width, np.float64)
    for c0 in range(0, width, chunk):
        c1 = min(c0 + chunk, width)
        z[c0:c1] = -(As32[:, c0:c1].astype(np.float64).T @ r64)
    if lam2 != 0.0 and xs64 is not None:
        z -= lam2 * xs64
    return z


def _gemv_mixed(As32, x64, chunk=1024):
    """As @ x in f64 from f32-stored As, chunked over columns so the
    implicit f64 upcast temp stays cache-sized and arena-reused."""
    m, width = As32.shape
    r = np.zeros(m, np.float64)
    for c0 in range(0, width, chunk):
        c1 = min(c0 + chunk, width)
        r += As32[:, c0:c1].astype(np.float64) @ x64[c0:c1]
    return r


def _residual_sparse32(As32, xs64, b64):
    """r = As xs - b in f64 via per-column axpys on the nonzeros of xs —
    streams only the active f32 columns.  Native GIL-released path when
    the slab layout allows (utils/native.py)."""
    from convex_optimization_tpu.utils import native as co_native

    if (isinstance(As32, np.ndarray)
            and As32.dtype == np.float32 and As32.flags.f_contiguous):
        r = co_native.ax_sparse(As32, np.ascontiguousarray(xs64),
                                np.ascontiguousarray(b64))
        if r is not None:
            return r
    r = -b64.copy()
    for j in np.nonzero(xs64)[0]:
        r += xs64[j] * As32[:, j].astype(np.float64)
    return r


def _cd64(As32, b, lam2, pen_s, xs, tol, max_sweeps, gap_every=2,
          rescreen: bool = True):
    """f64 cyclic coordinate descent on the compacted problem — the
    classical lasso "shooting" solver (the algorithm family glmnet/celer
    use for exactly this dense-panel regime).  Returns the same tuple as
    ``_fista64``: (x, keep_idx, sweeps, rel_gap, gap, primal, r).

    Why CD instead of host FISTA for the support solve (measured at the
    10k x 100k headline, |S|=7036):
      * exact per-coordinate Lipschitz ||A_j||^2 + lam2 from the column
        norms — no spectral-norm estimate, no backtracking;
      * As is stored FLOAT32 (the problem data is exactly f32) and each
        column is cast once per visit into a reused cache-resident f64
        buffer, so a sweep streams only 4m bytes per column — half the
        f64 layout's traffic, and the dot + axpy both hit L2;
      * Gauss-Seidel convergence: ~10-25 sweeps from the f32 warm start
        vs ~32 FISTA iterations x 2 full f64 gemv passes (13.4 s).

    The ARITHMETIC is all float64 (f32 values are exactly representable),
    so the certificate math is unchanged.  rescreen=True drops columns by
    the plain gap-safe sphere (radius sqrt(2*gap), exact f64 — no cushion
    needed: the caller recomputes the full-problem certificate from
    scratch, so a drop here can never affect soundness, only the sweep
    width).  l1 / nonneg_l1 only.
    """
    from convex_optimization_tpu.utils import native as co_native

    m, width = As32.shape
    keep_idx = np.arange(width)
    # column norms: einsum with f64 accumulation, no matrix-sized temp
    col_sq = np.einsum("ij,ij->j", As32, As32, dtype=np.float64) + lam2
    col_norms = np.sqrt(col_sq)
    lam1 = pen_s.lam1
    nonneg = pen_s.kind == "nonneg_l1"
    # full copy, not just ascontiguousarray: both sweep paths mutate xs in
    # place, and a contiguous f64 input would otherwise alias the caller's
    # array (review finding — _cd64_group copies for the same reason)
    xs = np.array(xs, np.float64, copy=True)
    r = np.ascontiguousarray(_residual_sparse32(As32, xs, b))
    ajbuf = np.empty(m, np.float64)
    sweeps = 0
    rel = gap = primal = np.inf
    while sweeps < max_sweeps:
        # native path: one C call runs the whole gap_every batch with the
        # GIL released — the NumPy loop pays 3 interpreter calls per
        # column; same f64 update arithmetic, and the gap certificate below
        # is computed identically either way
        if co_native.cd64_sweeps(As32, xs, r, col_sq, float(lam1),
                                 float(lam2), nonneg, gap_every):
            sweeps += gap_every
        else:
            for _ in range(gap_every):
                for j in range(As32.shape[1]):
                    np.copyto(ajbuf, As32[:, j])  # one 4m-byte stream read
                    xj = xs[j]
                    g = float(ajbuf @ r) + lam2 * xj
                    v = xj - g / col_sq[j]
                    tl = lam1 / col_sq[j]
                    if nonneg:
                        xn = v - tl if v > tl else 0.0
                    else:
                        xn = (v - tl if v > tl
                              else (v + tl if v < -tl else 0.0))
                    if xn != xj:
                        r += ajbuf * (xn - xj)    # cache-hot axpy
                        xs[j] = xn
                sweeps += 1
        # exact residual refresh pins incremental f64 drift (negligible
        # per sweep, but cheap relative to the gap-check gemv below)
        r = _residual_sparse32(As32, xs, b)
        zs = _gemv_t_mixed(As32, r, lam2, xs)
        gap, primal, rel, alpha = _gap_from_parts(r, b, lam2, pen_s, xs, zs)
        if rel <= tol:
            break
        if rescreen:
            radius = np.sqrt(2.0 * max(gap, 0.0))
            w = alpha * zs
            drop = ((np.abs(w) + radius * col_norms < lam1)
                    if not nonneg else (w + radius * col_norms < lam1))
            drop &= xs == 0.0
            if drop.any():
                keep = ~drop
                As32 = _gather_cols(As32, np.nonzero(keep)[0], As32.dtype)
                xs = xs[keep]
                col_sq, col_norms = col_sq[keep], col_norms[keep]
                keep_idx = keep_idx[keep]
                # xs unchanged on kept coords and dropped coords were 0,
                # so r is unaffected by the compaction
    return xs, keep_idx, sweeps, rel, gap, primal, r


def _cd64_group(As32, b, lam2, pen_s, xs, tol, max_sweeps, gap_every=2,
                rescreen: bool = True):
    """f64 BLOCK coordinate descent over GROUPS on the compacted
    group-lasso problem — the group analog of ``_cd64`` (block shooting:
    one prox-gradient step per group per visit with the exact block
    Lipschitz, Gauss-Seidel residual updates).  Returns the same tuple as
    ``_fista64``: (x, keep_idx, sweeps, rel_gap, gap, primal, r).

    Why block CD instead of host FISTA for the group support solve
    (VERDICT r2 #3; measured at the config-4 twin, |S|~260 groups):
      * exact per-group Lipschitz lam_max(A_g^T A_g) + lam2 from a cheap
        f32 power iteration on the cache-resident 5 MB group slab — no
        global spectral estimate, no backtracking line search;
      * Gauss-Seidel: the residual the next group sees already contains
        this group's update, so the f32-warm-started solve cleans up in a
        handful of sweeps where momentum FISTA needed ~32 iterations
        (each 2 full mixed-precision gemv passes over the whole slab);
      * the slab stays FLOAT32 (problem data is exactly f32); each group
        is cast once per visit into a reused f64 buffer, so a sweep
        streams the slab from RAM exactly once and both gemvs of the
        visit hit the cached buffer.

    All iterate arithmetic is float64 (f32 values are exactly
    representable), so the caller's certificate math is unchanged.
    rescreen drops whole zero groups by the gap-safe group sphere
    (exact f64; sound for the same reason as in ``_cd64``: the caller
    recomputes the full-problem certificate from scratch).
    """
    m, width = As32.shape
    ng = pen_s.ngroups
    gsize = width // ng
    lam1 = pen_s.lam1
    w = pen_s.w.copy()
    keep_idx = np.arange(width)
    xs = xs.copy()
    r = _residual_sparse32(As32, xs, b)

    # per-column squared norms (f64 accumulation) -> group Frobenius
    # norms for the screen; exact block Lipschitz via f32 power iteration
    # per group (L only affects step sizes, never the certificate, so f32
    # accuracy + 2% inflation is enough; 8 iterations on a cache-resident
    # slab cost ~16 sgemv passes over 5 MB)
    from convex_optimization_tpu.utils import native as co_native

    col_sq = np.einsum("ij,ij->j", As32, As32, dtype=np.float64)
    # exact block Lipschitz via power iteration per group — GIL-released
    # native path (one call for all groups) with a NumPy fallback.  Both
    # use the deterministic ones+tilt start (orthogonality to the top
    # singular vector has measure zero; the tilt breaks symmetry), so L
    # does not depend on which path ran beyond f32-vs-f64 iteration
    # rounding — and L only affects step sizes, never the certificate.
    L = co_native.group_power_l(As32, gsize, iters=8, safety=1.02,
                                lam2=lam2)
    if L is None:
        L = np.empty(ng)
        for g in range(ng):
            Ag = As32[:, g * gsize:(g + 1) * gsize]
            v = (1.0 + 0.01 * np.arange(gsize) / gsize).astype(np.float32)
            v /= np.linalg.norm(v)
            for _ in range(8):
                u = Ag.T @ (Ag @ v)
                v = u / max(np.linalg.norm(u), 1e-30)
            u = Ag @ v
            L[g] = 1.02 * float(u.astype(np.float64) @ u) + lam2
    # floor: an all-zero group slab with lam2 == 0 yields L[g] == 0, and
    # the prox division below would NaN-poison the iterate (the certificate
    # would catch it, but only after burning max_sweeps — ADVICE r3)
    L = np.maximum(L, 1e-30)

    gbuf = np.empty((m, gsize), np.float64, order="F")
    w = np.ascontiguousarray(w, np.float64)
    xs = np.ascontiguousarray(xs, np.float64)
    r = np.ascontiguousarray(r)
    sweeps = 0
    rel = gap = primal = np.inf
    prev_primal = np.inf
    while sweeps < max_sweeps:
        # native path (round 3): whole gap_every batch in one GIL-released
        # C call (same rationale + identical update arithmetic as _cd64's)
        if co_native.cd64_group_sweeps(As32, gsize, xs, r,
                                       np.ascontiguousarray(L), w,
                                       float(lam1), float(lam2),
                                       gap_every):
            sweeps += gap_every
        else:
            for _ in range(gap_every):
                for g in range(ng):
                    sl = slice(g * gsize, (g + 1) * gsize)
                    np.copyto(gbuf, As32[:, sl])  # one stream slab read
                    xg = xs[sl]
                    grad = gbuf.T @ r + lam2 * xg
                    v = xg - grad / L[g]
                    nv = float(np.linalg.norm(v))
                    s = max(0.0,
                            1.0 - lam1 * w[g] / (L[g] * max(nv, 1e-300)))
                    xn = s * v
                    dx = xn - xg
                    if np.any(dx):
                        r += gbuf @ dx         # cache-hot (gbuf just read)
                        xs[sl] = xn
                sweeps += 1
        # exact refresh pins incremental drift; one mixed gemv for the gap
        r = _residual_sparse32(As32, xs, b)
        zs = _gemv_t_mixed(As32, r, lam2, xs)
        gap, primal, rel, alpha = _gap_from_parts(r, b, lam2, pen_s, xs, zs)
        if rel <= tol:
            break
        # Lipschitz safeguard (ADVICE r3): the 8-step power iteration is a
        # LOWER-bound estimate of lam_max(Ag^T Ag); a group with a tight
        # spectral gap can get an L that makes its prox step
        # non-contractive.  A non-decreasing f64 primal between exact gap
        # checks is the signature — halve the steps by doubling L
        # (convergence-only; the certificate math never touches L).
        if primal > prev_primal * (1.0 + 1e-12):
            L = L * 2.0
        prev_primal = min(prev_primal, primal)
        if rescreen and ng > 1:
            radius = np.sqrt(2.0 * max(gap, 0.0))
            wit = (alpha * zs).reshape(ng, gsize)
            gn = np.linalg.norm(wit, axis=1)
            gcol = np.sqrt(col_sq.reshape(ng, gsize).sum(axis=1) +
                           lam2 * gsize)
            gdrop = gn + radius * gcol < lam1 * w
            gdrop &= ~(xs.reshape(ng, gsize).any(axis=1))
            if gdrop.any():
                gkeep = ~gdrop
                keep = np.repeat(gkeep, gsize)
                As32 = _gather_cols(As32, np.nonzero(keep)[0], As32.dtype)
                xs = xs[keep]
                col_sq = col_sq[keep]
                keep_idx = keep_idx[keep]
                L, w = L[gkeep], w[gkeep]
                ng = int(gkeep.sum())
                pen_s = _NpPenalty("group_l2", lam1, ng, w, ng * gsize)
                # dropped groups were identically 0, so r is unaffected
    return xs, keep_idx, sweeps, rel, gap, primal, r


@jax.jit
def _witness_colnorms_dev(A, r32, lam2):
    """ONE device program for the full-width f32 pieces of the support
    certificate: the dual witness A^T r and the column norms, folded into
    a single jit (one full-size program, one compile).

    The witness must stay on the DEVICE: XLA reduces with O(log m) tree
    depth, which is what the (ceil(log2 m)+4)*eps margin assumes.  A host
    BLAS sgemv accumulates in O(m/width) partial sums — its rounding error
    would exceed the margin ~100x at m=10k, making the certificate unsound.
    """
    # r @ A, not A.T @ r: the product needs no transposed copy of A
    z = -jnp.dot(r32, A, precision=jax.lax.Precision.HIGHEST)
    cn = jnp.sqrt(jnp.sum(A * A, axis=0) + lam2)
    return z, cn


def polish_support(problem, x, *, tol: float = 1e-6,
                   max_iters: int = 20_000, gap_every: int = 4,
                   A_host: np.ndarray | None = None,
                   b_host: np.ndarray | None = None,
                   max_expand: int = 3, verbose: bool = False) -> PolishResult:
    """Support-restricted certified refinement — the fast path for large n.

    polish_fast's cost is the f64 solve over the gap-safe KEPT set, which
    can be 5x the true support (measured: 26k kept vs ~5k support at
    10k x 100k, 7 minutes of host f64 matvecs).  This variant instead:

      1. restricts the f64 solve to the f32 solution's SUPPORT (plus any
         later expansions) — typically a slight superset of the true
         support, so the restricted optimum usually IS the optimum;
      2. certifies on the FULL problem with a conservative dual norm:
         exact f64 on the support, f32-with-deterministic-rounding-margin
         on every other column (computed on DEVICE at HBM speed).  The
         margined bound can only INFLATE the measured gap, so a
         certificate that passes is sound;
      3. if the certificate misses tol (support was too small), expands
         the support with the columns whose margined dual witness is
         closest to the boundary and repeats.

    group_l2 is routed to the GROUP-wise variant below (restriction by
    support groups): gap-safe group screening is hopeless here — the
    sqrt(gsize) aggregation in the group sphere test kept ALL 131072
    columns at the config-4 twin (334 s of full-width host f64), while
    the support-group restriction touches ~5% of them.
    """
    import jax.numpy as jnp

    if problem.penalty.kind == "group_l2":
        return _polish_support_group(
            problem, x, tol=tol, max_iters=max_iters, gap_every=gap_every,
            A_host=A_host, b_host=b_host, max_expand=max_expand,
            verbose=verbose)
    if problem.penalty.kind not in ("l1", "nonneg_l1"):
        return polish_fast(problem, x, tol=tol, max_iters=max_iters,
                           gap_every=gap_every, A_host=A_host,
                           b_host=b_host)

    t0 = time.perf_counter()
    m, n = problem.A.shape
    lam1 = float(jax.device_get(jnp.asarray(problem.penalty.lam1)))
    lam2 = float(problem.lam2)
    pen = _NpPenalty(problem.penalty.kind, lam1, 0, None, n)
    b = np.asarray(jax.device_get(problem.b) if b_host is None else b_host,
                   dtype=np.float64)

    x_np = np.asarray(jax.device_get(x), np.float64)
    S = np.nonzero(x_np)[0]
    if len(S) == 0:
        S = np.array([0])

    # deterministic f32 margin for the device-side dual-witness pass
    eps = float(np.finfo(np.float32).eps)
    gamma = (np.ceil(np.log2(max(m, 2))) + 4) * eps

    def tick(label, t_prev):
        # Wall AND this-thread CPU AND minor-fault deltas tell a slow
        # gather's causes apart: cpu ~= wall with a huge fault delta =>
        # page-fault/THP-compaction storm (kernel time bills to the
        # faulting thread); cpu << wall => this thread was descheduled.
        now = time.perf_counter()
        cpu_now = time.thread_time()
        flt_now = resource.getrusage(resource.RUSAGE_THREAD).ru_minflt
        if verbose:
            import sys

            prev = getattr(tick, "_prev", None)
            note = ("" if prev is None else
                    f" (cpu +{cpu_now - prev[0]:.2f}s"
                    f" minflt +{flt_now - prev[1]})")
            print(f"  polish[{label}] +{now - t_prev:.2f}s{note}",
                  file=sys.stderr)
        tick._prev = (cpu_now, flt_now)
        return now

    tp = tick("setup", t0)

    best = None
    for _round in range(max_expand + 1):
        # f32 STORAGE (half the gather bytes and half the sweep traffic);
        # all arithmetic downstream is f64 on exactly-representable values
        if A_host is None:
            As = np.asarray(
                jax.device_get(problem.A[:, jnp.asarray(S)]), np.float32,
                order="F")
        else:
            As = _gather_cols(A_host, S, np.float32)
        tp = tick(f"gather(|S|={len(S)},{_last_gather_path})", tp)
        S_full = S
        pen_s = _NpPenalty(pen.kind, lam1, 0, None, len(S))
        xs = x_np[S]
        # f64 cyclic coordinate descent (see _cd64: exact per-column
        # Lipschitz, ~1.2-1.5 passes/sweep, GS convergence) with plain
        # gap-safe re-screening — drops here can never affect soundness
        # (the full certificate below is recomputed from scratch), only
        # the per-sweep width.
        xs, sub_idx, k, _, _, _, r = _cd64(
            As, b, lam2, pen_s, xs, tol * 0.5, max_iters)
        S = S[sub_idx]
        tp = tick(f"cd64(sweeps={k})", tp)

        # FULL-problem certificate with the conservative dual norm:
        #   exact f64 on the gathered set; device f32 + margin elsewhere
        r_dev = jnp.asarray(r, jnp.float32)
        z_dev, cn_dev = _witness_colnorms_dev(problem.A, r_dev, lam2)
        z_f32 = np.asarray(jax.device_get(z_dev), np.float64)
        cn_safe = (np.asarray(jax.device_get(cn_dev), np.float64)
                   * (1.0 + 4 * eps) + 1e-12)
        tp = tick("device-witness", tp)
        if lam2 != 0.0:
            xfull32 = np.zeros(n, np.float32)
            xfull32[S] = xs.astype(np.float32)
            z_f32 -= lam2 * xfull32
        r_norm = float(np.linalg.norm(r))
        margin = gamma * cn_safe * r_norm
        ub = (np.abs(z_f32) + margin if pen.kind == "l1"
              else np.maximum(z_f32 + margin, 0.0))
        # exact f64 witnesses on the FULL gathered set (S_full superset of
        # the possibly-rescreened S): As already lives in memory, and exact
        # values there can only tighten the dual bound
        x_sf = np.zeros(len(S_full), np.float64)
        x_sf[sub_idx] = xs
        z_S = _gemv_t_mixed(As, r, lam2, x_sf)
        ub[S_full] = np.abs(z_S) if pen.kind == "l1" \
            else np.maximum(z_S, 0.0)

        def certify(ub_now):
            # optimal feasible alpha on the residual ray (see
            # _gap_from_parts); ub_now upper-bounds the dual norm, so the
            # feasibility cap lam1/ub is conservative
            feas = lam1 / max(float(ub_now.max()), 1e-300)
            aug = float(r @ r + lam2 * (xs @ xs))
            alpha = min(max(float(-(r @ b)) / max(aug, 1e-300), 0.0), feas)
            primal = 0.5 * aug + float(pen_s.value(xs))
            dual = alpha * float(-(r @ b)) - 0.5 * alpha * alpha * aug
            gap = primal - dual
            rel = gap / max(abs(primal), np.finfo(np.float64).tiny)
            return rel, gap, primal

        rel, gap, primal = certify(ub)
        if rel > tol:  # noqa: placeholder (refined below)
            # the f32 margin may be the only thing pushing near-boundary
            # columns over: replace their witnesses with exact f64 values
            # (a host gather of just those columns) before expanding
            near = np.setdiff1d(
                np.nonzero(ub >= lam1 * (1.0 - 1e-6))[0], S_full)
            if len(near) > 8192:
                # bound the exact-refinement gather: only the columns whose
                # margined witness is largest can decide the dual norm
                near = near[np.argsort(-ub[near])[:8192]]
            if len(near):
                A_near = (np.asarray(jax.device_get(
                              problem.A[:, jnp.asarray(near)]), np.float32,
                              order="F")
                          if A_host is None
                          else _gather_cols(A_host, near, np.float32))
                z_near = _gemv_t_mixed(A_near, r)
                tp = tick(f"near-exact(|near|={len(near)})", tp)
                ub[near] = (np.abs(z_near) if pen.kind == "l1"
                            else np.maximum(z_near, 0.0))
                rel, gap, primal = certify(ub)
        if best is None or rel < best[3]:
            best = (xs.copy(), S.copy(), k, rel, gap, primal)
        if rel <= tol:
            break
        # expand with the genuinely-violating / nearest-boundary columns
        outside = np.setdiff1d(np.nonzero(ub >= lam1 * (1.0 - 1e-9))[0], S)
        if len(outside) == 0:
            # np.setdiff1d sorts by index — rank candidates by witness
            cand = np.setdiff1d(np.argsort(-ub)[:2 * len(S)], S)
            if len(cand) == 0:
                break
            outside = cand[np.argsort(-ub[cand])[:len(S)]]
        x_np = np.zeros(n, np.float64)
        x_np[S] = xs
        S = np.sort(np.concatenate([S, outside]))

    xs, S, k, rel, gap, primal = best
    x_full = np.zeros(n, dtype=np.float64)
    x_full[S] = xs
    return PolishResult(
        x=x_full, rel_gap=float(rel), gap=float(gap), primal=float(primal),
        kept=int(len(S)), iterations=k,
        wall_time_s=time.perf_counter() - t0,
    )


def _polish_support_group(problem, x, *, tol, max_iters, gap_every,
                          A_host, b_host, max_expand,
                          verbose) -> PolishResult:
    """Group-wise support-restricted certified refinement (group_l2).

    Same architecture as polish_support with GROUPS as the restriction
    unit: solve f64 on the support groups (plus expansions), certify on
    the full problem with a conservative group dual norm — exact f64 on
    the gathered groups, f32-with-margin elsewhere, where the margined
    per-column bound |z_j| + m_j gives a sound group upper bound
    sqrt(sum (|z_j|+m_j)^2) >= ||z_g||.
    """
    import jax.numpy as jnp

    t0 = time.perf_counter()
    m, n = problem.A.shape
    lam1 = float(jax.device_get(jnp.asarray(problem.penalty.lam1)))
    lam2 = float(problem.lam2)
    ngroups = problem.penalty.ngroups
    gsize = n // ngroups
    weights = problem.penalty.weights
    w = (np.ones(ngroups) if weights is None
         else np.asarray(jax.device_get(weights), np.float64))
    pen = _NpPenalty("group_l2", lam1, ngroups, w, n)
    b = np.asarray(jax.device_get(problem.b) if b_host is None else b_host,
                   dtype=np.float64)

    def tick(label, t_prev):
        # Wall AND this-thread CPU AND minor-fault deltas tell a slow
        # gather's causes apart: cpu ~= wall with a huge fault delta =>
        # page-fault/THP-compaction storm (kernel time bills to the
        # faulting thread); cpu << wall => this thread was descheduled.
        now = time.perf_counter()
        cpu_now = time.thread_time()
        flt_now = resource.getrusage(resource.RUSAGE_THREAD).ru_minflt
        if verbose:
            import sys

            prev = getattr(tick, "_prev", None)
            note = ("" if prev is None else
                    f" (cpu +{cpu_now - prev[0]:.2f}s"
                    f" minflt +{flt_now - prev[1]})")
            print(f"  polish[{label}] +{now - t_prev:.2f}s{note}",
                  file=sys.stderr)
        tick._prev = (cpu_now, flt_now)
        return now

    tp = tick("setup", t0)
    x_np = np.asarray(jax.device_get(x), np.float64)
    G = np.nonzero(x_np.reshape(ngroups, gsize).any(axis=1))[0]
    if len(G) == 0:
        G = np.array([0])

    eps = float(np.finfo(np.float32).eps)
    gamma = (np.ceil(np.log2(max(m, 2))) + 4) * eps

    best = None
    for _round in range(max_expand + 1):
        cols = (G[:, None] * gsize + np.arange(gsize)[None, :]).reshape(-1)
        if A_host is None:
            As = np.asarray(
                jax.device_get(problem.A[:, jnp.asarray(cols)]), np.float32,
                order="F")
        else:
            As = _gather_cols(A_host, cols, np.float32)
        tp = tick(f"gather(|G|={len(G)},{_last_gather_path})", tp)
        pen_s = _NpPenalty("group_l2", lam1, len(G), w[G], len(cols))
        xs = x_np[cols]
        # f64 block CD over groups (round-3, VERDICT r2 #3): exact block
        # Lipschitz + Gauss-Seidel cleans up the f32 warm start in a few
        # sweeps where the momentum FISTA it replaced needed ~32
        # iterations x 2 mixed-precision passes (15 s at the config-4
        # twin).  The slab stays f32 (a dense As.astype(f64) copy
        # measured 355 s of first-touch page faults for 4 iterations).
        xs, sub_idx, k, _, _, _, r = _cd64_group(
            As, b, lam2, pen_s, xs, tol * 0.5, max_sweeps=max_iters,
            gap_every=gap_every)
        tp = tick(f"cd64_group(sweeps={k}, kept={len(sub_idx)})", tp)

        # full-problem certificate: f32 witness + margin per column on the
        # device, group-aggregated upper bound; exact f64 on gathered cols
        r_dev = jnp.asarray(r, jnp.float32)
        z_dev, cn_dev = _witness_colnorms_dev(problem.A, r_dev, lam2)
        z_f32 = np.asarray(jax.device_get(z_dev), np.float64)
        cn_safe = (np.asarray(jax.device_get(cn_dev), np.float64)
                   * (1.0 + 4 * eps) + 1e-12)
        tp = tick("device-witness", tp)
        # scatter back through sub_idx: the group CD may have compacted
        # zero groups, so xs indexes a SUBSET of the gathered columns
        x_cols = np.zeros(len(cols), np.float64)
        x_cols[sub_idx] = xs
        if lam2 != 0.0:
            xfull32 = np.zeros(n, np.float32)
            xfull32[cols] = x_cols.astype(np.float32)
            z_f32 -= lam2 * xfull32
        r_norm = float(np.linalg.norm(r))
        zbar = np.abs(z_f32) + gamma * cn_safe * r_norm
        z_S = _gemv_t_mixed(As, r, lam2, x_cols)   # exact f64, gathered cols
        zbar[cols] = np.abs(z_S)
        ub_g = np.sqrt((zbar ** 2).reshape(ngroups, gsize).sum(axis=1))

        def certify(ub_now):
            # optimal feasible alpha on the residual ray (_gap_from_parts).
            # x_cols (NOT xs): the group CD may have compacted zero groups
            # out of xs, while pen_s/aug need the full gathered layout —
            # values are identical since dropped groups are exactly 0.
            feas = lam1 / max(float(np.max(ub_now / w)), 1e-300)
            aug = float(r @ r + lam2 * (x_cols @ x_cols))
            alpha = min(max(float(-(r @ b)) / max(aug, 1e-300), 0.0), feas)
            primal = 0.5 * aug + float(pen_s.value(x_cols))
            dual = alpha * float(-(r @ b)) - 0.5 * alpha * alpha * aug
            gap = primal - dual
            rel = gap / max(abs(primal), np.finfo(np.float64).tiny)
            return rel, gap, primal

        rel, gap, primal = certify(ub_g)
        if rel > tol:
            # exact-refine near-boundary groups (the f32 margin may be the
            # only thing pushing them over)
            near = np.setdiff1d(
                np.nonzero(ub_g >= lam1 * w * (1.0 - 1e-6))[0], G)
            if len(near) > 64:
                near = near[np.argsort(-(ub_g / w)[near])[:64]]
            if len(near):
                ncols = (near[:, None] * gsize
                         + np.arange(gsize)[None, :]).reshape(-1)
                A_near = (np.asarray(jax.device_get(
                              problem.A[:, jnp.asarray(ncols)]), np.float32,
                              order="F")
                          if A_host is None
                          else _gather_cols(A_host, ncols, np.float32))
                z_near = np.abs(_gemv_t_mixed(A_near, r))
                tp = tick(f"near-exact(|near|={len(near)})", tp)
                ub_g[near] = np.sqrt(
                    (z_near ** 2).reshape(len(near), gsize).sum(axis=1))
                rel, gap, primal = certify(ub_g)
        if best is None or rel < best[3]:
            best = (x_cols.copy(), cols.copy(), k, rel, gap, primal)
        if rel <= tol:
            break
        outside = np.setdiff1d(
            np.nonzero(ub_g >= lam1 * w * (1.0 - 1e-9))[0], G)
        if len(outside) == 0:
            cand = np.setdiff1d(np.argsort(-(ub_g / w))[:2 * len(G)], G)
            if len(cand) == 0:
                break
            outside = cand[:max(len(G) // 2, 1)]
        x_np = np.zeros(n, np.float64)
        x_np[cols] = x_cols
        G = np.sort(np.concatenate([G, outside]))

    x_cols, cols, k, rel, gap, primal = best
    x_full = np.zeros(n, dtype=np.float64)
    x_full[cols] = x_cols
    return PolishResult(
        x=x_full, rel_gap=float(rel), gap=float(gap), primal=float(primal),
        kept=int(len(cols)), iterations=k,
        wall_time_s=time.perf_counter() - t0,
    )


def polish(problem, x, *, tol: float = 1e-6, max_iters: int = 20_000,
           gap_every: int = 10, A_host: np.ndarray | None = None,
           b_host: np.ndarray | None = None) -> PolishResult:
    """Refine a solution to an f64-certified relative gap <= tol.

    This variant computes the FULL-problem f64 certificate explicitly (two
    chunked host passes over A).  ``polish_fast`` reaches the same
    certificate via the safe-screening extension with zero full passes —
    use it when A is large; this one remains the belt-and-braces oracle
    (tests check they agree).

    Pass A_host/b_host (host copies of the problem data) when available —
    fetching a multi-GB design matrix back through a device transport can
    otherwise dominate this phase's wall time.
    """
    t0 = time.perf_counter()
    # A stays float32 in host memory; chunks are cast to f64 on the fly
    # (a full f64 copy would double both the bytes and the passes — this
    # host is memory-bandwidth-bound, so passes over A ARE the cost).
    A = (np.asarray(jax.device_get(problem.A)) if A_host is None
         else np.asarray(A_host))
    b = np.asarray(jax.device_get(problem.b) if b_host is None else b_host,
                   dtype=np.float64)
    x0 = np.asarray(jax.device_get(x), dtype=np.float64)
    lam1 = float(jax.device_get(jnp.asarray(problem.penalty.lam1)))
    lam2 = float(problem.lam2)
    weights = problem.penalty.weights
    w = None if weights is None else np.asarray(jax.device_get(weights))
    n = A.shape[1]
    pen = _NpPenalty(problem.penalty.kind, lam1, problem.penalty.ngroups, w, n)

    # 1-2: screen at x0 (f64 certificate) and compact.  FULL PASS 1 over A.
    r0 = _sparse_residual(A, x0, b)
    z, col_norms = _witness_and_colnorms(A, r0, lam2, x0)
    gap0, _, rel0, alpha = _gap_from_parts(r0, b, lam2, pen, x0, z)
    keep = pen.keep_mask(z, alpha, gap0, col_norms)
    keep, pen_s = pen.compact(keep)
    idx = np.nonzero(keep)[0]
    if len(idx) == 0:
        keep[:1] = True     # x* = 0 certified; see polish_fast's guard
        idx = np.array([0])
        keep, pen_s = pen.compact(keep)
    As = _gather_cols(A, idx)
    xs_init = x0[idx]

    xs, sub_idx, k, rel, gap, primal, r = _fista64(
        As, b, lam2, pen_s, xs_init, tol, max_iters, gap_every)
    idx = idx[sub_idx]

    # 4: scatter back, certify on the FULL problem.  FULL PASS 2 over A
    # (dual feasibility must be checked on every column, kept or not).
    x_full = np.zeros(n, dtype=np.float64)
    x_full[idx] = xs
    z_f, _ = _witness_and_colnorms(A, r, lam2, x_full, need_colnorms=False)
    gap_f, primal_f, rel_f, _ = _gap_from_parts(r, b, lam2, pen, x_full, z_f)
    return PolishResult(
        x=x_full, rel_gap=float(rel_f), gap=float(gap_f),
        primal=float(primal_f), kept=int(len(idx)), iterations=k,
        wall_time_s=time.perf_counter() - t0,
    )
