"""K-fold cross-validation over the warm-started lambda path — the model-
selection driver that completes the λ-path story (SURVEY.md C10/§3.5: the
reference family's standard workflow is "solve a λ grid, pick λ by
held-out error"; the reference itself stops at the grid, so this is a
capability extension, not a parity item).

Design:
  * folds are ROW MASKS, not gathers: the fold-f training problem is the
    original problem with validation rows zeroed (A_f = mask ⊙ A,
    b_f = mask ⊙ b) — zero rows contribute nothing to the smooth term, so
    this is EXACTLY the lasso on the training subset, with every shape
    unchanged;
  * the masks ride the batched sweep's residual rows
    ((M⊙A)x = M⊙(Ax) and (M⊙A)ᵀr = Aᵀ(M⊙r), so gating the residual
    updates with the mask sweeps the masked problem exactly): every fold
    path shares ONE device-resident A — no masked copies, one A_t hoist for
    all folds + refit (prepare_batched_solver);
  * validation error reads A_t too: one batched product
    (ax_minus_b_batch_t) scores all path points of a fold at once;
  * the λ grid is computed ONCE from the full data (glmnet convention) so
    per-fold validation curves align point-for-point; each fold solves at
    λ · (m_train/m) because the UNNORMALIZED 0.5‖Ax-b‖² data-fit term of a
    fold has only m_train rows — without the scale, folds are
    over-regularized by ~k/(k-1) relative to the full-data refit;
  * folds and λs are DATA to a handful of compiled programs: all k fold
    paths and the refit reuse the same jitted chunk programs.

``method='bcd_batch'`` (the default) is this route.  Any other method falls
back to per-fold masked COPIES of A (k full-size elementwise programs + a
validation matmul), which costs k extra copies of A in device memory.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from convex_optimization_tpu.core.problem import Problem
from convex_optimization_tpu.core.objective import lambda_max
from convex_optimization_tpu.solvers.common import SolverConfig
from convex_optimization_tpu.solvers.lambda_path import lambda_path


class CVResult(NamedTuple):
    lambdas: jax.Array        # (L,) shared grid (from the FULL data)
    val_mse: jax.Array        # (k, L) per-fold held-out mean squared error
    mean_mse: jax.Array       # (L,) mean across folds
    se_mse: jax.Array         # (L,) standard error across folds
    best_index: int           # argmin of mean_mse
    best_lambda: float
    one_se_index: int         # largest λ within 1 SE of the minimum
    one_se_lambda: float      # (the sparser "1-SE rule" choice)
    x: jax.Array | None       # full-data refit at best_lambda (refit=True)
    x_one_se: jax.Array | None  # full-data refit at one_se_lambda
    method_used: str = "bcd_batch"  # solver that actually ran the folds


def kfold_train_masks(m: int, k: int, seed: int = 0) -> np.ndarray:
    """(k, m) float32 train masks: mask[f, i] == 0 iff row i is fold f's
    validation row.  Every row is a validation row in exactly one fold
    (sizes differ by at most 1 when k does not divide m); the permutation
    is deterministic in ``seed``."""
    if not 2 <= k <= m:
        raise ValueError(f"need 2 <= k <= m, got k={k}, m={m}")
    perm = np.random.default_rng(seed).permutation(m)
    masks = np.ones((k, m), np.float32)
    for f in range(k):
        masks[f, perm[f::k]] = 0.0
    return masks


def fold_lambda_scale(mask: np.ndarray) -> float:
    """m_train / m: the factor that makes a fold's λ comparable to the
    full-data λ at the same grid point under the UNNORMALIZED data-fit
    0.5‖Ax-b‖² (glmnet's shared-grid convention assumes per-observation
    1/(2N) loss normalization; this objective lacks it, so the grid must
    shrink with the row count instead — ADVICE r4)."""
    return float(np.sum(mask)) / mask.shape[-1]


@jax.jit
def _val_mse_kernel(A_t, X, b, val_mask):
    """Held-out MSE for a chunk of path points: ONE pass of A_t computes
    R = A X - b rows for every point (ops/matvec.ax_minus_b_batch_t),
    masked to the fold's validation rows.  X (n_blocks, Lc, B)."""
    from convex_optimization_tpu.ops.matvec import ax_minus_b_batch_t

    R = ax_minus_b_batch_t(A_t, X, b)
    w = val_mask[None, :]
    return jnp.sum(w * R * R, axis=1) / jnp.sum(val_mask)


def cv_lambda_path(
    problem: Problem,
    cfg: SolverConfig,
    *,
    k: int = 5,
    path_len: int = 10,
    lam_min_frac: float = 0.01,
    lambdas: jax.Array | None = None,
    seed: int = 0,
    method: str = "bcd_batch",
    refit: bool = True,
    free_A: bool = False,
) -> CVResult:
    """K-fold CV over a warm-started λ path; picks λ by held-out MSE.

    Returns both the MSE-minimizing λ and the "1-SE rule" λ (the largest
    λ whose mean MSE is within one standard error of the minimum — the
    standard sparser choice).  ``refit=True`` re-solves the FULL problem
    at each chosen λ (warm-started from λ_max side as usual).

    With the default ``method='bcd_batch'`` every program reads the
    transposed layout and all folds share one device-resident A (module
    docstring).  Other methods run per-fold masked copies.

    ``free_A=True`` (bcd_batch only) DELETES the device buffer of
    ``problem.A`` once the transposed A_t hoist exists — that route never
    reads A again (NaN-audit-tested), so dropping A halves the device
    memory the CV holds.  The caller's ``problem.A`` becomes unusable (any
    later device read raises)."""
    m = problem.m
    if lambdas is not None:
        # problem dtype: an f64 grid (x64-enabled hosts) would promote the
        # solver carry and break the while_loop's fixed carry type
        lambdas = jnp.asarray(lambdas, problem.dtype)

    masks = kfold_train_masks(m, k, seed)
    # per-fold λ scale (ADVICE r4): the fold's unnormalized data-fit has
    # m_train rows, the full data m — solve the fold at λ·(m_train/m) so
    # fold curves are comparable to the full-data refit at grid point l
    scales = [fold_lambda_scale(masks[f]) for f in range(k)]

    method_used = method
    prep = None
    if method == "bcd_batch":
        # the grid is computed on the hoisted A_t (λ_max needs no A)
        val_mse, method_used, prep, lambdas = _cv_folds_kernel_routed(
            problem, cfg, lambdas, masks, scales,
            lam_min_frac=lam_min_frac, path_len=path_len, free_A=free_A)
    else:
        lambdas = _full_grid(problem, lambdas, lam_min_frac, path_len)
        val_mse = _cv_folds_masked_copy(
            problem, cfg, lambdas, masks, scales, method)
    mean_mse = jnp.mean(val_mse, axis=0)
    # standard error of the fold mean
    se_mse = jnp.std(val_mse, axis=0, ddof=1) / np.sqrt(k)

    best = int(jnp.argmin(mean_mse))
    thresh = mean_mse[best] + se_mse[best]
    # λs are descending: the first index within threshold is the LARGEST λ
    within = np.asarray(jax.device_get(mean_mse <= thresh))
    one_se = int(np.argmax(within))

    x = x1 = None
    if refit:
        # full-data path down to the chosen λ reuses warm starts; a path
        # is cheaper than two cold solves and both chosen λs lie on it
        if method == "bcd_batch" and prep is not None:
            from convex_optimization_tpu.solvers.batched_path import (
                batched_lambda_path,
            )

            pr_full = batched_lambda_path(problem, cfg, lambdas=lambdas,
                                          prepared=prep)
        else:
            # gate-failed kernel route already warned once; don't warn
            # again on the refit — go straight to the substituted solver
            refit_method = ("bcd_pallas" if method == "bcd_batch"
                            else method)
            pr_full = lambda_path(problem, cfg, lambdas=lambdas,
                                  method=refit_method)
        x = pr_full.xs[best]
        x1 = pr_full.xs[one_se]

    return CVResult(
        lambdas=lambdas, val_mse=val_mse, mean_mse=mean_mse, se_mse=se_mse,
        best_index=best, best_lambda=float(lambdas[best]),
        one_se_index=one_se, one_se_lambda=float(lambdas[one_se]),
        x=x, x_one_se=x1, method_used=method_used,
    )


def _full_grid(problem, lambdas, lam_min_frac, path_len):
    """Default λ grid from the FULL data."""
    if lambdas is None:
        lmax = lambda_max(problem.A, problem.b, problem.penalty)
        lambdas = jnp.geomspace(0.95 * lmax, lam_min_frac * lmax, path_len)
    return jnp.asarray(lambdas, problem.dtype)


def _cv_folds_kernel_routed(problem, cfg, lambdas, masks, scales, *,
                            lam_min_frac, path_len, free_A):
    """All k fold paths through the batched sweep: one A_t hoist, fold
    masks as data, and the λ grid (at ``lambdas=None``) from A_t as well.
    Returns (val_mse, method_used, prepared-solver-or-None, lambdas) — the
    refit reuses the prepared solver.  Falls back to the masked-copy route
    (with a warning) when the batched sweep's gate fails."""
    from convex_optimization_tpu.core.objective import lambda_max_t
    from convex_optimization_tpu.ops.route import MAX_BATCH
    from convex_optimization_tpu.solvers.batched_path import (
        batched_lambda_path,
        prepare_batched_solver,
    )

    L = path_len if lambdas is None else int(lambdas.shape[0])
    k = masks.shape[0]
    n_chunks = -(-L // MAX_BATCH)
    chunk = -(-L // n_chunks)

    prep = prepare_batched_solver(problem, cfg, chunk=chunk)
    if prep.reason is not None:
        warnings.warn(
            f"bcd_batch gate failed ({prep.reason}); CV falling back to "
            f"per-fold masked copies with the sequential bcd_pallas path",
            stacklevel=3)
        lambdas = _full_grid(problem, lambdas, lam_min_frac, path_len)
        return (_cv_folds_masked_copy(problem, cfg, lambdas, masks, scales,
                                      "bcd_pallas"),
                "bcd_pallas+masked_copy", None, lambdas)

    if lambdas is None:
        lmax = lambda_max_t(prep.A_t, problem.b, problem.penalty)
        lambdas = jnp.geomspace(0.95 * lmax, lam_min_frac * lmax,
                                path_len).astype(problem.dtype)
    if free_A and hasattr(problem.A, "delete"):
        # A_t is hoisted and every downstream program reads it; drop the
        # original so folds + refit hold half the device memory
        problem.A.delete()

    nb, B = prep.n_blocks, prep.B
    val_rows = []
    for f in range(k):
        tm = jnp.asarray(masks[f])
        pr = batched_lambda_path(problem, cfg, lambdas=lambdas * scales[f],
                                 row_mask=tm, prepared=prep)
        # validation: score the fold's path points in the same
        # <= MAX_BATCH chunks (<= 2 program shapes, shared by folds)
        vals = []
        for c0 in range(0, L, chunk):
            Xc = pr.xs[c0:c0 + chunk].reshape(-1, nb, B).transpose(1, 0, 2)
            vals.append(_val_mse_kernel(prep.A_t, Xc, problem.b, 1.0 - tm))
        val_rows.append(jnp.concatenate(vals))
    return jnp.stack(val_rows), "bcd_batch", prep, lambdas


def _cv_folds_masked_copy(problem, cfg, lambdas, masks, scales, method):
    """Per-fold masked copies of (A, b) + a validation matmul — the route
    for non-batch methods."""
    k = masks.shape[0]

    # one jitted validation scorer reused across folds (shapes static):
    # R = Xs @ A^T - b broadcast, masked to the held-out rows
    @jax.jit
    def _val_mse(xs, A, b, val_mask):
        r = jnp.dot(xs, A.T, precision=jax.lax.Precision.HIGHEST) \
            - b[None, :]                       # (L, m)
        w = val_mask[None, :]
        return jnp.sum(w * r * r, axis=1) / jnp.sum(val_mask)

    val_rows = []
    for f in range(k):
        tm = jnp.asarray(masks[f])
        p_f = dataclasses.replace(problem, A=problem.A * tm[:, None],
                                  b=problem.b * tm)
        pr = lambda_path(p_f, cfg, lambdas=lambdas * scales[f],
                         method=method)
        val_rows.append(_val_mse(pr.xs, problem.A, problem.b, 1.0 - tm))
    return jnp.stack(val_rows)
