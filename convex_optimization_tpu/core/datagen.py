"""Synthetic problem generation (SURVEY.md C6) and the benchmark config grid.

The reference synthesizes dense Gaussian design matrices with a planted
sparse support and runs its solvers on them (SURVEY.md section 3.1); the
benchmark grid below mirrors BASELINE.json's five configs, each with a
CI-sized twin so the bench harness doubles as an integration test
(SURVEY.md section 4.2).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from convex_optimization_tpu.core.problem import Problem
from convex_optimization_tpu.core.objective import lambda_max
from convex_optimization_tpu.models.penalties import Penalty, l1, nonneg_l1, group_l2


class Instance(NamedTuple):
    problem: Problem
    x_true: jax.Array       # planted coefficients
    support: jax.Array      # boolean planted support mask


def make_lasso_instance(
    key: jax.Array,
    m: int,
    n: int,
    *,
    support_frac: float = 0.05,
    noise_std: float = 0.01,
    lam1_frac: float = 0.1,
    lam2: float = 0.0,
    penalty_kind: str = "l1",
    ngroups: int = 0,
    dtype=jnp.float32,
    normalize_columns: bool = True,
) -> Instance:
    """Dense Gaussian A (m x n), planted sparse x*, b = A x* + noise.

    lam1 is set to lam1_frac * lambda_max so every config lands in the
    interesting sparse regime (config 1: lam = 0.1 * lam_max).
    """
    k_a, k_s, k_v, k_e = jax.random.split(key, 4)
    A = jax.random.normal(k_a, (m, n), dtype=dtype)
    if normalize_columns:
        # unit-norm columns make per-coordinate Lipschitz constants uniform
        A = A / jnp.linalg.norm(A, axis=0, keepdims=True)

    if penalty_kind == "group_l2" and ngroups > 0:
        # GROUP-sparse planted signal: support_frac of whole groups.  A
        # scattered per-column support puts planted coordinates in nearly
        # every group (5% of 131k columns over 1k groups -> ~6 per group),
        # which makes the group-lasso instance effectively dense in groups
        # and meaningless as a structured-sparsity benchmark (measured:
        # 830/1024 active groups at the config-4 twin).
        gsize = n // ngroups
        ng_nz = max(1, int(round(support_frac * ngroups)))
        gidx = jax.random.choice(k_s, ngroups, shape=(ng_nz,), replace=False)
        idx = (gidx[:, None] * gsize
               + jnp.arange(gsize)[None, :]).reshape(-1)
        nnz = idx.shape[0]
    else:
        nnz = max(1, int(round(support_frac * n)))
        idx = jax.random.choice(k_s, n, shape=(nnz,), replace=False)
    support = jnp.zeros((n,), bool).at[idx].set(True)
    # v + sign(v): planted coefficients are well separated from zero
    # (|x*| >= 1), so support recovery at moderate lam is well defined;
    # the host twin (below) uses the same scheme
    vals = jax.random.normal(k_v, (nnz,), dtype=dtype) + jnp.sign(
        jax.random.normal(k_v, (nnz,), dtype=dtype)
    )
    x_true = jnp.zeros((n,), dtype=dtype).at[idx].set(vals)
    if penalty_kind == "nonneg_l1":
        x_true = jnp.abs(x_true)

    b = A @ x_true
    if noise_std > 0:
        b = b + noise_std * jax.random.normal(k_e, (m,), dtype=dtype)

    if penalty_kind == "l1":
        pen: Penalty = l1(1.0)
    elif penalty_kind == "nonneg_l1":
        pen = nonneg_l1(1.0)
    elif penalty_kind == "group_l2":
        if ngroups <= 0 or n % ngroups != 0:
            raise ValueError("group_l2 requires ngroups dividing n")
        pen = group_l2(1.0, ngroups=ngroups)
    else:
        raise ValueError(f"unknown penalty kind {penalty_kind!r}")

    lam_max = lambda_max(A, b, pen)
    pen = pen.with_lam1(lam1_frac * lam_max)
    return Instance(
        problem=Problem(A=A, b=b, penalty=pen, lam2=lam2),
        x_true=x_true,
        support=support,
    )


def make_lasso_instance_host(
    seed: int,
    m: int,
    n: int,
    *,
    support_frac: float = 0.05,
    noise_std: float = 0.01,
    lam1_frac: float = 0.1,
    lam2: float = 0.0,
    penalty_kind: str = "l1",
    ngroups: int = 0,
    normalize_columns: bool = True,
):
    """Host-side twin of make_lasso_instance using the native runtime
    (utils/native.py threaded Gaussian fill).  Returns
    ``(Instance, A_np, b_np)`` — the numpy copies let post-solve host phases
    (solvers/polish.py) and CPU baselines avoid a device->host fetch of a
    multi-GB design matrix.
    """
    import numpy as np

    from convex_optimization_tpu.utils import native

    # generate transposed and view: A is COLUMN-MAJOR on the host, so the
    # column gathers done by the polish phase (A[:, idx]) are contiguous
    # copies instead of strided reads (measured 6.7s -> contiguous at the
    # 10k x 100k size)
    A = native.gaussian((n, m), seed=seed).T
    if normalize_columns:
        A /= np.linalg.norm(A, axis=0, keepdims=True)

    rng = np.random.default_rng(seed + 1)
    if penalty_kind == "group_l2" and ngroups > 0:
        # group-sparse planted signal (see make_lasso_instance)
        gsize = n // ngroups
        ng_nz = max(1, int(round(support_frac * ngroups)))
        gidx = rng.choice(ngroups, size=ng_nz, replace=False)
        idx = (gidx[:, None] * gsize
               + np.arange(gsize)[None, :]).reshape(-1)
        nnz = idx.shape[0]
    else:
        nnz = max(1, int(round(support_frac * n)))
        idx = rng.choice(n, size=nnz, replace=False)
    support = np.zeros(n, bool)
    support[idx] = True
    vals = rng.standard_normal(nnz).astype(np.float32)
    vals += np.sign(vals)      # |x*| >= 1, matching make_lasso_instance
    x_true = np.zeros(n, np.float32)
    x_true[idx] = vals
    if penalty_kind == "nonneg_l1":
        x_true = np.abs(x_true)

    b = A @ x_true
    if noise_std > 0:
        b = b + noise_std * rng.standard_normal(m).astype(np.float32)

    if penalty_kind == "l1":
        pen: Penalty = l1(1.0)
        raw = float(np.max(np.abs(A.T @ b)))
    elif penalty_kind == "nonneg_l1":
        pen = nonneg_l1(1.0)
        raw = float(max(np.max(A.T @ b), 0.0))
    elif penalty_kind == "group_l2":
        if ngroups <= 0 or n % ngroups != 0:
            raise ValueError("group_l2 requires ngroups dividing n")
        pen = group_l2(1.0, ngroups=ngroups)
        gn = np.linalg.norm((A.T @ b).reshape(ngroups, -1), axis=1)
        raw = float(np.max(gn))
    else:
        raise ValueError(f"unknown penalty kind {penalty_kind!r}")
    pen = pen.with_lam1(lam1_frac * raw)

    inst = Instance(
        problem=Problem(A=jnp.asarray(A), b=jnp.asarray(b), penalty=pen,
                        lam2=lam2),
        x_true=jnp.asarray(x_true),
        support=jnp.asarray(support),
    )
    # the host->device upload of A completes here, in set-up
    jax.block_until_ready(inst.problem)
    return inst, A, b


@dataclasses.dataclass(frozen=True)
class BenchConfig:
    """One row of the BASELINE.md benchmark grid (+ a CI-sized twin)."""

    name: str
    m: int
    n: int
    penalty_kind: str = "l1"
    lam2: float = 0.0
    ngroups: int = 0
    lam1_frac: float = 0.1
    support_frac: float = 0.05
    lambda_path: int = 0        # >0: warm-started geometric path of this length
    screening: bool = False
    sharded: bool = False       # column-shard A over the mesh
    ci_m: int = 128             # CI twin sizes
    ci_n: int = 512

    def instance(self, key, *, ci: bool = False, dtype=jnp.float32) -> Instance:
        m, n = (self.ci_m, self.ci_n) if ci else (self.m, self.n)
        ngroups = self.ngroups
        if ci and ngroups:
            ngroups = min(ngroups, n // 4)
        return make_lasso_instance(
            key, m, n,
            support_frac=self.support_frac,
            lam1_frac=self.lam1_frac,
            lam2=self.lam2,
            penalty_kind=self.penalty_kind,
            ngroups=ngroups,
            dtype=dtype,
        )


# The five contract configs (BASELINE.json lines 7-11; see BASELINE.md).
BENCH_CONFIGS = {
    # Config 1: dense lasso 500x2000, 5% support, lam = 0.1 lam_max (CPU-runnable)
    "config1": BenchConfig(name="config1", m=500, n=2000),
    # Config 2: dense lasso 5k x 50k, FISTA + warm-started 10-value lambda path
    "config2": BenchConfig(name="config2", m=5_000, n=50_000, lambda_path=10),
    # Config 3: elastic-net + nonnegative lasso, 10k x 100k, screening on
    "config3": BenchConfig(
        name="config3", m=10_000, n=100_000, penalty_kind="nonneg_l1",
        lam2=1e-3, screening=True,
    ),
    # Config 4: group lasso, 1k blocks, 20k x 200k, blockwise prox / sharded cols
    "config4": BenchConfig(
        name="config4", m=20_000, n=200_000, penalty_kind="group_l2",
        ngroups=1000, sharded=True,
    ),
    # Config 5: 50k x 1M column-sharded, psum residual consensus per sweep
    "config5": BenchConfig(
        name="config5", m=50_000, n=1_000_000, sharded=True,
    ),
}


def save_instance(path: str, inst: Instance) -> None:
    """Persist a problem instance through the native binary store
    (utils/native.py — atomic writes, zero-copy reads).  Layout:
    <path>.A / <path>.b / <path>.meta.npz.
    """
    import numpy as np

    from convex_optimization_tpu.utils import native

    import jax

    A = np.asarray(jax.device_get(inst.problem.A), np.float32)
    native.write_matrix(path + ".A", A)
    native.write_matrix(path + ".b",
                        np.asarray(jax.device_get(inst.problem.b),
                                   np.float32))
    pen = inst.problem.penalty
    np.savez(
        path + ".meta.npz",
        lam1=np.float64(jax.device_get(jnp.asarray(pen.lam1))),
        lam2=np.float64(inst.problem.lam2),
        kind=np.frombuffer(pen.kind.encode(), dtype=np.uint8),
        ngroups=np.int64(pen.ngroups),
        weights=(np.zeros(0) if pen.weights is None
                 else np.asarray(jax.device_get(pen.weights))),
        x_true=np.asarray(jax.device_get(inst.x_true)),
        support=np.asarray(jax.device_get(inst.support)),
    )


def load_instance(path: str) -> Instance:
    """Load an instance written by save_instance (native store reads)."""
    import numpy as np

    from convex_optimization_tpu.utils import native

    A = native.read_matrix(path + ".A")
    b = native.read_matrix(path + ".b").reshape(-1)
    with np.load(path + ".meta.npz") as z:
        kind = bytes(z["kind"].tobytes()).decode()
        weights = z["weights"]
        pen = Penalty(
            lam1=float(z["lam1"]), kind=kind, ngroups=int(z["ngroups"]),
            weights=None if weights.size == 0 else jnp.asarray(weights),
        )
        prob = Problem(A=jnp.asarray(A), b=jnp.asarray(b), penalty=pen,
                       lam2=float(z["lam2"]))
        return Instance(problem=prob, x_true=jnp.asarray(z["x_true"]),
                        support=jnp.asarray(z["support"]))
