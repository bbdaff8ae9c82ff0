"""Quickstart: generate a lasso instance, solve it three ways, certify,
and run model selection.  Runs anywhere (CPU included):

    JAX_PLATFORMS=cpu python examples/quickstart.py

On a GPU host drop the env var.  See README.md for the full API and
docs/DESIGN.md for why the solvers look the way they do.
"""

import os
import sys

# run from a checkout without installing the package: the script's own
# directory is sys.path[0], so put the repository root beside it
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

import convex_optimization_tpu as co
from convex_optimization_tpu.solvers import SolverConfig, cv_lambda_path
from convex_optimization_tpu.solvers.lambda_path import lambda_path


def main(small: bool = False):
    # synthetic problem: dense Gaussian A, planted 5% support, small noise
    # (--small: CI-twin sizes so the smoke test stays cheap)
    m, n, path_len, k = (96, 384, 4, 3) if small else (400, 1600, 8, 5)
    inst = co.datagen.make_lasso_instance(jax.random.PRNGKey(0),
                                          m=m, n=n, noise_std=0.02)
    problem = inst.problem

    # 1. one solve; certify=True finishes with the f64 polish phase when
    #    the f32 monitor floors above tol (the 1e-6 grade is an f64-
    #    certified duality gap, see docs/DESIGN.md section 4)
    res = co.solve(problem, method="fista", tol=1e-6, max_iters=5000,
                   stall_checks=15, certify=True)
    rec = (np.asarray(res.x != 0) & np.asarray(inst.support)).sum()
    print(f"fista: rel_gap={res.rel_gap:.2e} converged={res.converged} "
          f"nnz={res.nnz} support-recall={rec / inst.support.sum():.2f} "
          f"({res.iters_per_sec:.0f} it/s)")

    # 2. a warm-started lambda path (one compiled program, lambda is data);
    #    method='bcd_batch' solves every point against one shared A stream
    cfg = SolverConfig(tol=1e-6, max_iters=5000, stall_checks=15)
    path = lambda_path(problem, cfg, path_len=path_len,
                       method="bcd_batch")
    print("path:  " + "  ".join(
        f"lam={float(l):.3g}:nnz={int((x != 0).sum())}"
        for l, x in zip(path.lambdas, path.xs)))

    # 3. pick lambda by 5-fold cross-validation (min-MSE and 1-SE rule)
    cv = cv_lambda_path(problem, cfg, k=k, path_len=path_len)
    print(f"cv:    best_lambda={cv.best_lambda:.4g} "
          f"(mse={float(cv.mean_mse[cv.best_index]):.4g}), "
          f"1-SE lambda={cv.one_se_lambda:.4g}, "
          f"nnz@best={int((cv.x != 0).sum())}")


if __name__ == "__main__":
    import sys

    main(small="--small" in sys.argv)
