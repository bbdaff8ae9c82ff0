"""convex_optimization_tpu — a sparse-regression framework in JAX.

A brand-new JAX/XLA/Pallas/pjit framework with the capabilities of the
reference repo ``kingold5/convex_optimization`` (see /root/repo/SURVEY.md for
the capability contract; the reference mount was empty at survey time, so
evidence tags live in SURVEY.md rather than file:line citations).

Solves lasso-class composite problems

    min_x  P(x) = 0.5 * ||A x - b||_2^2 + (lam2 / 2) * ||x||_2^2 + g(x)

where ``g`` is a nonsmooth penalty: ``lam1*||x||_1`` (lasso / elastic net via
lam2), nonnegative lasso (``lam1*||x||_1 + i_{x>=0}``), or group lasso
(``lam1 * sum_g w_g ||x_g||_2``).

Layering (SURVEY.md section 1.2):

    bench/     benchmark harness, convergence & scaling reports
    api        solve() / Problem / Result, CLI
    solvers/   FISTA / ISTA / block-CD sweeps / lambda-path / screening
    parallel/  mesh, column-block sharding, residual-consensus collectives
    ops/       fused block-sweep (CUDA kernel / plain XLA), route choice,
               transposed-layout products, pure-jnp oracle
    core/      problems, data generation, duality-gap convergence monitor
    models/    penalty families (prox operators, dual norms, screening rules)
"""

from convex_optimization_tpu.core.problem import Problem
from convex_optimization_tpu.core import datagen
from convex_optimization_tpu.core.objective import (
    primal_value,
    dual_value,
    duality_gap,
    lambda_max,
)
from convex_optimization_tpu.models import (
    Penalty,
    l1,
    nonneg_l1,
    group_l2,
)
from convex_optimization_tpu.api import solve, Result
# light import (mesh helpers only; sharded solvers stay lazy inside solve):
# README's `co.parallel.mesh.make_mesh(...)` quickstart needs the subpackage
# reachable from the bare package import
from convex_optimization_tpu import parallel

__version__ = "0.1.0"

__all__ = [
    "Problem",
    "Penalty",
    "l1",
    "nonneg_l1",
    "group_l2",
    "datagen",
    "primal_value",
    "dual_value",
    "duality_gap",
    "lambda_max",
    "solve",
    "Result",
    "parallel",
]
