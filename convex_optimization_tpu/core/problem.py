"""Problem container for composite sparse-regression instances.

    min_x  P(x) = 0.5 * ||A x - b||^2 + (lam2/2) * ||x||^2 + penalty(x)

Capability contract: SURVEY.md C1 (objective & prox core) and C8 (problem
config).  The reference keeps problem constants in a settings module; here a
``Problem`` is an immutable pytree so it can flow straight through jit/pjit.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from convex_optimization_tpu.models.penalties import Penalty, l1


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["A", "b", "penalty", "lam2"],
    meta_fields=["shape_override"],
)
@dataclasses.dataclass(frozen=True)
class Problem:
    """A dense composite problem instance.

    A: (m, n) design matrix (float32 on the device; float64 for oracles)
    b: (m,) observations
    penalty: nonsmooth part g (lasso / nonneg / group)
    lam2: ridge coefficient of the smooth part (elastic net when > 0)
    shape_override: static (m, n) override for AUDIT-PLACEHOLDER problems —
        compact solves on the transposed layout (solvers/working_set.py)
        must never trace ``A``, so they carry a tiny NaN stand-in for it;
        the override keeps ``.m``/``.n`` correct without the placeholder
        costing a full-size (m, k) device buffer.  A program that does trace the
        stand-in fails loudly: shape mismatch at trace time, NaN results
        if shapes happen to broadcast.
    """

    A: jax.Array
    b: jax.Array
    penalty: Penalty
    lam2: jax.typing.ArrayLike = 0.0
    shape_override: tuple | None = None

    @property
    def m(self) -> int:
        return (self.shape_override or self.A.shape)[0]

    @property
    def n(self) -> int:
        return (self.shape_override or self.A.shape)[1]

    @property
    def dtype(self):
        return self.A.dtype

    def residual(self, x: jax.Array) -> jax.Array:
        """r = A x - b (note: the dual machinery uses rho = -r)."""
        return jnp.dot(self.A, x, precision=lax.Precision.HIGHEST) - self.b

    def grad_smooth(self, x: jax.Array, r: jax.Array) -> jax.Array:
        """Gradient of the smooth part at x given r = Ax - b."""
        g = jnp.dot(self.A.T, r, precision=lax.Precision.HIGHEST)
        if not _is_zero(self.lam2):
            g = g + self.lam2 * x
        return g

    def col_norms(self) -> jax.Array:
        """Augmented per-column norms sqrt(||A_j||^2 + lam2), used by screening."""
        return jnp.sqrt(jnp.sum(self.A * self.A, axis=0) + self.lam2)

    def with_penalty(self, penalty: Penalty) -> "Problem":
        return dataclasses.replace(self, penalty=penalty)

    def with_lam1(self, lam1) -> "Problem":
        return dataclasses.replace(self, penalty=self.penalty.with_lam1(lam1))


def _is_zero(v) -> bool:
    """True only for a static zero (safe to use for trace-time branching)."""
    return isinstance(v, (int, float)) and v == 0.0


def make_problem(A, b, lam1, *, lam2=0.0, penalty: Penalty | None = None) -> Problem:
    """Convenience constructor; defaults to the lasso penalty."""
    A = jnp.asarray(A)
    b = jnp.asarray(b)
    if penalty is None:
        penalty = l1(lam1)
    else:
        penalty = penalty.with_lam1(lam1)
    return Problem(A=A, b=b, penalty=penalty, lam2=lam2)
