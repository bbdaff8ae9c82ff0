"""Mesh construction and multi-host initialization (SURVEY.md section 2.3).

Axis convention: a 1-D mesh over axis ``"blocks"`` — feature blocks (columns
of A) are the primary parallel axis (the TP analog, SURVEY.md section 2.2).
Across hosts the same flat axis spans NVLink inside a host and the network
between hosts; residual consensus is one m-vector psum per iteration, cheap
on either fabric (SURVEY.md section 7.4).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

BLOCKS = "blocks"   # feature/column axis (TP analog — the primary strategy)
ROWS = "rows"       # sample/row axis (DP analog — best when m >> n)


def make_mesh(n_devices: int | None = None, devices=None,
              axis: str = BLOCKS) -> Mesh:
    """1-D mesh over the given axis using the first n_devices devices.

    axis='blocks' column-shards A (residual consensus = m-vector psum per
    iteration); axis='rows' row-shards A and b (gradient consensus =
    n-vector psum per iteration) — pick by the cheaper collective.
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis,))


def init_multihost(coordinator_address: str | None = None, **kw) -> None:
    """Initialize multi-host JAX. No-op without an address.

    NOTE: must run before ANY device query — even jax.process_count()
    initializes the local backend, after which distributed init raises.
    A repeat call (already-initialized runtime) is swallowed."""
    if coordinator_address is None:
        return
    try:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   **kw)
    except RuntimeError as e:
        if "already" not in str(e).lower():
            raise


def col_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for A: columns over 'blocks' (each chip owns a column slab)."""
    return NamedSharding(mesh, P(None, BLOCKS))


def vec_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for x-like vectors: features over 'blocks'."""
    return NamedSharding(mesh, P(BLOCKS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


# The sharded λ-path re-dispatches every builder's compiled program with a
# new lam1 swapped into the args tuple (solvers/lambda_path.py).  Every
# builder (sharded/row_sharded/grid_sharded, fista and bcd) therefore MUST
# keep lam1 at this positional index; check_lam1_slot makes a reordered
# builder fail loudly at build time instead of silently solving every path
# point at the wrong lambda (VERDICT r3 task 8).
LAM1_ARG_INDEX = 2


def check_lam1_slot(args: tuple, penalty) -> tuple:
    """Assert args[LAM1_ARG_INDEX] IS the penalty's lam1 leaf (object
    identity — two equal floats from different attributes would not pass),
    then return args unchanged so builders can wrap their return."""
    assert args[LAM1_ARG_INDEX] is penalty.lam1, (
        "builder args reordered: lam1 must stay at "
        f"args[{LAM1_ARG_INDEX}] (solvers/lambda_path.py swaps it per "
        "path point)")
    return args
