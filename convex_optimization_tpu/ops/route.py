"""The one place that decides which sweep implementation runs, and how much
device memory a solve may plan for.

Two sweep routes exist (ops/bcd_sweep.py dispatches on the name):

  * ``"cuda"``: the fused Hopper kernel (ops/cuda_sweep.py), on a GPU
    backend for float32 problems;
  * ``"xla"``: the plain ``lax.scan`` sweep over the same A_t layout
    (ops/bcd_sweep.batch_sweep_ref), everywhere else.  The CPU tests run
    this route, and it is the reference the kernel is checked against.

There is no interpret mode on any backend.  Whether a problem shape can use
the fused sweep at all is :func:`sweep_gate`'s answer, and it is the same
on every backend, so the CPU tests exercise the gate the card applies.
"""

from __future__ import annotations

import math
import os

import jax
import jax.numpy as jnp

from convex_optimization_tpu.ops import cuda_sweep

CUDA = "cuda"
XLA = "xla"
ROUTES = (CUDA, XLA)

#: Most lambdas one batched sweep carries (the kernel's limit).
MAX_BATCH = cuda_sweep.MAX_BATCH

#: Share of the device's memory limit left free for XLA's temporaries, the
#: polish gathers and the certificate's work arrays.
MEMORY_HEADROOM = 0.10


def sweep_route(dtype=jnp.float32, platform: str | None = None) -> str:
    """Which sweep implementation runs: ``"cuda"`` on a GPU backend for
    float32, ``"xla"`` otherwise."""
    platform = platform or jax.default_backend()
    if platform == "gpu" and jnp.dtype(dtype) == jnp.float32:
        return CUDA
    return XLA


def check_route(route: str | None, dtype=jnp.float32) -> str:
    """Resolve ``route=None`` through :func:`sweep_route`; reject unknown
    names and a CUDA route off the GPU."""
    if route is None:
        return sweep_route(dtype)
    if route not in ROUTES:
        raise ValueError(f"unknown sweep route {route!r}; one of {ROUTES}")
    if route == CUDA and jax.default_backend() != "gpu":
        raise ValueError("the cuda sweep route needs a GPU backend")
    return route


def sweep_gate(m: int, n: int, block: int, L: int = 1, dtype=jnp.float32,
               gsize: int = 1) -> str | None:
    """None when the fused sweep can serve an (m, n) float32 problem in
    column blocks of ``block`` for ``L`` lambdas at once; otherwise the
    reason it cannot.  ``gsize`` > 1 means group_l2 with groups of that
    size (a block must hold whole groups)."""
    if jnp.dtype(dtype) != jnp.float32:
        return f"dtype {jnp.dtype(dtype).name} (the fused sweep is float32)"
    if not 1 <= L <= MAX_BATCH:
        return f"L={L} outside [1, {MAX_BATCH}]"
    if block < 8 or block % 8 or n % block:
        return f"block {block} must be a multiple of 8 dividing n={n}"
    if block % gsize:
        return f"block {block} must hold whole groups of {gsize}"
    if m % 8:
        # rows of A_t then start on 32-byte sectors, so every CTA's row
        # segments of a tile are whole sectors
        return f"m={m} must be a multiple of 8"
    if cuda_sweep.plan(m, block, L, gsize, gsize > 1,
                       sms=_sms()) is None:
        return (f"a ({block}, m/SMs) tile of m={m} does not fit one CTA's "
                f"shared memory")
    return None


def _sms() -> int:
    if jax.default_backend() == "gpu":
        return cuda_sweep.device_sms()
    return cuda_sweep.H100_SMS


def pick_block_size(m: int, n: int, target: int = 128, multiple_of: int = 1,
                    L: int = 1, dtype=jnp.float32
                    ) -> tuple[int, int] | None:
    """(block, pad) for the fused sweep on n + pad columns (pad appended as
    zero columns by the caller), or None when no block fits.  Blocks are
    multiples of 8 (and of the group size) up to ``target``; a pad-free
    block is preferred, since padding costs another full copy of A."""
    step = 8 * multiple_of // math.gcd(8, multiple_of)
    best = best_nopad = None
    b = step
    while b <= max(target, step):
        n_pad = -(-n // b) * b
        if sweep_gate(m, n_pad, b, L, dtype, multiple_of) is None:
            best = (b, n_pad - n)
            if n_pad == n:
                best_nopad = (b, 0)
        b += step
    return best_nopad or best


def device_memory_budget(device=None) -> int:
    """Bytes a solve may plan to keep resident on ``device`` (default: the
    first device): the allocator's limit less :data:`MEMORY_HEADROOM`.  The
    CPU backend's device memory is the host's RAM.  An accelerator that
    reports no limit is an error."""
    dev = device if device is not None else jax.devices()[0]
    if dev.platform == "cpu":
        limit = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    else:
        limit = (dev.memory_stats() or {}).get("bytes_limit")
        if not limit:
            raise RuntimeError(
                f"device {dev.device_kind!r} reports no memory limit")
    return int(limit * (1.0 - MEMORY_HEADROOM))


def fits_device_memory(m: int, n: int, dtype=jnp.float32,
                       copies: float = 2.0) -> bool:
    """True when ``copies`` full-size (m, n) buffers fit the device budget.
    ``copies`` counts persistent full-size buffers: A, the transposed A_t,
    a zero-padded duplicate, or a fraction for working-set slabs."""
    need = copies * m * n * jnp.dtype(dtype).itemsize
    return need <= device_memory_budget()
