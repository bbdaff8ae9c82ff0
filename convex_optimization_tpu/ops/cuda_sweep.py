"""The Hopper sweep kernel (ops/cuda/bcd_sweep.cu): build, register, call.

The kernel is compiled with ``nvcc`` for ``sm_90a`` into ``<repo>/build/``
the first time a GPU program uses it (a few seconds, counted as set-up) and
registered as the XLA foreign-function target ``co_bcd_sweep``.  It has no
interpret mode: the CPU tests cover ``plan`` (the shared-memory model that
decides eligibility), ``operands`` (shapes, padding, dummies, attributes)
and the plain reference it is checked against on the card
(ops/bcd_sweep.batch_sweep_ref).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

import jax
import jax.numpy as jnp

SOURCE = Path(__file__).with_name("cuda") / "bcd_sweep.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
TARGET = "co_bcd_sweep"

# launch constants mirrored from the .cu file
THREADS = 512
MAX_STAGES = 8
MAX_BATCH = 16
COUNTER_WORDS = 64
# opt-in shared memory of one block and SM count of an H100 SXM (NVIDIA's
# Hopper tuning guide); the handler reads both from the device at launch
SMEM_LIMIT = 232_448
H100_SMS = 132
KINDS = {"l1": 0, "nonneg_l1": 1, "group_l2": 2}

_lock = threading.Lock()
_registered = False


def plan(m: int, B: int, L: int = 1, gsize: int = 1, group: bool = False,
         sms: int = H100_SMS) -> dict | None:
    """Launch plan of one sweep (mirror of ``MakePlan`` in the .cu file):
    grid size, rows per CTA, shared-memory stages and bytes.  None when a
    single (B, rows-per-CTA) tile does not fit shared memory."""
    ms = -(-m // sms)
    ms = -(-ms // 8) * 8
    LB = L * B
    gpb = B // gsize if group else 0
    rs = ms + 1
    red_n = max(THREADS, LB, L * ms)
    fixed = L * ms + ms + red_n + 2 * LB + L + L * gpb
    tile = B * rs + LB + B + gpb + 4       # one stage: tile + x, mask, w, step
    avail = SMEM_LIMIT // 4
    if avail < fixed + tile:
        return None
    stages = min(MAX_STAGES, (avail - fixed) // tile)
    return {"grid": -(-m // ms), "ms": ms, "stages": stages,
            "smem_bytes": (fixed + stages * tile) * 4}


def device_sms() -> int:
    """SM count of the default device (the H100's where JAX reports none)."""
    return getattr(jax.devices()[0], "core_count", None) or H100_SMS


def _build() -> Path:
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src).hexdigest()[:16]
    out = BUILD_DIR / f"libco_bcd_sweep_{tag}.so"
    if out.exists():
        return out
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA sweep kernel is built "
                           "with the CUDA toolkit on the GPU host")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-I", jax.ffi.include_dir(), "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def register() -> None:
    """Build (once per source version) and register the FFI target."""
    global _registered
    with _lock:
        if _registered:
            return
        lib = ctypes.cdll.LoadLibrary(str(_build()))
        jax.ffi.register_ffi_target(TARGET, jax.ffi.pycapsule(lib.CoBcdSweep),
                                    platform="CUDA")
        _registered = True


def operands(A_t, X, R, steps, lam1s, lam2, *, kind: str, gsize: int = 1,
             weights=None, mask=None, row_mask=None):
    """(operands, attributes, result shapes) of one kernel call.

    A_t (nb, B, m), X (nb, L, B), R (L, m), steps (nb,), lam1s (L,).
    ``weights`` ((nb, ..., B // gsize), group_l2 only), ``mask`` (keep mask,
    any shape of nb * B elements) and ``row_mask`` ((m,)) are optional; the
    kernel takes a one-element dummy for an absent weight or row mask and an
    all-ones keep mask."""
    nb, B, m = A_t.shape
    L = X.shape[1]
    f32 = jnp.float32
    if kind == "group_l2":
        w = jnp.asarray(weights, f32).reshape(nb, B // gsize)
    else:
        w = jnp.zeros((1,), f32)
        gsize = 1
    keep = (jnp.ones((nb, B), f32) if mask is None
            else jnp.asarray(mask, f32).reshape(nb, B))
    rm = (jnp.zeros((1,), f32) if row_mask is None
          else jnp.asarray(row_mask, f32).reshape(m))
    ops = (A_t, X, R, jnp.asarray(steps, f32).reshape(nb),
           jnp.asarray(lam1s, f32).reshape(L),
           jnp.asarray(lam2, f32).reshape(1), w, keep, rm)
    attrs = {"kind": np.int32(KINDS[kind]), "gsize": np.int32(gsize),
             "masked": np.int32(row_mask is not None)}
    results = (jax.ShapeDtypeStruct((nb, L, B), f32),
               jax.ShapeDtypeStruct((L, m), f32),
               jax.ShapeDtypeStruct((COUNTER_WORDS + 3 * L * B,), jnp.uint32))
    return ops, attrs, results


def batch_sweep_cuda(A_t, X, R, steps, lam1s, lam2, *, kind: str,
                     gsize: int = 1, weights=None, mask=None, row_mask=None):
    """One sweep on the card; same contract as
    ops/bcd_sweep.batch_sweep_ref.  Returns (X, R)."""
    register()
    ops, attrs, results = operands(A_t, X, R, steps, lam1s, lam2, kind=kind,
                                   gsize=gsize, weights=weights, mask=mask,
                                   row_mask=row_mask)
    X_out, R_out, _ = jax.ffi.ffi_call(TARGET, results)(*ops, **attrs)
    return X_out, R_out
