"""Structured metrics / observability (SURVEY.md section 5).

The reference logs with prints and matplotlib; here every solve emits a
structured per-check record stream that can be written as JSONL and
summarized, and the bandwidth meter scores the hot loop against the card's
published memory bandwidth.
"""

from __future__ import annotations

import json
import sys
import time
from dataclasses import asdict, dataclass
from typing import IO, Iterable, Optional

#: Published peak device-memory bandwidth, bytes/s, keyed by JAX's
#: ``device_kind``.  Source: NVIDIA H100 Tensor Core GPU data sheet (H100
#: SXM: 3.35 TB/s).  A device not in the table is an error, not a default.
HBM_PEAK_BYTES_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def hbm_peak_bytes_s(device_kind: str | None = None) -> float:
    """Peak memory bandwidth of ``device_kind`` (default: the first
    device's); raises KeyError for a device the table does not list."""
    if device_kind is None:
        import jax

        device_kind = jax.devices()[0].device_kind
    try:
        return HBM_PEAK_BYTES_S[device_kind]
    except KeyError:
        raise KeyError(f"no published memory bandwidth for device "
                       f"{device_kind!r} (utils/metrics.HBM_PEAK_BYTES_S)"
                       ) from None


@dataclass
class SweepRecord:
    """One convergence-check record (the JSONL row schema)."""

    iteration: int
    primal: float
    dual: float
    gap: float
    rel_gap: float
    nnz: int
    t_wall_s: float = 0.0


def records_from_history(history: dict, wall_time_s: float = 0.0
                         ) -> list[SweepRecord]:
    """Expand a Result.history dict into per-check records.  Wall time is
    apportioned linearly by iteration (the loop runs on-device; per-check
    host timestamps do not exist by design — zero host sync)."""
    n = len(history["iteration"])
    total_iters = int(history["iteration"][-1]) if n else 0
    out = []
    for i in range(n):
        it = int(history["iteration"][i])
        out.append(SweepRecord(
            iteration=it,
            primal=float(history["primal"][i]),
            dual=float(history["dual"][i]),
            gap=float(history["gap"][i]),
            rel_gap=float(history["rel_gap"][i]),
            nnz=int(history["nnz"][i]),
            t_wall_s=(wall_time_s * it / total_iters) if total_iters else 0.0,
        ))
    return out


def write_jsonl(records: Iterable[SweepRecord], fp: IO[str],
                meta: Optional[dict] = None) -> None:
    if meta:
        fp.write(json.dumps({"record": "meta", **meta}) + "\n")
    for r in records:
        fp.write(json.dumps({"record": "check", **asdict(r)}) + "\n")
    fp.flush()


def effective_bandwidth(m: int, n: int, iterations: int, wall_time_s: float,
                        *, passes_per_iter: float = 2.0,
                        itemsize: int = 4,
                        device_kind: str | None = None) -> dict:
    """Achieved bytes/s streaming A, and its fraction of the device's
    published peak (:func:`hbm_peak_bytes_s`).

    FISTA does 2 full passes over A per iteration (solvers/fista.py); the
    fused BCD sweep does 1 (ops/bcd_sweep.py).
    """
    bytes_moved = passes_per_iter * m * n * itemsize * iterations
    bps = bytes_moved / wall_time_s if wall_time_s > 0 else float("inf")
    peak = hbm_peak_bytes_s(device_kind)
    return {
        "achieved_gb_s": bps / 1e9,
        "hbm_peak_gb_s": peak / 1e9,
        "fraction_of_peak": bps / peak,
    }


class WallTimer:
    """Context-manager wall timer (host side, outside jit)."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0

    def __float__(self):
        return self.elapsed


def summary_line(name: str, res, extra: Optional[dict] = None,
                 file: IO[str] = sys.stderr) -> None:
    """One human-readable summary row per solve (reference: print+plot)."""
    msg = (f"[{name}] method={res.method} iters={res.iterations} "
           f"rel_gap={res.rel_gap:.2e} nnz={res.nnz} "
           f"wall={res.wall_time_s:.3f}s iters/s={res.iters_per_sec:.1f} "
           f"converged={res.converged}")
    if extra:
        msg += " " + " ".join(f"{k}={v}" for k, v in extra.items())
    print(msg, file=file)
