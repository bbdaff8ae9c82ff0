"""Checkpoint/resume, metrics JSONL, and CLI integration (SURVEY.md section 5)."""

import json

import jax
import numpy as np

from convex_optimization_tpu.api import solve
from convex_optimization_tpu.core.datagen import make_lasso_instance
from convex_optimization_tpu.utils import checkpoint as ckpt
from convex_optimization_tpu.utils import metrics as M


def _inst(m=64, n=256, seed=0, **kw):
    return make_lasso_instance(jax.random.PRNGKey(seed), m, n, **kw)


def test_snapshot_roundtrip(tmp_path):
    p = str(tmp_path / "snap.npz")
    x = np.arange(8.0, dtype=np.float32)
    ckpt.save_snapshot(p, x, 0.25, lam_index=3, iteration=42,
                       meta={"name": "t"})
    s = ckpt.load_snapshot(p)
    np.testing.assert_array_equal(s.x, x)
    assert s.lam1 == 0.25 and s.lam_index == 3 and s.iteration == 42
    assert s.meta == {"name": "t"}


def test_resume_is_warm_start(tmp_path):
    """Kill-and-resume: a solve interrupted at iteration K, snapshotted, and
    resumed must land at the same solution as the uninterrupted solve —
    faster than solving cold (SURVEY.md section 5 fault-injection analog)."""
    inst = _inst(m=96, n=384, lam1_frac=0.05)  # smallish lam1: slower solve
    full = solve(inst.problem, tol=1e-5, max_iters=4000)
    assert full.converged and full.iterations > 20

    part = solve(inst.problem, tol=1e-5, max_iters=10, gap_every=10)
    assert not part.converged
    p = str(tmp_path / "mid.npz")
    ckpt.save_snapshot(p, np.asarray(part.x),
                       float(np.asarray(inst.problem.penalty.lam1)))

    resumed = ckpt.resume_solve(inst.problem, p, tol=1e-5, max_iters=4000)
    assert resumed.converged
    np.testing.assert_allclose(np.asarray(resumed.x), np.asarray(full.x),
                               atol=2e-4)
    assert resumed.iterations < full.iterations


def test_records_and_jsonl(tmp_path):
    inst = _inst()
    res = solve(inst.problem, tol=1e-5, max_iters=2000)
    recs = M.records_from_history(res.history, res.wall_time_s)
    assert len(recs) == len(res.history["iteration"])
    assert recs[-1].rel_gap <= 1e-5
    # gap never negative up to the f32 certificate floor
    assert all(r.gap >= -1e-6 for r in recs)
    out = tmp_path / "m.jsonl"
    with open(out, "w") as f:
        M.write_jsonl(recs, f, meta={"name": "t"})
    lines = [json.loads(l) for l in out.read_text().splitlines()]
    assert lines[0]["record"] == "meta"
    assert len(lines) == len(recs) + 1


def test_effective_bandwidth_math():
    bw = M.effective_bandwidth(1000, 1000, iterations=100, wall_time_s=1.0,
                               device_kind="NVIDIA H100 80GB HBM3")
    assert np.isclose(bw["achieved_gb_s"], 2 * 4 * 1e6 * 100 / 1e9)
    assert np.isclose(bw["hbm_peak_gb_s"], 3350.0)
    assert 0 < bw["fraction_of_peak"] < 1


def test_cli_custom_and_config(tmp_path, capsys):
    from convex_optimization_tpu.cli import main

    snap = str(tmp_path / "c.npz")
    jl = str(tmp_path / "c.jsonl")
    rc = main(["--m", "64", "--n", "256", "--tol", "1e-4",
               "--jsonl", jl, "--checkpoint", snap])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["converged"] and out["rel_gap"] <= 1e-4
    assert json.loads(open(jl).read().splitlines()[0])["record"] == "meta"
    assert ckpt.load_snapshot(snap).x.shape == (256,)

    rc = main(["--config", "config1", "--ci", "--tol", "1e-4",
               "--method", "bcd"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["converged"]


def test_cli_lambda_path(capsys):
    from convex_optimization_tpu.cli import main

    rc = main(["--config", "config2", "--ci", "--lambda-path", "4",
               "--tol", "1e-4"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["mode"] == "lambda_path" and len(out["path"]) == 4
    assert all(row["rel_gap"] <= 1e-4 for row in out["path"])
    # sparsity decreases along a descending path
    assert out["path"][0]["nnz"] <= out["path"][-1]["nnz"]


def test_cli_polish_flag(capsys):
    from convex_optimization_tpu.cli import main

    rc = main(["--m", "96", "--n", "384", "--tol", "1e-7",
               "--max-iters", "200", "--polish"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["certified"] and out["certified_rel_gap"] <= 1e-7


def test_plot_history_and_path(tmp_path):
    """--plot output (SURVEY.md C7: the reference driver's error-vs-
    iteration matplotlib curves); skips cleanly without matplotlib."""
    import numpy as np
    import pytest as _pytest

    from convex_optimization_tpu.utils.plotting import plot_history, plot_path

    hist = {"iteration": np.arange(0, 50, 10),
            "rel_gap": np.geomspace(1e-1, 1e-6, 5),
            "primal": np.linspace(3.0, 1.0, 5)}
    p1 = str(tmp_path / "h.png")
    ok = plot_history(hist, p1, title="t")
    if not ok:
        _pytest.skip("matplotlib unavailable")
    import os
    assert os.path.getsize(p1) > 0
    p2 = str(tmp_path / "p.png")
    assert plot_path([1.0, 0.1, 0.01], [1e-6, 1e-5, 1e-4],
                     [10, 100, 1000], [1, 5, 9], p2)
    assert os.path.getsize(p2) > 0
