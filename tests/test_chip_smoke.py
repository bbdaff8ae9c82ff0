"""chip_smoke.py's CPU-side contract: the last line it prints, which phases
each invocation runs, and that it refuses to run without a GPU."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def test_result_line_is_the_contract_json():
    line = chip_smoke.result_line("NVIDIA H100 80GB HBM3", 1)
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": 1}}
    assert "\n" not in line


def test_four_cards_runs_only_its_phase():
    assert chip_smoke.phases_for(True) == (chip_smoke.FOUR_CARDS,)
    assert chip_smoke.FOUR_CARDS not in chip_smoke.phases_for(False)


def test_default_runs_every_one_card_phase_in_order():
    assert chip_smoke.phases_for(False) == (
        "parity", "timing", "headline", "path_cv")
    assert set(chip_smoke.PHASES) == set(chip_smoke.ONE_CARD_PHASES) | {
        chip_smoke.FOUR_CARDS}


def test_check_prints_value_beside_limit(capsys):
    chip_smoke.check("gap", 5e-7, 1e-6)
    assert "5.000e-07" in capsys.readouterr().out
    with pytest.raises(chip_smoke.CheckFailed):
        chip_smoke.check("gap", 2e-6, 1e-6)


def test_fails_without_gpu_and_prints_no_result():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
