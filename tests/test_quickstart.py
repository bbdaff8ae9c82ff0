"""CI smoke for the advertised front door (VERDICT r4 Weak #5):
examples/quickstart.py --small must run end-to-end and certify."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_quickstart_small_runs_and_certifies():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "quickstart.py"),
         "--small"],
        capture_output=True, text=True, timeout=420, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = proc.stdout
    assert "converged=True" in out, out
    assert "cv:" in out and "best_lambda=" in out, out
