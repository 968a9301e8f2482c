"""The tutorial is executable documentation (reference notebooks/
tutorial.ipynb role): it must run end-to-end, including evolution,
champion re-evaluation, and gradient tuning."""

import os
import subprocess
import sys


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_tutorial_runs_end_to_end():
    env = dict(os.environ)
    env["TUTORIAL_GENERATIONS"] = "2"
    env["TUTORIAL_MU"] = "3"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    out = subprocess.run(
        [sys.executable, "docs/tutorial.py"],
        capture_output=True, text=True, env=env, cwd=REPO,
        timeout=600,
    )
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "tutorial complete" in out.stdout
    assert "champion re-evaluated" in out.stdout
