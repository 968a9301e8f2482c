"""chip_smoke.py: refuses to run without a GPU, and its numerics gate
separates float32 at Precision.HIGHEST from TF32 products."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke
from evostencils_tpu.ops import reference as ref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_device_phase_raises_without_gpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.gpu_devices()


def _run(cwd, env):
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def _printed_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if isinstance(json.loads(line), dict):
                return True
        except json.JSONDecodeError:
            continue
    return False


@pytest.mark.parametrize("alone", [False, True])
def test_script_fails_without_result(alone, tmp_path):
    """On the CPU backend, and in a directory holding chip_smoke.py and
    nothing else of the repository, the script exits non-zero and prints
    no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    if alone:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    else:
        cwd = REPO
    out = _run(cwd, env)
    assert out.returncode != 0
    assert not _printed_result(out.stdout)
    want = "No module named 'evostencils_tpu'" if alone else "no GPU"
    assert want in out.stderr


def _tf32(x):
    """Round float32 values to TF32's 10-bit mantissa (nearest)."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x1000) & ~np.uint64(0x1FFF)
    return bits.astype(np.uint32).view(np.float32)


def test_numerics_gate_rejects_tf32():
    """The dense coarse solve of poisson_2d(5, 9) in float32 passes the
    gate; the same product with TF32-rounded operands does not."""
    import jax.numpy as jnp

    from evostencils_tpu.grammar import multigrid as mg
    from evostencils_tpu.ops import coarse_solve
    from evostencils_tpu.problems.poisson import poisson_2d

    problem = poisson_2d(min_level=5, max_level=9, dtype=jnp.float32)
    grids = problem.grid_at(5)
    A = mg.generate_system_operator(problem.equations, problem.operators,
                                    problem.fields, 5, 0, grids)
    shape = grids[0].interior_shape
    matrix = np.real(coarse_solve.assemble_scalar_matrix(
        A.entries[0][0].generate_stencil(), shape))
    inverse = np.linalg.inv(matrix)
    r = np.random.default_rng(0).standard_normal(matrix.shape[0])
    want = np.linalg.solve(matrix, r)
    f32 = inverse.astype(np.float32).astype(np.float64) @ r.astype(np.float32)
    tf32 = _tf32(inverse).astype(np.float64) @ _tf32(r).astype(np.float64)
    assert ref.max_relative_error(f32, want) <= chip_smoke.TOLERANCE
    assert ref.max_relative_error(tf32, want) > 10 * chip_smoke.TOLERANCE


@pytest.mark.gpu
def test_numerics_phase_on_gpu(gpu, monkeypatch):
    """Every numerics check of chip_smoke.py on the card, at 255²."""
    monkeypatch.setattr(chip_smoke, "N", 255)
    phases = chip_smoke.Phases()
    chip_smoke.phase_numerics(phases, {})
    assert phases.failures == []
