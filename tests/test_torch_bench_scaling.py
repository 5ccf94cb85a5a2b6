"""The port's scaling harness (cudapathtracer_tpu_torch/bench_scaling.py) on
the CPU: its ``main`` at world 2 (two gloo ranks) and at world 1 against
the repository's ``bench_scaling.py`` (the JAX package's, on two virtual
CPU devices), at 16^2, 1 spp, colonnade subdiv 1.

* The JSON line: ``bench_scaling.py:123-130``'s keys and ``metric``
  string ("scaling efficiency 1->2 (cpu)"), a finite ratio.
* The world-2 image gathered from the ranks equals the world-1 image bit
  for bit (the parent's max |delta| line reads 0.0).
* One ``torch.profiler`` trace a rank of the world under
  SCALE_PROFILE_DIR; none asked for, none written and the artifact null.
* At world 1 the efficiency is 1.0 by definition; without a card the
  default device fails, naming CUDA.

The ranks are processes of their own: no process group is formed here."""

import contextlib
import glob
import io
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from cudapathtracer_tpu_torch import bench_scaling as S

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KNOBS = dict(SCALE_SIZE="16", SCALE_SPP="1", SCALE_SUBDIV="1")


def run_main(argv, env):
    """``S.main(argv)`` with ``env`` set, its ranks on one thread each. ->
    (the JSON line's dict, the parent's stderr)."""
    mp = pytest.MonkeyPatch()
    try:
        for k, v in dict(KNOBS, OMP_NUM_THREADS="1", **env).items():
            mp.setenv(k, v)
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            result = S.main(argv)
    finally:
        mp.undo()
    assert json.loads(out.getvalue().strip()) == result
    return result, err.getvalue()


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    prof = tmp_path_factory.mktemp("scaling") / "profile"
    result, err = run_main(["--device", "cpu", "--world", "2"],
                           {"SCALE_PROFILE_DIR": str(prof)})
    return result, err, prof


@pytest.fixture(scope="module")
def jax_line():
    """``bench_scaling.py``'s line on two virtual CPU devices, no trace."""
    code = ("import jax; jax.config.update('jax_platforms', 'cpu'); "
            "import bench_scaling; bench_scaling.main()")
    env = dict(os.environ, **KNOBS, SCALE_PROFILE_DIR="",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert len(lines) == 1, proc.stdout
    return json.loads(lines[0])


def test_json_line_is_bench_scaling_py_s(world2, jax_line):
    result, _, prof = world2
    assert set(result) == set(jax_line) == {
        "metric", "value", "unit", "vs_baseline", "profile_artifact"}
    assert result["metric"] == jax_line["metric"] == \
        "scaling efficiency 1->2 (cpu)"
    assert result["unit"] == jax_line["unit"] == "ratio"
    assert math.isfinite(result["value"]) and result["value"] > 0
    assert result["vs_baseline"] == pytest.approx(result["value"] / 0.85,
                                                  abs=2e-3)
    assert result["profile_artifact"] == str(prof)
    assert jax_line["profile_artifact"] is None


def test_world2_image_is_world1_s_bit_for_bit(world2):
    _, err, _ = world2
    assert "# sharded vs 1-rank image max |delta| = 0.0 " in err
    # each rank's windows ran the plain fold (CPU tensors) and no kernel
    lines = [ln for ln in err.splitlines() if " rank " in ln
             and "window_s=" in ln]
    assert len(lines) == 3
    for ln in lines:
        assert "k1_launches=0 k2_launches=0 k3_launches=0" in ln
        assert "plain_calls=0" not in ln


def test_one_trace_a_rank(world2):
    _, _, prof = world2
    assert len(glob.glob(os.path.join(prof, "*.pt.trace.json"))) == 2


def test_world1_is_one():
    result, err = run_main(["--device", "cpu", "--world", "1"],
                           {"SCALE_PROFILE_DIR": ""})
    assert result["value"] == 1.0
    assert result["vs_baseline"] == round(1.0 / 0.85, 3)
    assert result["metric"] == "scaling efficiency 1->1 (cpu)"
    assert result["profile_artifact"] is None
    assert "max |delta|" not in err and "profiler trace" not in err


def test_no_card_fails_naming_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        S.main([])
