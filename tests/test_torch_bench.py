"""The port's bench harness (cudapathtracer_tpu_torch/bench.py) on the CPU
against the repository's ``bench.py``, the JAX package's.

* The JSON line: ``bench.py``'s ``main()`` (a subprocess, jax on the CPU)
  and ``python -m cudapathtracer_tpu_torch.bench --device cpu`` (a
  subprocess where an import of jax fails) under the same knobs print the
  same keys, the same ``metric`` and ``unit`` strings, every value a finite
  number. The values themselves are rounded to 2 decimals, so at this size
  they read 0.0.
* The parts against the JAX package on the inputs ``bench.py`` builds
  (the colonnade, the camera at (0, 2, 3.4) with focal length 2, its
  config, key 1234): ``measure``'s and ``measure_bdpt``'s final states
  against ``render_batch_jit``'s under the per-pixel rule
  (``torch_fold_cases.assert_pixels_close``), ``measure_train``'s loss and
  gradients against the jitted ``value_and_grad`` of the JAX
  ``make_loss_fn`` under tests/test_torch_diff.py's bounds, and each part's
  config field for field ``bench.py``'s.
* The JSON's assembly (the sweep's keys, ``BENCH_BIG``, the reuse of the
  headline's scale, the baselines' rounding) on stand-in measurements; the
  TPU schedule knobs raising; no fallback without a card.

Every scene is colonnade subdiv ``SUBDIV`` (1,684 triangles; the headline's
subdiv 3 is 20,884, and the plain fold's float64 FMA emulation takes 7 s a
16^2 sample of it on one CPU thread), at ``SIZE``^2."""

import dataclasses
import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from torch_fold_cases import assert_pixels_close

import cudapathtracer_tpu as J
from cudapathtracer_tpu.diff import render_grad as jrg
from cudapathtracer_tpu.models import procedural as jproc
from cudapathtracer_tpu.render.renderer import build_bvh_for_scene as jbvh
from cudapathtracer_tpu.render.renderer import make_packet_prep as jprep
from cudapathtracer_tpu.render.renderer import render_batch_jit

from cudapathtracer_tpu_torch import bench as B
from cudapathtracer_tpu_torch import convert

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBDIV = 1
SIZE = 16
SPP = 2
# the JSON contract's knobs: the headline and the train step at 16^2
CONTRACT_ENV = dict(BENCH_SIZE="16", BENCH_SPP="1", BENCH_SWEEP="0",
                    BENCH_BDPT="0", BENCH_TRAIN_SIZE="16",
                    BENCH_SUBDIV=str(SUBDIV))
# tests/test_torch_diff.py's gradient bounds
RTOL_LOSS = 1e-5
RTOL_MATERIAL = 1e-4
FRAC_OF_MAX_GEOMETRY = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread per test process (tests/test_torch_render.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _one_json_line(proc):
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert len(lines) == 1, proc.stdout
    return json.loads(lines[0])


@pytest.fixture(scope="module")
def jax_line(tmp_path_factory):
    """``bench.py``'s line under CONTRACT_ENV, jax on the CPU, its compile
    cache in a temporary directory."""
    tmp = tmp_path_factory.mktemp("jax_bench")
    code = ("import jax; jax.config.update('jax_platforms', 'cpu'); "
            "import bench; bench.main()")
    env = dict(os.environ, **CONTRACT_ENV,
               JAX_COMPILATION_CACHE_DIR=str(tmp / "cache"))
    return _one_json_line(subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=600))


@pytest.fixture(scope="module")
def port_line(tmp_path_factory):
    """``python -m cudapathtracer_tpu_torch.bench --device cpu``'s line
    under CONTRACT_ENV, where an import of jax fails."""
    blocked = tmp_path_factory.mktemp("blocked") / "jax"
    blocked.mkdir()
    (blocked / "__init__.py").write_text(
        "raise ImportError('jax is blocked here')\n")
    env = dict(os.environ, **CONTRACT_ENV, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(blocked.parent), REPO]))
    return _one_json_line(subprocess.run(
        [sys.executable, "-m", "cudapathtracer_tpu_torch.bench", "--device",
         "cpu"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=600))


def test_json_line_is_bench_py_s(jax_line, port_line):
    assert set(port_line) == set(jax_line) == {
        "metric", "value", "unit", "vs_baseline", "train_step_ms",
        "grad_mrays"}
    assert port_line["metric"] == jax_line["metric"] == \
        "Mrays/s (colonnade 1k tris, 16^2, pt_nee, 3 bounces)"
    assert port_line["unit"] == jax_line["unit"] == "Mrays/s"
    for line in (port_line, jax_line):
        for k, v in line.items():
            if k not in ("metric", "unit"):
                assert isinstance(v, (int, float)) and math.isfinite(v), k
    assert port_line["train_step_ms"] > 0


# ---------------------------------------------------------------------------
# the parts against the JAX package
# ---------------------------------------------------------------------------

def jax_bench_config(size, spp):
    """``bench.py:67-86``'s config with every knob at its default."""
    return J.RenderConfig(
        width=size, height=size, spp=spp, integrator="pt_nee",
        samples_per_call=spp, sample_batch=1, packet_rounds=1,
        packet_first_round=2, sort_window=0, cluster_size=None,
        tile_size=None, two_level_cull=None, super_factor=8, super_list=255,
        warm_start=None, ray_groups=None, reuse_primary_hit=True)


def jax_camera(size):
    return J.make_camera(pos=(0.0, 2.0, 3.4), width=size, height=size,
                         focal_length=2.0)


@pytest.fixture(scope="module")
def jax_parts():
    """The JAX package's three parts as ``bench.py`` runs them: the
    headline's and BDPT's states (``:99-119``, ``:150-187``), the train
    step's loss and gradients (``:189-225``), and each config."""
    scene = jproc.to_scene(jproc.colonnade(subdiv=SUBDIV))
    cfg = jax_bench_config(SIZE, SPP)
    bvh = jbvh(scene, cfg.leaf_size, cluster_size=cfg.cluster_size)
    key = jax.random.PRNGKey(1234)
    cam = jax_camera(SIZE)
    head = render_batch_jit(scene, bvh, cam, cfg, key, J.init_accum(cfg),
                            SPP, prep=jprep(scene, cfg, bvh))
    bcfg = dataclasses.replace(cfg, width=SIZE, height=SIZE,
                               integrator="bdpt", spp=SPP,
                               samples_per_call=SPP, sample_batch=2,
                               tile_size=256, tile_size_vis=None)
    bdpt = render_batch_jit(scene, bvh, cam, bcfg, key, J.init_accum(bcfg),
                            SPP, prep=jprep(scene, bcfg, bvh))
    tcfg = dataclasses.replace(cfg, width=SIZE, height=SIZE, spp=1,
                               samples_per_call=1, sample_batch=1,
                               reuse_primary_hit=False)
    target = jrg.render_image_diff(scene, cam, tcfg, jax.random.PRNGKey(9),
                                   1, bvh=bvh)
    loss_fn = jrg.make_loss_fn(scene, cam, tcfg, key, 1, bvh=bvh)
    loss, g = jax.jit(jax.value_and_grad(loss_fn))(jrg.targets_of(scene),
                                                   target)
    grads = convert.targets_from_jax(convert.to_numpy_dict(g), "cpu")
    return dict(headline=(head, cfg), bdpt=(bdpt, bcfg),
                train=((float(loss), grads), tcfg))


@pytest.fixture(scope="module")
def port_parts():
    head = B.measure(SUBDIV, SPP, SIZE, "cpu", {})
    return dict(
        headline=head,
        bdpt=B.measure_bdpt(head.scene, head.bvh, head.cfg, "cpu", SIZE, SPP,
                            {}),
        train=B.measure_train(head.scene, head.bvh, head.cfg, "cpu", SIZE, 1))


@pytest.mark.parametrize("part", ["headline", "bdpt", "train"])
def test_config_is_bench_py_s(part, jax_parts, port_parts):
    assert dataclasses.asdict(port_parts[part].cfg) == \
        dataclasses.asdict(jax_parts[part][1])


@pytest.mark.parametrize("part", ["headline", "bdpt"])
def test_render_matches_jax(part, jax_parts, port_parts):
    got, want = port_parts[part], jax_parts[part][0]
    assert got.result.n == int(want.n) == SPP
    assert all(t.device.type == "cpu" for t in got.result.img)
    assert_pixels_close(got.result.img, want.img)
    assert float(got.result.img.x.max()) > 0
    assert len(got.seconds) == B.REPEATS
    assert got.mrays == pytest.approx(
        SIZE * SIZE * SPP * 4 / min(got.seconds) / 1e6)


def test_train_step_matches_jax(jax_parts, port_parts):
    """The loss to rtol 1e-5; albedo and emission gradients to rtol 1e-4;
    vertex gradients within 1e-3 of each array's largest |g|."""
    (loss, g), (jloss, jg) = port_parts["train"].result, \
        jax_parts["train"][0]
    np.testing.assert_allclose(float(loss), jloss, rtol=RTOL_LOSS)
    for field in ("albedo", "emission"):
        for a, b in zip(getattr(g, field), getattr(jg, field)):
            np.testing.assert_allclose(a.numpy(), b.numpy(),
                                       rtol=RTOL_MATERIAL, atol=1e-9)
    for a, b in zip(g.verts, jg.verts):
        assert torch.isfinite(a).all()
        scale = float(b.abs().max())
        assert scale > 0
        assert float((a - b).abs().max()) <= FRAC_OF_MAX_GEOMETRY * scale


# ---------------------------------------------------------------------------
# the line's assembly, the knobs, the device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("env", [
    {}, {"BENCH_BIG": "0"}, {"BENCH_SUBDIV": "5"},
    {"BENCH_SWEEP": "0", "BENCH_BDPT": "0", "BENCH_TRAIN": "0"}])
def test_parts_assemble_bench_py_s_keys(env, monkeypatch):
    """``parts`` on stand-in measurements (Mrays/s 10 x subdiv + 0.123...):
    the keys, the sweep's spp, the reuse of the headline's scale and the
    baselines' formulas of ``bench.py:122-148, :185-187, :223-225``."""
    calls = []

    def fake(mrays, cfg=None, seconds=(0.5, 0.25, 0.75)):
        return B.Measurement(mrays, list(seconds), cfg, None,
                             type("S", (), {"num_tris": 20884})(), None, None)

    def measure(subdiv, spp, size, device, env):
        calls.append((subdiv, spp, size))
        return fake(10.0 * subdiv + 0.1234567,
                    B.bench_config(size, spp, env))

    monkeypatch.setattr(B, "measure", measure)
    monkeypatch.setattr(B, "measure_bdpt",
                        lambda *a: fake(7.654321))
    monkeypatch.setattr(B, "measure_train",
                        lambda *a: fake(3.3333333))
    out = {}
    for _, keys, _ in B.parts("cpu", env):
        out.update(keys)
    sub = int(env.get("BENCH_SUBDIV", 3))
    head = 10.0 * sub + 0.1234567
    want = {"metric": "Mrays/s (colonnade 20k tris, 1024^2, pt_nee, 3 "
                      "bounces)",
            "value": round(head, 2), "unit": "Mrays/s",
            "vs_baseline": round(head / B.BASELINE_MRAYS, 3)}
    if "BENCH_SWEEP" not in env:
        sweep = [(4, "mrays_82k"), (5, "mrays_328k")]
        if "BENCH_BIG" not in env:
            sweep.append((6, "mrays_1310k"))
        for s, name in sweep:
            want[name] = round(10.0 * s + 0.1234567, 2)
        want["mrays_328k_vs_baseline"] = round(
            want["mrays_328k"] / B.BASELINE_MRAYS, 3)
        assert calls == [(sub, 16, 1024)] + [
            (s, 8, 1024) for s, _ in sweep if s != sub]
        want.update(bdpt_mrays=7.65,
                    bdpt_vs_baseline=round(7.654321 / B.BASELINE_MRAYS, 3),
                    train_step_ms=250.0, grad_mrays=3.33)
    assert out == want
    assert B.BASELINE_MRAYS == pytest.approx(89.62, abs=0.005)


@pytest.mark.parametrize("knob,name", [("BENCH_WARM", "warm_start"),
                                       ("BENCH_RAYGROUPS", "ray_groups")])
def test_schedule_knobs_raise(knob, name):
    with pytest.raises(NotImplementedError, match=name):
        B.measure(SUBDIV, 1, SIZE, "cpu", {knob: "2"})


def test_unknown_cull_raises():
    """``bench.py:82-84``'s map: a typo never runs another cull."""
    with pytest.raises(KeyError):
        B.bench_config(SIZE, 1, {"BENCH_TWO_LEVEL": "supr"})


def test_no_card_fails_naming_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        B.main([])
