"""The port's graft entry points (cudapathtracer_tpu_torch/entry.py) on
the CPU against the repository's ``__graft_entry__.py``, the JAX package's.

* ``entry("cpu")``'s forward step (128^2 pt_nee, 1 sample) against the
  jitted JAX ``entry()`` step on its own arguments under the per-pixel rule
  (``torch_fold_cases.assert_pixels_close``). At 128^2 the rule admits
  flipped pixels (the seam-flip share): XLA:CPU's rsqrt residue sends a
  ray of 10 of the 16,384 pixels down another path; with the JAX
  package's normalize made correctly rounded (``jax_normalize_rounded``)
  the rule holds with no pixel flipped.
* ``dryrun_multichip(n, device="cpu")`` over gloo at n = 2 and 8: the
  all-reduced loss within rtol 1e-5 of one process's loss at the same keys
  (the sharded train step's rule, tests/test_torch_parallel.py) and of the
  loss the JAX ``dryrun_multichip(8)`` prints on the 8 virtual devices.
* No fallback: more NCCL ranks than cards, or two NCCL ranks on one card,
  raise; ``python -m cudapathtracer_tpu_torch.entry 2 --device cpu`` runs
  where jax cannot be imported, in the parent and in its ranks.

Process groups are global state, so none is formed in this process: the
dry run's ranks are processes of their own."""

import contextlib
import io
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from torch_fold_cases import (MT_SEAM_FLIP_SHARE, assert_pixels_close,
                              jax_normalize_rounded)

import __graft_entry__ as G

from cudapathtracer_tpu_torch import entry as E
from cudapathtracer_tpu_torch.diff import render_grad as rg
from cudapathtracer_tpu_torch.models import procedural as tproc
from cudapathtracer_tpu_torch.ops.rng import prng_key
from cudapathtracer_tpu_torch.render.renderer import build_bvh_for_scene
import cudapathtracer_tpu_torch as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL_LOSS = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread per test process (tests/test_torch_render.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_dryrun_loss():
    """The loss the JAX ``dryrun_multichip(8)`` prints."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        G.dryrun_multichip(8)
    m = re.search(r"dryrun_multichip\(8\): .* OK, loss=([-0-9.e]+)",
                  out.getvalue())
    assert m, out.getvalue()
    return float(m.group(1))


@pytest.fixture(scope="module")
def one_process_loss():
    """The dry run's train-step loss in one process: the whole image's
    ``render_and_grad`` with both boundary terms at the dry run's keys."""
    cfg = E.DRYRUN_CFG
    scene = tproc.to_scene(tproc.cornell_box(), "cpu")
    bvh = build_bvh_for_scene(scene, cfg.leaf_size)
    cam = T.make_camera(width=cfg.width, height=cfg.height, device="cpu")
    with torch.no_grad():
        target = rg.render_image_diff(scene, cam, cfg, prng_key(7, "cpu"), 1,
                                      bvh=bvh)
    loss, _ = rg.render_and_grad(
        scene, cam, cfg, prng_key(0, "cpu"), 1, target, bvh=bvh,
        edge_samples=E.DRYRUN_EDGE_SAMPLES,
        shadow_edge_samples=E.DRYRUN_EDGE_SAMPLES)
    return float(loss)


@pytest.fixture(scope="module")
def port_entry():
    """The port's entry step on the CPU, run once."""
    fn, args = E.entry(device="cpu")
    return fn(*args)


def test_entry_matches_jax_entry(port_entry):
    fn, args = G.entry()
    want = jax.jit(fn)(*args)
    got = port_entry
    assert got.n == int(want.n) == 1
    assert all(t.device.type == "cpu" for t in got.img)
    assert_pixels_close(got.img, want.img, MT_SEAM_FLIP_SHARE)
    assert float(got.img.x.max()) > 0


@pytest.mark.parametrize("n", [2, 8])
def test_dryrun_loss(n, jax_dryrun_loss, one_process_loss, monkeypatch,
                     capsys):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    loss = E.dryrun_multichip(n, device="cpu")
    assert f"dryrun_multichip({n}): forward + train step (incl. " \
        f"boundary-term grads) OK, loss={loss:.6f}" in capsys.readouterr().out
    np.testing.assert_allclose(loss, one_process_loss, rtol=RTOL_LOSS)
    np.testing.assert_allclose(loss, jax_dryrun_loss, rtol=RTOL_LOSS)


def test_nccl_ranks_past_the_cards_raise():
    """NCCL takes one rank per card: more ranks than cards, or two ranks on
    one named card, raise before any rank starts."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="need a card each"):
        E.dryrun_multichip(cards + 1, device="cuda")
    with pytest.raises(RuntimeError, match="need a card each"):
        E.dryrun_ranks(2, device="cuda:0")


def test_entry_module_runs_without_jax(tmp_path):
    """``python -m cudapathtracer_tpu_torch.entry 2 --device cpu`` where an
    import of jax fails, in the parent and in the ranks it starts."""
    blocked = tmp_path / "jax"
    blocked.mkdir()
    (blocked / "__init__.py").write_text(
        "raise ImportError('jax is blocked here')\n")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(tmp_path), REPO]))
    out = subprocess.run(
        [sys.executable, "-m", "cudapathtracer_tpu_torch.entry", "2",
         "--device", "cpu"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert re.search(r"^dryrun_multichip\(2\): forward \+ train step "
                     r"\(incl\. boundary-term grads\) OK, loss=[0-9.]+$",
                     out.stdout, re.M), out.stdout


def test_entry_flips_are_the_rsqrt_residue(port_entry):
    """The JAX entry step with its normalize correctly rounded: the
    per-pixel rule holds with no pixel flipped."""
    fn, args = G.entry()
    with jax_normalize_rounded():
        want = jax.jit(fn)(*args)
    assert_pixels_close(port_entry.img, want.img)
