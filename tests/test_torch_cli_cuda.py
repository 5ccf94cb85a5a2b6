"""Host I/O and the CLI on the card: ``load_obj`` onto a CUDA device, an
OBJ loaded there against the procedural scene it was written from, CLI
renders whose checkpoints resume bit for bit (the reference's live config,
killed and resumed, unsharded and ``--sharded``), a CLI run in a fresh
process without jax, the reference's own CornellBox-Original from its OBJ,
and ``heatmap``. Each CLI render on the card launches K1 alone beside the
glue's kernels. Every case needs an NVIDIA GPU: it is marked ``cuda`` and
skips where torch finds none. The file imports no jax; the command that
runs the card tests is in tests/torch_card_helpers.py."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_card_helpers import dev, image_rule, launched  # noqa: F401

import cudapathtracer_tpu_torch as T
from cudapathtracer_tpu_torch import cli
from cudapathtracer_tpu_torch.models import cornell_original
from cudapathtracer_tpu_torch.models import procedural as tproc
from cudapathtracer_tpu_torch.ops.kernels import kernel_counts
from cudapathtracer_tpu_torch.utils.checkpoint import load_checkpoint
from cudapathtracer_tpu_torch.utils.png import read_png

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the reference's live config (kernel.cu:28-35) cut to 64^2 and 6 spp,
# killed at 3 with a checkpoint every 2 samples
LIVE = ["render", "--scene", "cornell-sphere", "--integrator", "bdpt",
        "--size", "64"]
LIVE_SPP, KILLED_SPP = 6, 3


def run_cli(argv, capsys):
    """``cli.main(argv)`` here, K1 alone launching. -> its standard
    error."""
    before = kernel_counts()
    cli.main(argv)
    launched(before, "k1")
    return capsys.readouterr().err


def test_load_obj_on_the_card(dev, tmp_path):
    desc = tproc.colonnade(subdiv=1)
    obj = tmp_path / "c.obj"
    tproc.write_obj(obj, tmp_path / "c.mtl", desc)
    gpu = T.load_obj(obj)
    cpu = T.load_obj(obj, device="cpu")
    assert gpu.device.type == "cuda"
    for f in gpu._fields:
        a, b = getattr(gpu, f), getattr(cpu, f)
        for x, y in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
            if torch.is_tensor(x):
                assert torch.equal(x.cpu(), y), f
            else:
                np.testing.assert_array_equal(x, y, err_msg=f)


def test_loaded_obj_renders_like_the_procedural_scene(dev, tmp_path):
    """Colonnade subdiv 3 written by ``write_obj`` and loaded through the
    native parser onto the card: its arrays ``to_scene``'s up to
    ``write_obj``'s stable sort by material, and its render within the
    golden rule of the procedural scene's, K1 alone."""
    desc = tproc.colonnade(subdiv=3)
    po = tmp_path / "colonnade.obj"
    tproc.write_obj(po, tmp_path / "c.mtl", desc)
    loaded = T.load_obj(po, device=dev)
    ref = tproc.to_scene(desc, dev)
    order = np.argsort(desc["tri_mats"], kind="stable")
    np.testing.assert_array_equal(loaded.host_verts[loaded.host_tris],
                                  desc["verts"][desc["tris"][order]])
    np.testing.assert_array_equal(loaded.tri_mat.cpu().numpy(),
                                  desc["tri_mats"][order])
    o_t = torch.from_numpy(order).to(dev)
    assert all(torch.equal(a, b[o_t]) for a, b in zip(loaded.tri_norm,
                                                      ref.tri_norm))
    np.testing.assert_array_equal(np.sort(order[loaded.lights.cpu().numpy()]),
                                  ref.lights.cpu().numpy())
    assert abs(float(loaded.total_light_area) - float(ref.total_light_area)) \
        < 1e-6 * float(ref.total_light_area)
    cfg = T.RenderConfig(width=64, height=64, spp=2, samples_per_call=2,
                         integrator="pt_nee")
    cam = T.make_camera(pos=(0.0, 2.0, 3.4), width=64, height=64,
                        focal_length=2.0, device=dev)
    before = kernel_counts()
    got = T.render(loaded, cam, cfg, seed=1234, device=dev)
    launched(before, "k1")
    want = T.render(ref, cam, cfg, seed=1234, device=dev)
    image_rule(T.finalize_image(got, cfg), T.finalize_image(want, cfg))


def test_cli_checkpoint_resumes_bit_for_bit_on_the_card(dev, tmp_path):
    ck, out = str(tmp_path / "ck.npz"), str(tmp_path / "img.png")
    base = ["render", "--scene", "cornell", "--size", "64", "--integrator",
            "pt_nee", "--checkpoint", ck, "-o", out]
    cli.main(base + ["--spp", "3"])
    cli.main(base + ["--spp", "6", "--checkpoint-every", "2"])
    st, seed = load_checkpoint(ck)
    assert st.n == 6 and seed == 1234 and st.img.x.device.type == "cuda"
    cfg = T.RenderConfig(width=64, height=64, spp=6, integrator="pt_nee")
    full = T.render(tproc.to_scene(tproc.cornell_box()),
                    T.make_camera(width=64, height=64), cfg)
    for a, b in zip((*st.img, *st.comp), (*full.img, *full.comp)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("sharded", [False, True],
                         ids=["unsharded", "sharded"])
def test_live_config_killed_and_resumed_byte_for_byte(dev, tmp_path, capsys,
                                                      sharded):
    """The live config whole, and killed at KILLED_SPP (checkpoints every 2
    samples) then resumed, unsharded or ``--sharded`` over one NCCL rank:
    the PNGs equal byte for byte, the checkpoint's n, and the PNG the
    finalized image flipped in x."""
    ck = str(tmp_path / "ck.npz")
    whole, resumed = str(tmp_path / "whole.png"), str(tmp_path / "res.png")
    run_cli(LIVE + ["--spp", str(LIVE_SPP), "-o", whole], capsys)
    flags = ["--sharded"] if sharded else []
    err = run_cli(LIVE + flags + ["--spp", str(KILLED_SPP), "--checkpoint",
                                  ck, "--checkpoint-every", "2", "-o",
                                  str(tmp_path / "killed.png")], capsys)
    assert "resumed from" not in err
    cfg = T.RenderConfig(width=64, height=64, spp=LIVE_SPP)
    assert load_checkpoint(ck, cfg)[0].n == KILLED_SPP
    err = run_cli(LIVE + flags + ["--spp", str(LIVE_SPP), "--checkpoint", ck,
                                  "-o", resumed], capsys)
    assert "resumed from" in err
    assert ("mesh: 1 devices" in err) == sharded
    assert open(whole, "rb").read() == open(resumed, "rb").read()
    st, _ = load_checkpoint(ck, cfg)
    assert st.n == LIVE_SPP
    np.testing.assert_array_equal(read_png(resumed),
                                  T.finalize_image(st, cfg)[:, ::-1])


def test_cli_in_a_fresh_process_imports_no_jax(dev, tmp_path):
    argv = LIVE + ["--spp", "2", "-o", str(tmp_path / "fresh.png")]
    code = ("import sys; from cudapathtracer_tpu_torch.cli import main; "
            f"main({argv!r}); assert 'jax' not in sys.modules")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert " Mrays/s" in proc.stderr


def test_cli_renders_cornell_box_original_from_its_obj(dev, tmp_path,
                                                        capsys):
    """The reference's own scene through ``--obj``, BDPT: finite, its
    maximum above 150, the left wall red and the right green."""
    obj = cornell_original.write_cornell_original(str(tmp_path))
    ck, png = str(tmp_path / "original.npz"), str(tmp_path / "original.png")
    run_cli(["render", "--obj", obj, "--integrator", "bdpt", "--size", "64",
             "--spp", "16", "--checkpoint", ck, "-o", png], capsys)
    st = load_checkpoint(ck)[0]
    assert all(bool(torch.isfinite(c).all()) for c in st.img)
    img = read_png(png).astype(np.float64)
    h, w = img.shape[:2]
    rows = slice(int(0.3 * h), int(0.7 * h))
    left = img[rows, int(0.05 * w):int(0.2 * w)].mean(axis=(0, 1))
    right = img[rows, int(0.8 * w):int(0.95 * w)].mean(axis=(0, 1))
    assert img.max() > 150
    assert left[0] > max(left[1:]) and right[1] > max(right[0], right[2])


def test_heatmap_on_the_card(dev, tmp_path):
    csv, fc = str(tmp_path / "out.csv"), str(tmp_path / "fc.png")
    cli.main(["heatmap", "--scene", "cornell", "--size", "64", "-o", csv,
              "--falsecolor", fc])
    lines = open(csv).read().strip().splitlines()
    assert len(lines) == 36 and all(x.endswith(",") for x in lines)
    assert read_png(fc).max() > 0
