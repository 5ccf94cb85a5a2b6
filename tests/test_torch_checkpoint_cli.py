"""The port's checkpoints (cudapathtracer_tpu_torch/utils/checkpoint.py) and
its CLI (cudapathtracer_tpu_torch/cli.py), held against the JAX package's
on the CPU.

Checkpoints keep the JAX package's npz format member for member (dtype,
shape and bits), so a render saved by either package resumes in the other:
a port resume equals the uninterrupted port render bit for bit, a JAX save
resumed in the port matches the JAX render under
``torch_fold_cases.assert_pixels_close``, and a port save loads in the JAX
package's ``load_checkpoint`` and resumes there bit for bit. The CLI runs as
``--device cpu`` subprocesses at 16^2 (render, heatmap, checkpoint resume)
against the JAX CLI's output, which runs in this process."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_fold_cases import assert_pixels_close

import cudapathtracer_tpu as J
from cudapathtracer_tpu import cli as jcli
from cudapathtracer_tpu.models import procedural as jproc
from cudapathtracer_tpu.utils import checkpoint as jck
from cudapathtracer_tpu.utils.ppm import read_ppm as jread_ppm

import cudapathtracer_tpu_torch as T
from cudapathtracer_tpu_torch import cli as tcli
from cudapathtracer_tpu_torch import convert
from cudapathtracer_tpu_torch.models import procedural as tproc
from cudapathtracer_tpu_torch.utils import checkpoint as tck
from cudapathtracer_tpu_torch.utils.png import read_png
from cudapathtracer_tpu_torch.utils.ppm import read_ppm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 16
SEED = 1234
# the JAX CLI's render flags, which the fixture's configs equal, so that its
# jitted batch is compiled once for the module
CLI_RENDER = ["render", "--scene", "cornell", "--size", str(SIZE),
              "--samples-per-call", "2", "--integrator", "pt_nee"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(pkg, spp):
    return pkg.RenderConfig(width=SIZE, height=SIZE, spp=spp,
                            integrator="pt_nee", samples_per_call=2)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """The JAX package's renders (2 and 4 spp), its save at 2 spp, and its
    CLI's PPM, CSV and falsecolor PNG at 16^2."""
    d = tmp_path_factory.mktemp("jax")
    scene = jproc.to_scene(jproc.cornell_box())
    cam = J.make_camera(width=SIZE, height=SIZE)
    part = J.render(scene, cam, _cfg(J, 2), seed=SEED)
    full = J.render(scene, cam, _cfg(J, 4), seed=SEED)
    jck.save_checkpoint(d / "jax.npz", part, SEED, _cfg(J, 2))
    jcli.main(CLI_RENDER + ["--spp", "2", "-o", str(d / "jax.ppm")])
    jcli.main(["heatmap", "--scene", "cornell", "--size", str(SIZE),
               "-o", str(d / "jax.csv"), "--falsecolor",
               str(d / "jax_fc.png")])
    return dict(dir=d, scene=scene, cam=cam, part=part, full=full)


def _port(spp, state=None, progress_cb=None):
    return T.render(tproc.to_scene(tproc.cornell_box(), "cpu"),
                    T.make_camera(width=SIZE, height=SIZE, device="cpu"),
                    _cfg(T, spp), seed=SEED, state=state,
                    progress_cb=progress_cb, device="cpu")


def _bits(state):
    return [c.view(torch.int32) for c in (*state.img, *state.comp)]


def test_port_resume_is_bit_identical(tmp_path):
    full = _port(4)
    p = tmp_path / "ck.npz"
    tck.save_checkpoint(p, _port(2), SEED, _cfg(T, 2))
    loaded, seed = tck.load_checkpoint(p, _cfg(T, 2), device="cpu")
    assert seed == SEED and loaded.n == 2
    resumed = _port(4, state=loaded)
    assert resumed.n == full.n == 4
    for a, b in zip(_bits(resumed), _bits(full)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("change", [
    dict(width=32, height=32), dict(integrator="bdpt")],
    ids=["size", "integrator"])
def test_checkpoint_validates_config(change, tmp_path):
    import dataclasses

    p = tmp_path / "ck.npz"
    tck.save_checkpoint(p, _port(2), SEED, _cfg(T, 2))
    other = dataclasses.replace(_cfg(T, 2), **change)
    with pytest.raises(AssertionError):
        tck.load_checkpoint(p, other, device="cpu")
    with pytest.raises(AssertionError):
        jck.load_checkpoint(p, dataclasses.replace(_cfg(J, 2), **change))


def test_jax_save_resumes_in_port(jax_ref):
    st, seed = tck.load_checkpoint(jax_ref["dir"] / "jax.npz", _cfg(T, 2),
                                   device="cpu")
    assert seed == SEED and st.n == 2
    resumed = _port(4, state=st)
    assert resumed.n == 4
    assert_pixels_close(resumed.img, jax_ref["full"].img)


def test_port_save_is_the_jax_format_and_resumes_in_jax(jax_ref, tmp_path):
    """The port's save of the JAX state carried over equals the JAX save
    member for member (dtype, shape, bits); the JAX package loads it and
    resumes to the JAX package's uninterrupted render bit for bit."""
    part = jax_ref["part"]
    st = convert.accum_from_jax(convert.to_numpy_dict(part), "cpu")
    p = tmp_path / "port.npz"
    tck.save_checkpoint(p, st, SEED, _cfg(T, 2))
    with np.load(p) as ours, np.load(jax_ref["dir"] / "jax.npz") as theirs:
        assert sorted(ours.files) == sorted(theirs.files)
        for k in theirs.files:
            a, b = ours[k], theirs[k]
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert a.tobytes() == b.tobytes(), k
        assert ours["n"].dtype == np.int32 and ours["n"].shape == ()

    jst, seed = jck.load_checkpoint(p, _cfg(J, 2))
    assert seed == SEED and int(jst.n) == 2
    resumed = J.render(jax_ref["scene"], jax_ref["cam"], _cfg(J, 4),
                       seed=SEED, state=jst)
    for a, b in zip((*resumed.img, *resumed.comp),
                    (*jax_ref["full"].img, *jax_ref["full"].comp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---- the CLI ---------------------------------------------------------------

def _run_cli(args, timeout=300):
    """The port's CLI in a fresh process on one torch thread; it must not
    import jax."""
    code = ("import sys; from cudapathtracer_tpu_torch.cli import main; "
            f"main({args!r}); assert 'jax' not in sys.modules, 'jax'")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=timeout, cwd=REPO, env=env)


def _golden_rule(a, b, tol=2):
    """tests/test_goldens.py:_check's rule: under 0.5% of the channels more
    than ``tol`` apart."""
    assert a.shape == b.shape
    frac = (np.abs(a.astype(np.int32) - b.astype(np.int32)) > tol).mean()
    assert frac < 0.005, frac


def test_cli_render_and_heatmap_match_the_jax_cli(jax_ref, tmp_path):
    out = str(tmp_path / "img.ppm")
    r = _run_cli(CLI_RENDER + ["--spp", "2", "--device", "cpu", "-o", out])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "Mrays/s" in r.stderr and "devices: 1 x cpu" in r.stderr
    img = read_ppm(out)
    assert img.shape == (SIZE, SIZE, 3)
    _golden_rule(img, jread_ppm(str(jax_ref["dir"] / "jax.ppm")))

    csv, fc = str(tmp_path / "out.csv"), str(tmp_path / "bvh.png")
    r2 = _run_cli(["heatmap", "--scene", "cornell", "--size", str(SIZE),
                   "--device", "cpu", "-o", csv, "--falsecolor", fc])
    assert r2.returncode == 0, r2.stderr[-2000:]
    lines = open(csv).read().strip().splitlines()
    assert len(lines) == 36 and all(line.endswith(",") for line in lines)
    assert open(csv).read() == open(jax_ref["dir"] / "jax.csv").read()
    img2 = read_png(fc)
    assert img2.shape == (SIZE, SIZE, 3) and img2.max() > 0
    _golden_rule(img2, read_png(str(jax_ref["dir"] / "jax_fc.png")))


def test_cli_checkpoint_resume(tmp_path):
    out = str(tmp_path / "img.png")
    ck = str(tmp_path / "ck.npz")
    base = CLI_RENDER + ["--device", "cpu", "--checkpoint", ck, "-o", out]
    r1 = _run_cli(base + ["--spp", "2"])
    assert r1.returncode == 0, r1.stderr[-2000:]
    r2 = _run_cli(base + ["--spp", "4", "--checkpoint-every", "2"])
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert "resumed from" in r2.stderr
    st, seed = tck.load_checkpoint(ck, device="cpu")
    assert st.n == 4 and seed == SEED
    full = _port(4)
    for a, b in zip(_bits(st), _bits(full)):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(read_png(out),
                                  T.finalize_image(full, _cfg(T, 4))[:, ::-1])


def test_cli_without_a_card_fails_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device renders")
    r = _run_cli(CLI_RENDER + ["--spp", "2", "-o",
                               str(tmp_path / "img.ppm")])
    assert r.returncode != 0
    assert "CUDA" in r.stderr
    assert not os.path.exists(tmp_path / "img.ppm")


def test_cli_sharded_one_rank_matches_unsharded(tmp_path):
    """``render --sharded`` without torchrun renders on a one-rank group
    (parallel/mesh.py) and writes the unsharded CLI's PNG byte for byte."""
    pngs = [str(tmp_path / f"{n}.png") for n in ("plain", "sharded")]
    base = CLI_RENDER + ["--spp", "2", "--device", "cpu"]
    r1 = _run_cli(base + ["-o", pngs[0]])
    assert r1.returncode == 0, r1.stderr[-2000:]
    r2 = _run_cli(base + ["--sharded", "-o", pngs[1]])
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert "mesh: 1 devices" in r2.stderr and "Mrays/s" in r2.stderr
    assert open(pngs[0], "rb").read() == open(pngs[1], "rb").read()


def test_cli_packet_engine_takes_auto_only(tmp_path):
    with pytest.raises(SystemExit):
        tcli.main(CLI_RENDER + ["--packet-engine", "pallas", "--device",
                                "cpu", "-o", str(tmp_path / "img.ppm")])
