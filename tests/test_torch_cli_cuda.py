"""Host I/O on the card: ``load_obj`` onto a CUDA device and a CLI render on
the card whose checkpoint resumes bit for bit. Every case needs an NVIDIA
GPU: it is marked ``cuda`` and skips where torch finds none. The file
imports no jax, so it runs where the JAX package is not installed:
``python -m pytest -o addopts="" --noconftest -m cuda
tests/test_torch_cli_cuda.py``."""

import numpy as np
import pytest
import torch

import cudapathtracer_tpu_torch as T
from cudapathtracer_tpu_torch import cli
from cudapathtracer_tpu_torch.models import procedural as tproc
from cudapathtracer_tpu_torch.utils.checkpoint import load_checkpoint

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; torch finds none")
    return torch.device("cuda")


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
