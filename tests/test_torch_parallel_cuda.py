"""The tile-sharded render on the card: one rank over NCCL, and two ranks
sharing one card over gloo (NCCL refuses two ranks on one device). Each
gathered image equals the one-process render on the card bit for bit
(pt_nee 16^2 3 spp, BDPT 16^2 1 spp, through K1). Every case needs an
NVIDIA GPU: it is marked ``cuda`` and skips where torch finds none. The
file imports no jax: ``python -m pytest -o addopts="" --noconftest -m cuda
tests/test_torch_parallel_cuda.py``."""

import numpy as np
import pytest
import torch
from torch_parallel_worker import SIZE, spawn_ranks

import cudapathtracer_tpu_torch as T
from cudapathtracer_tpu_torch.models import procedural as tproc

pytestmark = pytest.mark.cuda

# (integrator, spp, seed), as the worker's render job
RENDERS = {"pt_nee": ("pt_nee", 3, 4), "bdpt": ("bdpt", 1, 1)}


@pytest.fixture(scope="module")
def unsharded():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; torch finds none")
    scene = tproc.to_scene(tproc.cornell_box())
    cam = T.make_camera(width=SIZE, height=SIZE)
    out = {}
    for label, (integ, spp, seed) in RENDERS.items():
        cfg = T.RenderConfig(width=SIZE, height=SIZE, spp=spp,
                             integrator=integ, samples_per_call=spp)
        st = T.render(scene, cam, cfg, seed=seed)
        out[label] = [t.cpu().view(torch.int32).numpy()
                      for t in (*st.img, *st.comp)]
    return out


@pytest.mark.parametrize("world,backend", [(1, "nccl"), (2, "gloo")],
                         ids=["nccl-1", "gloo-2"])
def test_sharded_equals_unsharded_on_the_card(unsharded, tmp_path, world,
                                              backend):
    ranks = spawn_ranks("render", world, tmp_path, device="cuda:0",
                        backend=backend)()["render"]
    for res in ranks:
        assert int(res["world"]) == world
        for label, want in unsharded.items():
            for k, w in zip(("img_x", "img_y", "img_z", "comp_x", "comp_y",
                             "comp_z"), want):
                np.testing.assert_array_equal(
                    res[f"{label}_{k}"].view(np.int32), w,
                    err_msg=f"{label} {k}")
