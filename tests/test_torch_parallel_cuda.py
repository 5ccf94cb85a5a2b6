"""The tile-sharded render, checkpoints and train step on the card: one rank
over NCCL, and two ranks sharing one card over gloo (NCCL refuses two ranks
on one device), against the one-process render and step on the card. Each
gathered image equals the one-process render bit for bit (pt_nee 16^2 3
spp, BDPT 16^2 1 spp, through K1); a sharded checkpoint resumes to the
uninterrupted render bit for bit; the all-reduced loss and gradients are
the one-process ``render_and_grad``'s; and the graft entry's dry run agrees
across NCCL, two gloo ranks on the card and two on the CPU, K1 alone on
every card rank. Every case needs an NVIDIA GPU: it is marked ``cuda`` and
skips where torch finds none. The file imports no jax; the command that
runs the card tests is in tests/torch_card_helpers.py."""

import numpy as np
import pytest
import torch
from torch_parallel_worker import EDGE_SAMPLES, SGD_LR, SIZE, spawn_ranks

import cudapathtracer_tpu_torch as T
from cudapathtracer_tpu_torch import entry as E
from cudapathtracer_tpu_torch.diff import render_grad as rg
from cudapathtracer_tpu_torch.models import procedural as tproc
from cudapathtracer_tpu_torch.ops.rng import prng_key
from cudapathtracer_tpu_torch.parallel.mesh import TileMesh
from cudapathtracer_tpu_torch.render.renderer import build_bvh_for_scene
from cudapathtracer_tpu_torch.utils import checkpoint as ck

pytestmark = pytest.mark.cuda

# (integrator, spp, seed), as the worker's render job
RENDERS = {"pt_nee": ("pt_nee", 3, 4), "bdpt": ("bdpt", 1, 1)}
WORLDS = pytest.mark.parametrize("world,backend", [(1, "nccl"), (2, "gloo")],
                                 ids=["nccl-1", "gloo-2"])
# the all-reduced step against the one-process step: two partial sums added
RTOL_STEP = 1e-5


def _state_bits(st):
    return [t.cpu().view(torch.int32).numpy() for t in (*st.img, *st.comp)]


@pytest.fixture(scope="module")
def unsharded():
    """The one-process references on the card: the worker's renders, its
    checkpoint job's uninterrupted 4-spp render, the train step's loss and
    gradients, interior and with both boundary terms, and the parameters
    and gradient of its first SGD step."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; torch finds none")
    scene = tproc.to_scene(tproc.cornell_box())
    cam = T.make_camera(width=SIZE, height=SIZE)
    out = {}
    for label, (integ, spp, seed) in RENDERS.items():
        cfg = T.RenderConfig(width=SIZE, height=SIZE, spp=spp,
                             integrator=integ, samples_per_call=spp)
        out[label] = _state_bits(T.render(scene, cam, cfg, seed=seed))
    out["checkpoint"] = _state_bits(T.render(scene, cam, T.RenderConfig(
        width=SIZE, height=SIZE, spp=4, integrator="pt_nee",
        samples_per_call=2), seed=1234))
    cfg = T.RenderConfig(width=SIZE, height=SIZE, spp=1, integrator="pt_nee",
                         samples_per_call=1)
    bvh = build_bvh_for_scene(scene, 4)
    with torch.no_grad():
        target = rg.render_image_diff(scene, cam, cfg, prng_key(9, "cuda"), 1,
                                      bvh=bvh)
    for label, n_edge in (("interior", 0), ("both_terms", EDGE_SAMPLES)):
        loss, g = rg.render_and_grad(scene, cam, cfg, prng_key(0, "cuda"), 1,
                                     target, bvh=bvh, edge_samples=n_edge,
                                     shadow_edge_samples=n_edge)
        out[label] = (float(loss), [t.cpu().numpy()
                                    for t in rg.target_leaves(g)])
    # one SGD step toward a target with a 1.5x brighter light, as the
    # worker's grad job takes it
    with torch.no_grad():
        bright = rg.render_image_diff(
            tproc.to_scene(tproc.cornell_box(light_scale=1.5)), cam, cfg,
            prng_key(0, "cuda"), 1, bvh=bvh)
    _, g = rg.render_and_grad(scene, cam, cfg, prng_key(0, "cuda"), 1,
                              bright, bvh=bvh)
    out["sgd_first"] = [(p.detach().cpu().double().numpy(),
                         t.cpu().double().numpy()) for p, t in zip(
        rg.target_leaves(rg.targets_of(scene)), rg.target_leaves(g))]
    return out


@pytest.fixture(scope="module")
def ranks(unsharded, tmp_path_factory):
    """{world: (the ranks' results by job, their output directory)}."""
    out = {}
    for world, backend in ((1, "nccl"), (2, "gloo")):
        d = tmp_path_factory.mktemp(f"ranks{world}")
        out[world] = (spawn_ranks("render,grad,checkpoint", world, d,
                                  device="cuda:0", backend=backend)(), d)
    return out


@WORLDS
def test_sharded_equals_unsharded_on_the_card(unsharded, ranks, world,
                                              backend):
    for res in ranks[world][0]["render"]:
        assert int(res["world"]) == world
        for label in RENDERS:
            for k, w in zip(("img_x", "img_y", "img_z", "comp_x", "comp_y",
                             "comp_z"), unsharded[label]):
                np.testing.assert_array_equal(
                    res[f"{label}_{k}"].view(np.int32), w,
                    err_msg=f"{label} {k}")


@WORLDS
def test_sharded_checkpoint_resumes_on_the_card(unsharded, ranks, world,
                                                backend):
    """Saved at 2 spp, loaded and resumed to 4: the gathered image the
    uninterrupted render's bit for bit; a set whose ranks saved different
    seeds fails to load where there are two; a load at another rank count
    raises."""
    results, out_dir = ranks[world]
    for res in results["checkpoint"]:
        assert bool(res["reload_equal"])
        for k, w in zip(("img_x", "img_y", "img_z", "comp_x", "comp_y",
                         "comp_z"), unsharded["checkpoint"]):
            np.testing.assert_array_equal(res[f"resumed_{k}"].view(np.int32),
                                          w, err_msg=k)
        assert (str(res["mixed_raised"]) != "") == (world > 1)
    cfg = T.RenderConfig(width=SIZE, height=SIZE, spp=4, integrator="pt_nee",
                         samples_per_call=2)
    with pytest.raises(FileNotFoundError):
        ck.load_checkpoint_sharded(str(out_dir / "ck.npz"),
                                   TileMesh(0, 3, torch.device("cuda")), cfg)


@WORLDS
@pytest.mark.parametrize("label", ["interior", "both_terms"])
def test_all_reduced_grads_match_one_process_on_the_card(unsharded, ranks,
                                                         world, backend,
                                                         label):
    """Every rank's loss and gradients, all-reduced, against the
    one-process ``render_and_grad`` on the card: the loss and the albedo
    and emission gradients to rtol 1e-5, the vertex gradients within 1e-5
    of each array's largest |g|; then SGD steps lower the loss on every
    rank alike, the first to p - lr g with the one-process gradient."""
    loss, want = unsharded[label]
    results = ranks[world][0]["grad"]
    for res in results:
        got = [res[f"{label}_g{i}"] for i in range(len(want))]
        np.testing.assert_allclose(float(res[f"{label}_loss"]), loss,
                                   rtol=RTOL_STEP)
        for a, b in zip(got[3:9], want[3:9]):
            np.testing.assert_allclose(a, b, rtol=RTOL_STEP)
        for a, b in zip(got[:3], want[:3]):
            assert float(np.abs(a - b).max()) <= RTOL_STEP * float(
                np.abs(b).max())
        losses = res["sgd_losses"]
        assert all(b < a for a, b in zip(losses, losses[1:])), losses
        np.testing.assert_array_equal(losses, results[0]["sgd_losses"])
        # the first step against p - lr g with the one-process gradient:
        # within 1e-5 of lr times each array's largest |g|, beside the
        # update's two float32 roundings
        for i, (p0, g) in enumerate(unsharded["sgd_first"]):
            want = p0 - SGD_LR * g
            gap = np.abs(res[f"sgd_first_p{i}"] - want)
            assert (gap <= RTOL_STEP * SGD_LR * np.abs(g).max(initial=0)
                    + 2 * np.spacing(np.abs(want).astype(np.float32))).all()


def test_dryrun_on_the_card_and_the_cpu():
    """The graft entry's dry run (a sharded render and the full train step
    with both boundary terms, 16^2) at one NCCL rank, at two gloo ranks
    sharing the card and at two on the CPU: the losses agree within 1e-5,
    and every card rank ran K1 alone, no plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; torch finds none")
    runs = {"nccl1": E.dryrun_ranks(1, device="cuda"),
            "gloo2_card": E.dryrun_ranks(2, device="cuda:0",
                                         backend="gloo"),
            "gloo2_cpu": E.dryrun_ranks(2, device="cpu")}
    losses = {k: E.dryrun_loss(len(v), v) for k, v in runs.items()}
    ref = losses["gloo2_cpu"]
    assert all(abs(v - ref) <= 1e-5 * abs(ref) for v in losses.values())
    for name in ("nccl1", "gloo2_card"):
        for out in runs[name]:
            assert int(out["k1_launches"]) > 0
            assert int(out["k2_launches"]) == int(out["k3_launches"]) == 0
            assert int(out["plain_calls"]) == 0
