"""Inverse rendering through the port's differentiable pass, on the CPU
(tests/test_inverse.py with its sizes and bound): gradient descent must
recover a perturbed scene parameter, not just descend. ``torch.optim.Adam``
takes the place of optax's adam with the same defaults."""

import pytest
import torch

import cudapathtracer_tpu_torch as T
from cudapathtracer_tpu_torch.diff import render_grad as rg
from cudapathtracer_tpu_torch.models import procedural
from cudapathtracer_tpu_torch.ops.rng import prng_key
from cudapathtracer_tpu_torch.render.renderer import build_bvh_for_scene


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread per test process (tests/test_torch_render.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_recover_wall_albedo():
    """Perturb the red wall's albedo, optimize it back from the image."""
    scene = procedural.to_scene(procedural.cornell_box(with_boxes=False),
                                "cpu")
    cam = T.make_camera(width=16, height=16, device="cpu")
    cfg = T.RenderConfig(width=16, height=16, spp=4, integrator="pt_nee",
                         samples_per_call=4)
    bvh = build_bvh_for_scene(scene, 4)
    key = prng_key(0, "cpu")
    with torch.no_grad():
        target = rg.render_image_diff(scene, cam, cfg, key, 4, bvh=bvh)
    loss_fn = rg.make_loss_fn(scene, cam, cfg, key, 4, bvh=bvh)
    p = rg.targets_of(scene)
    red = 1  # the red wall's material
    true_val = float(p.albedo.x[red])
    with torch.no_grad():
        p.albedo.x[red] = 0.15
    # only the albedo moves: the test is about recovering a parameter, not
    # silhouettes
    opt = torch.optim.Adam(list(p.albedo), lr=0.05)
    losses = []
    for _ in range(40):
        opt.zero_grad()
        loss = loss_fn(p, target)
        loss.backward()
        losses.append(float(loss))
        opt.step()
    recovered = float(p.albedo.x[red])
    assert losses[-1] < 0.2 * losses[0], (losses[0], losses[-1])
    assert abs(recovered - true_val) < 0.08, (recovered, true_val)
