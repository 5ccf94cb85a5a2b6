"""The check that decides ``correct`` fails what it must: the control (the
reference in bfloat16 in the program's place) and whole runs with the
timed path broken underneath, at test size on the CPU, against the
limits set at that size (tiny.py)."""

from __future__ import annotations

import pytest
import torch

from h100_bench import control, harness
from h100_bench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


def _run(root, cell, seed=11):
    torch.set_num_threads(2)
    return harness.run(cell, seed, 0.3, False, device="cpu",
                       **tiny.where(root))


ONE_CARD = [c for c in tiny.CELLS if not c.endswith("x4")]


@pytest.mark.parametrize("cell", ONE_CARD)
def test_sound_run_is_correct(root, cell):
    assert _run(root, cell)["correct"] is True


@pytest.mark.parametrize("cell", ONE_CARD)
def test_control_fails_the_limits(root, cell):
    torch.set_num_threads(2)
    r = control.readings(cell, 21, 0.3, "cpu", **tiny.where(root))
    ok, _ = harness.check.verdict(r["program"], r["limits"])
    low, _ = harness.check.verdict(r["control"], r["limits"])
    assert ok and not low, r


def _render_faults():
    from cudapathtracer_tpu_torch.render import renderer

    orig = renderer.render_batch
    orig_radiance = renderer._radiance

    def unchanged(scene, bvh, cam, cfg, key, state, n, **kw):
        orig(scene, bvh, cam, cfg, key, state, n, **kw)
        return state

    def half(scene, bvh, cam, cfg, key, state, n, **kw):
        # the first half of the pixels rendered, the rest left out
        h = cfg.num_pixels // 2
        idx = torch.arange(h, device=state.img.x.device)
        sub = renderer.AccumState(state.img.map(lambda c: c[:h]),
                                  state.comp.map(lambda c: c[:h]), state.n)
        out = orig(scene, bvh, cam, cfg, key, sub, n, idx=idx, **kw)

        def whole(part, full):
            return type(full)(*(torch.cat([a, b[h:]])
                                for a, b in zip(part, full)))
        return renderer.AccumState(whole(out.img, state.img),
                                   whole(out.comp, state.comp), out.n)

    def altered(*a, **kw):
        return orig_radiance(*a, **kw) * 1.05

    return {"state unchanged": ("render_batch", unchanged),
            "half the batch left out": ("render_batch", half),
            "answer altered where produced": ("_radiance", altered)}


@pytest.mark.parametrize("fault", ["state unchanged",
                                   "half the batch left out",
                                   "answer altered where produced"])
@pytest.mark.parametrize("cell", ["tiny_col.pt", "tiny_cb.bd"])
def test_render_fault_is_not_correct(root, cell, fault, monkeypatch):
    from cudapathtracer_tpu_torch.render import renderer

    attr, fn = _render_faults()[fault]
    monkeypatch.setattr(renderer, attr, fn)
    assert _run(root, cell)["correct"] is False


def _train_faults():
    from cudapathtracer_tpu_torch.diff import render_grad as rg

    orig_with, orig_l2, orig_rad = rg.scene_with, rg.l2_loss, rg._radiance

    def unchanged(scene, p):
        # every gradient 0: the update leaves the parameters as they were
        return orig_with(scene, rg.from_leaves(
            [t.detach() + 0.0 * t for t in rg.target_leaves(p)]))

    def half(img, target):
        h = img.x.shape[0] // 2
        return orig_l2(img.map(lambda c: c[:h]), target.map(lambda c: c[:h]))

    def altered(*a, **kw):
        return orig_rad(*a, **kw) * 1.05

    return {"state unchanged": ("scene_with", unchanged),
            "half the batch left out": ("l2_loss", half),
            "answer altered where produced": ("_radiance", altered)}


@pytest.mark.parametrize("fault", ["state unchanged",
                                   "half the batch left out",
                                   "answer altered where produced"])
def test_train_fault_is_not_correct(root, fault, monkeypatch):
    from cudapathtracer_tpu_torch.diff import render_grad as rg

    attr, fn = _train_faults()[fault]
    monkeypatch.setattr(rg, attr, fn)
    assert _run(root, "tiny_col.tr")["correct"] is False
