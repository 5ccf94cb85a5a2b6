"""The program's own spans and counters (cudapathtracer_tpu_torch/
utils/tracing.py) on the CPU: how they nest on a PT+NEE and a BDPT render
through the packet engine, the packet engine's ray counts against a count
of the masks taken here, tracing off (nothing kept, no range in a
profiler capture, the same image bit for bit), the spans' ranges inside a
profiler capture, the differentiable pass's recompute in autograd's
backward and its kept graph, and its boundary terms' spans and edge-sample
counts."""

import threading
import time
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import cudapathtracer_tpu_torch as cpt
from cudapathtracer_tpu_torch.diff import render_grad as rg
from cudapathtracer_tpu_torch.diff.edge_sampling import build_edge_table
from cudapathtracer_tpu_torch.models import procedural
from cudapathtracer_tpu_torch.ops import packets
from cudapathtracer_tpu_torch.ops.rng import prng_key
from cudapathtracer_tpu_torch.render import renderer
from cudapathtracer_tpu_torch.utils import tracing

NAMES = {"render.batch", "integrator.radiance", "packets.trace",
         "packets.sort", "packets.cull", "packets.live_rays",
         "diff.forward", "diff.recompute"}
PASSES = 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread per test process (the suite runs several workers
    on the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def tracing_off():
    yield
    tracing.enable(False)


@pytest.fixture(scope="module")
def scene():
    return procedural.to_scene(procedural.cornell_box(), "cpu")


def _passes(scene, integrator):
    """PASSES one-sample ``render_batch`` calls of 32^2 -> the image."""
    cam = cpt.make_camera(width=32, height=32, device="cpu")
    cfg = cpt.RenderConfig(width=32, height=32, spp=PASSES,
                           integrator=integrator, samples_per_call=1)
    bvh = renderer.build_bvh_for_scene(scene, cfg.leaf_size,
                                       cluster_size=cfg.cluster_size)
    state = renderer.init_accum(cfg, device="cpu")
    for _ in range(PASSES):
        state = renderer.render_batch(scene, bvh, cam, cfg,
                                      prng_key(7, "cpu"), state, 1)
    return torch.stack(list(state.img))


def _capture_names(prof) -> set:
    return {e.name() for e in prof.profiler.kineto_results.events()}


@pytest.fixture(scope="module", params=["pt_nee", "bdpt"])
def runs(request, scene):
    """The integrator's passes traced (under a profiler, each trace call's
    R and masked-in rays counted by a wrapper here) and untraced (under a
    profiler)."""
    calls = []
    orig = packets.trace_packets

    def counted(o, d, pd, *args, mask=None, **kwargs):
        R = o.x.shape[0]
        calls.append((R, R if mask is None else int(mask.sum())))
        return orig(o, d, pd, *args, mask=mask, **kwargs)

    packets.trace_packets = counted
    try:
        tracing.enable(True)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            traced = _passes(scene, request.param)
        recs = tracing.records()
        events = [(e.name(), e.start_ns(), e.end_ns())
                  for e in prof.profiler.kineto_results.events()
                  if e.name() in NAMES]
    finally:
        tracing.enable(False)
        packets.trace_packets = orig
    kept = len(tracing.records())
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        plain = _passes(scene, request.param)
    t1 = time.time_ns()
    return SimpleNamespace(recs=recs, calls=calls, events=events,
                           traced=traced, plain=plain,
                           off_kept=(kept, tracing.records(), t0, t1),
                           off_names=_capture_names(prof))


def test_one_root_per_call_and_every_span_under_it(runs):
    recs = runs.recs
    by_id = {r.id: r for r in recs}
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == ["render.batch"] * PASSES
    assert all(r.attrs == {"samples": 1} and r.kind == "span"
               for r in roots)
    root_ids = {r.id for r in roots}
    parents = {"integrator.radiance": {"render.batch"},
               "packets.trace": {"integrator.radiance"},
               "packets.sort": {"packets.trace"},
               "packets.cull": {"packets.trace"},
               "packets.live_rays": {"packets.trace"}}
    for r in recs:
        if r.parent is None:
            continue
        up = by_id[r.parent]
        assert r.root in root_ids and r.root == up.root
        assert r.thread == by_id[r.root].thread
        assert up.name in parents[r.name], (r.name, up.name)
        assert up.start_ns <= r.start_ns <= r.end_ns <= up.end_ns
    names = {r.name for r in recs}
    assert names == set(parents) | {"render.batch"}
    # each pass: one radiance, its trace calls, each sorted and culled
    for root in roots:
        mine = [r for r in recs if r.root == root.id]
        n = sum(r.name == "packets.trace" for r in mine)
        assert n >= 2
        assert sum(r.name == "integrator.radiance" for r in mine) == 1
        for name in ("packets.sort", "packets.cull", "packets.live_rays"):
            assert sum(r.name == name for r in mine) == n


def test_rays_and_live_rays_are_the_calls(runs):
    traces = [r for r in runs.recs if r.name == "packets.trace"]
    got = [(r.attrs["rays"], r.attrs["packets.live_rays"]) for r in traces]
    assert got == runs.calls
    assert any(live < rays for rays, live in got)
    counts = [r for r in runs.recs if r.kind == "count"]
    assert [c.n for c in counts] == [live for _, live in runs.calls]


def test_off_keeps_nothing_and_renders_the_same_bits(runs):
    kept, recs, t0, t1 = runs.off_kept
    assert len(recs) == kept
    assert not [r for r in recs if t0 <= r.start_ns <= t1]
    assert not runs.off_names & NAMES
    assert torch.equal(runs.traced, runs.plain)


def test_each_range_inside_its_record(runs):
    for name in NAMES - {"packets.live_rays"}:
        recs = sorted((r.start_ns, r.end_ns) for r in runs.recs
                      if r.name == name)
        events = sorted((s, e) for n, s, e in runs.events if n == name)
        assert len(events) == len(recs), name
        for (s, e), (rs, re_) in zip(events, recs):
            assert rs <= s <= e <= re_, name
    assert not [n for n, _, _ in runs.events if n == "packets.live_rays"]


@pytest.mark.parametrize("spp", [1, 2, 3])
def test_recompute_runs_in_the_backward_once_per_sample(spp):
    """Every sample but the last is recomputed once, in autograd's thread
    during the backward, under its own ``diff.recompute`` root; the last
    keeps its graph, counted once as ``diff.kept_graphs`` on the
    ``diff.forward`` root."""
    scene = procedural.to_scene(procedural.cornell_box(with_boxes=False),
                                "cpu")
    cam = cpt.make_camera(width=8, height=8, device="cpu")
    cfg = cpt.RenderConfig(width=8, height=8, spp=spp, integrator="pt_nee",
                           samples_per_call=spp)
    bvh = renderer.build_bvh_for_scene(scene, 4)
    with torch.no_grad():
        target = rg.render_image_diff(scene, cam, cfg, prng_key(99, "cpu"),
                                      1, bvh=bvh)
    params = rg.targets_of(scene)
    tracing.enable(True)
    img = rg.render_image_diff(rg.scene_with(scene, params), cam, cfg,
                               prng_key(0, "cpu"), spp, bvh=bvh)
    forward = tracing.records()
    threads = []
    img.x.register_hook(lambda g: threads.append(threading.get_ident()))
    loss = rg.l2_loss(img, target)
    t0 = time.time_ns()
    torch.autograd.grad(loss, rg.target_leaves(params), allow_unused=True)
    t1 = time.time_ns()
    recs = tracing.records()
    assert not [r for r in forward if r.name == "diff.recompute"]
    roots = [r for r in recs if r.parent is None
             and r.name == "diff.forward"]
    assert len(roots) == 1
    kept = [r for r in recs if r.name == "diff.kept_graphs"]
    assert [(r.kind, r.n, r.parent, r.root) for r in kept] == [
        ("count", 1, roots[0].id, roots[0].id)]
    assert roots[0].attrs == {"diff.kept_graphs": 1}
    redo = [r for r in recs if r.name == "diff.recompute"]
    assert sorted(r.attrs["sample"] for r in redo) == list(range(spp - 1))
    assert threads
    if redo:
        assert {r.thread for r in redo} == set(threads)
    assert all(t0 <= r.start_ns <= r.end_ns <= t1 for r in redo)
    # the recompute traces again, under its own span
    for r in redo:
        assert r.parent is None and r.root == r.id
        inner = [x for x in recs if x.root == r.id and x is not r]
        assert {x.name for x in inner} >= {"integrator.radiance",
                                           "packets.trace"}


def test_threads_keep_their_own_stacks_and_counts_land_on_spans():
    tracing.enable(True)
    seen = {}

    def other():
        with tracing.span("b", k=2):
            tracing.count("c", 3)
            tracing.count("c", 4)

    with tracing.span("a"):
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        tracing.count("c", 1)
    tracing.count("c", 5)
    for r in tracing.records():
        seen.setdefault(r.name, []).append(r)
    a, b = seen["a"][0], seen["b"][0]
    assert a.parent is None and b.parent is None and b.root == b.id
    assert a.thread != b.thread
    assert b.attrs == {"k": 2, "c": 7} and a.attrs == {"c": 1}
    assert [(c.n, c.parent) for c in seen["c"]] == [
        (3, b.id), (4, b.id), (1, a.id), (5, None)]
    assert all(r.device_ms is None for r in tracing.records())


def test_off_span_and_count_do_nothing():
    tracing.enable(True)
    with tracing.span("kept"):
        pass
    tracing.enable(False)
    assert tracing.span("x", a=1) is tracing.span("y")
    with tracing.span("x"):
        tracing.count("c", 1)
    assert [r.name for r in tracing.records()] == ["kept"]
    tracing.enable(True)
    assert tracing.records() == []


def test_the_boundary_terms_are_spans_with_their_counts():
    """The primary and shadow boundary terms of a step: one span each under
    the step's ``diff.forward`` root (attribute ``samples``), each with its
    ``edges.drawn`` and ``edges.kept`` counts; the image and the gradients
    bit for bit those of the untraced step."""
    M = 512
    scene = procedural.to_scene(procedural.cornell_box(), "cpu")
    cam = cpt.make_camera(width=16, height=16, device="cpu")
    cfg = cpt.RenderConfig(width=16, height=16, spp=1, integrator="pt_nee",
                           samples_per_call=1)
    bvh = renderer.build_bvh_for_scene(scene, 4)
    table = build_edge_table(scene.host_tris, device="cpu")
    with torch.no_grad():
        target = rg.render_image_diff(scene, cam, cfg, prng_key(99, "cpu"),
                                      1, bvh=bvh)

    def step():
        params = rg.targets_of(scene)
        img = rg.render_image_diff(rg.scene_with(scene, params), cam, cfg,
                                   prng_key(3, "cpu"), 1, bvh=bvh,
                                   edge_samples=M, edge_table=table,
                                   shadow_edge_samples=M)
        grads = torch.autograd.grad(rg.l2_loss(img, target),
                                    rg.target_leaves(params),
                                    allow_unused=True)
        return [t.detach() for t in img] + [g for g in grads
                                            if g is not None]

    plain = step()
    tracing.enable(True)
    traced = step()
    recs = tracing.records()
    tracing.enable(False)
    assert len(plain) == len(traced) == 3 + 9
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)
    roots = [r for r in recs if r.name == "diff.forward"]
    assert len(roots) == 1 and roots[0].parent is None
    for name in ("diff.edges.primary", "diff.edges.shadow"):
        (sp,) = [r for r in recs if r.name == name]
        assert sp.kind == "span" and sp.parent == roots[0].id
        assert sp.attrs["samples"] == sp.attrs["edges.drawn"] == M
        assert 0 < sp.attrs["edges.kept"] <= M
        counts = {c.name: c.n for c in recs
                  if c.kind == "count" and c.parent == sp.id}
        assert counts == {"edges.drawn": M,
                          "edges.kept": sp.attrs["edges.kept"]}
