"""The port's tile-sharded render and train step
(cudapathtracer_tpu_torch/parallel/) on the CPU, held against the port's
one-process render and gradients and against the JAX package's sharded
ones (tests/test_parallel.py's cases) on its 8-device virtual mesh.

Process groups are global state, so none is formed in this process: the
ranks are spawned (``torch_parallel_worker.spawn_ranks`` through the port's
``parallel.launch``: two gloo ranks, one torch thread each, a free port, a
60 s rendezvous timeout and a join timeout that fails the test) and run
while this process builds the references. The forward render has no
collective, so the ranges of eight ranks are also rendered here, one
``TileMesh`` at a time.

Rules. The split moves no ray's hit and keys every random on the pixel
index, so a sharded image equals the one-process image bit for bit; against
the JAX package the per-pixel rule (``torch_fold_cases.
assert_pixels_close``). The all-reduced loss and gradients are sums in
another order: against the one-process step rtol 1e-5; against the JAX
package's sharded step the loss to rtol 1e-5, the albedo and emission
gradients to rtol 3e-5 and the vertex gradients within 2e-6 of each
array's largest |g| (the differentiable pass's measured parity,
tests/test_torch_diff.py)."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_fold_cases import assert_pixels_close
from torch_parallel_worker import (ADAM_LR, EDGE_SAMPLES, REPO, SGD_STEPS,
                                   SIZE, spawn_ranks)

import jax
import jax.numpy as jnp
import optax

import cudapathtracer_tpu as J
from cudapathtracer_tpu.diff import render_grad as jrg
from cudapathtracer_tpu.models import procedural as jproc
from cudapathtracer_tpu.ops.vecmath import Vec3 as JVec3
from cudapathtracer_tpu.parallel import mesh as jmesh
from cudapathtracer_tpu.parallel import shard as jshard
from cudapathtracer_tpu.render.renderer import build_bvh_for_scene as jbvh

import cudapathtracer_tpu_torch as T
from cudapathtracer_tpu_torch.diff import render_grad as rg
from cudapathtracer_tpu_torch.models import procedural as tproc
from cudapathtracer_tpu_torch.ops.rng import prng_key
from cudapathtracer_tpu_torch.ops.vecmath import Vec3
from cudapathtracer_tpu_torch.parallel import mesh as tmesh
from cudapathtracer_tpu_torch.parallel.launch import free_port
from cudapathtracer_tpu_torch.parallel.shard import render_sharded
from cudapathtracer_tpu_torch.render.renderer import build_bvh_for_scene

# the cases of tests/test_parallel.py: (integrator, spp, seed)
RENDERS = {"pt_nee": ("pt_nee", 3, 4), "bdpt": ("bdpt", 1, 1)}
RTOL_STEP = 1e-5
RTOL_LOSS = 1e-5
RTOL_MATERIAL = 3e-5
FRAC_OF_MAX_GEOMETRY = 2e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(pkg, integrator, spp):
    return pkg.RenderConfig(width=SIZE, height=SIZE, spp=spp,
                            integrator=integrator, samples_per_call=spp)


def _leaves_np(prefix, res):
    return [res[f"{prefix}{i}"] for i in range(13)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks' results, and the references built while they run:
    the port's one-process renders and gradients, the JAX package's sharded
    renders (2 and 8 devices) and sharded gradients (2 devices)."""
    wait = spawn_ranks("render,grad", 2, tmp_path_factory.mktemp("ranks"))

    ts = tproc.to_scene(tproc.cornell_box(), "cpu")
    tcam = T.make_camera(width=SIZE, height=SIZE, device="cpu")
    tb = build_bvh_for_scene(ts, 4)
    js = jproc.to_scene(jproc.cornell_box())
    jcam = J.make_camera(width=SIZE, height=SIZE)
    jb = jbvh(js, 4)
    ref = dict(ts=ts, tcam=tcam, tb=tb, port={}, jax={})
    for label, (integ, spp, seed) in RENDERS.items():
        ref["port"][label] = T.render(ts, tcam, _cfg(T, integ, spp),
                                      seed=seed, bvh=tb, device="cpu")
        for n_dev in ((2, 8) if label == "pt_nee" else (2,)):
            jcfg = _cfg(J, integ, spp)
            ref["jax"][label, n_dev] = jshard.render_sharded_jit(
                js, jb, jcam, jcfg, jax.random.PRNGKey(seed),
                J.init_accum(jcfg), spp, jmesh.make_tile_mesh(n_dev))

    cfg = _cfg(T, "pt_nee", 1)
    with torch.no_grad():
        target = rg.render_image_diff(ts, tcam, cfg, prng_key(9, "cpu"), 1,
                                      bvh=tb)
    ref["target"] = target
    jcfg = _cfg(J, "pt_nee", 1)
    jtarget = JVec3(*(jnp.asarray(c.numpy()) for c in target))
    idx = jnp.arange(cfg.num_pixels, dtype=jnp.uint32)
    for label, n_edge in (("interior", 0), ("both_terms", EDGE_SAMPLES)):
        ref["port"][label] = rg.render_and_grad(
            ts, tcam, cfg, prng_key(0, "cpu"), 1, target, bvh=tb,
            edge_samples=n_edge, shadow_edge_samples=n_edge)
        fn = jshard.make_sharded_grad_fn(
            js, jcam, jcfg, jmesh.make_tile_mesh(2), spp=1, bvh=jb,
            edge_samples=n_edge, shadow_edge_samples=n_edge)
        ref["jax"][label] = jax.jit(fn)(jrg.targets_of(js), jtarget, idx,
                                        jax.random.PRNGKey(0))
    ref["ranks"] = wait()
    return ref


def _state_bits(res, prefix):
    return [res[f"{prefix}_{k}"].view(np.int32) for k in (
        "img_x", "img_y", "img_z", "comp_x", "comp_y", "comp_z")]


# ---- the split --------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 8])
def test_tile_range_is_the_jax_split(world):
    """Each rank's range starts at the offset of the JAX device's shard of
    a tile-sharded pixel array, and the ranges cover it in order."""
    arr = jmesh.shard_pixels(jmesh.make_tile_mesh(world),
                             jnp.arange(SIZE * SIZE, dtype=jnp.float32))
    want = sorted((s.index[0].start or 0, s.index[0].stop or SIZE * SIZE)
                  for s in arr.addressable_shards)
    got = [tmesh.tile_range(SIZE * SIZE, tmesh.TileMesh(r, world, "cpu"))
           for r in range(world)]
    assert got == want
    x = torch.arange(SIZE * SIZE)
    parts = [tmesh.shard_pixels(tmesh.TileMesh(r, world, "cpu"), x)
             for r in range(world)]
    assert torch.equal(torch.cat(parts), x)


def test_tile_range_refuses_an_uneven_split():
    with pytest.raises(ValueError):
        tmesh.tile_range(SIZE * SIZE, tmesh.TileMesh(0, 3, "cpu"))


# ---- the forward render -----------------------------------------------------

@pytest.mark.parametrize("label", list(RENDERS))
def test_two_ranks_equal_the_unsharded_render(runs, label):
    """The gathered image of two gloo ranks equals the port's one-process
    render bit for bit, and each rank holds its own range of it."""
    want = runs["port"][label]
    want_bits = [t.view(torch.int32).numpy() for t in (*want.img,
                                                       *want.comp)]
    for r, res in enumerate(runs["ranks"]["render"]):
        assert int(res[f"{label}_n"]) == RENDERS[label][1]
        for a, b in zip(_state_bits(res, label), want_bits):
            np.testing.assert_array_equal(a, b)
        start, stop = tmesh.tile_range(SIZE * SIZE,
                                       tmesh.TileMesh(r, 2, "cpu"))
        for a, b in zip(_state_bits(res, f"{label}_tile"), want_bits):
            np.testing.assert_array_equal(a, b[start:stop])


@pytest.mark.parametrize("label", list(RENDERS))
def test_two_ranks_match_jax_render_sharded(runs, label):
    res = runs["ranks"]["render"][0]
    got = Vec3(*(torch.from_numpy(res[f"{label}_img_{c}"]) for c in "xyz"))
    assert_pixels_close(got, runs["jax"][label, 2].img)


def test_eight_ranges_rendered_apart_equal_the_whole(runs):
    """The forward pass has no collective: the ranges of eight ranks,
    rendered here one after another, concatenate to the one-process image
    bit for bit and match the JAX package's 8-device render."""
    integ, spp, seed = RENDERS["pt_nee"]
    cfg = _cfg(T, integ, spp)
    parts = []
    for r in range(8):
        mesh = tmesh.TileMesh(r, 8, torch.device("cpu"))
        start, stop = tmesh.tile_range(cfg.num_pixels, mesh)
        st = render_sharded(runs["ts"], runs["tb"], runs["tcam"], cfg,
                            prng_key(seed, "cpu"),
                            T.init_accum(cfg, device="cpu",
                                         num_pixels=stop - start), spp, mesh)
        assert st.n == spp
        parts.append(st)
    want = runs["port"]["pt_nee"]
    for k, w in enumerate((*want.img, *want.comp)):
        got = torch.cat([(*p.img, *p.comp)[k] for p in parts])
        assert torch.equal(got.view(torch.int32), w.view(torch.int32))
    assert_pixels_close(Vec3(*(torch.cat([p.img[k] for p in parts])
                               for k in range(3))),
                        runs["jax"]["pt_nee", 8].img)


def test_render_of_a_range_in_chunks_equals_the_whole(runs):
    """``render(idx=)``, the CLI's loop for a rank's range, renders four
    ranges one sample a call into states of the range's size that
    concatenate to the one-process image bit for bit."""
    integ, spp, seed = RENDERS["pt_nee"]
    cfg = dataclasses.replace(_cfg(T, integ, spp), samples_per_call=1)
    parts, calls = [], []
    for r in range(4):
        idx = torch.arange(*tmesh.tile_range(
            cfg.num_pixels, tmesh.TileMesh(r, 4, torch.device("cpu"))))
        parts.append(T.render(runs["ts"], runs["tcam"], cfg, seed=seed,
                              bvh=runs["tb"], idx=idx, device="cpu",
                              progress_cb=lambda done, st: calls.append(
                                  (done, st.img.x.shape[0]))))
    assert calls == [(n, cfg.num_pixels // 4) for n in range(1, spp + 1)] * 4
    want = runs["port"]["pt_nee"]
    for k, w in enumerate((*want.img, *want.comp)):
        got = torch.cat([(*p.img, *p.comp)[k] for p in parts])
        assert torch.equal(got.view(torch.int32), w.view(torch.int32))


def test_ranks_build_the_same_bvh(runs):
    """Replication by construction: each rank's BVH, built from the same
    scene, equals the other's and this process's array by array."""
    r0, r1 = runs["ranks"]["render"]
    tb = runs["tb"]
    want = {f"bvh_fine_{n}": t for n, t in zip(tb.fine._fields, tb.fine)}
    want |= {f"bvh_{n}": getattr(tb, n) for n in tb._fields[1:]}
    for name, t in want.items():
        np.testing.assert_array_equal(r0[name], r1[name], err_msg=name)
        np.testing.assert_array_equal(r0[name], t.numpy(), err_msg=name)


# ---- the train step ---------------------------------------------------------

@pytest.mark.parametrize("label", ["interior", "both_terms"])
def test_all_reduced_grads_match_one_process(runs, label):
    """Both ranks hold the same loss and gradients, equal to the port's
    one-process ``render_and_grad`` to rtol 1e-5 (two partial sums added
    by the all-reduce): the loss and the albedo and emission gradients
    value by value, the vertex gradients within 1e-5 of each array's
    largest |g| (a vertex's terms cancel to ~1e-8 of that scale, where a
    relative rule measures only the summation order)."""
    r0, r1 = runs["ranks"]["grad"]
    np.testing.assert_array_equal(r0["target"], np.stack(
        [c.numpy() for c in runs["target"]], axis=1))
    loss, g = runs["port"][label]
    want = [t.numpy() for t in rg.target_leaves(g)]
    for res in (r0, r1):
        got = _leaves_np(f"{label}_g", res)
        np.testing.assert_allclose(float(res[f"{label}_loss"]), float(loss),
                                   rtol=RTOL_STEP)
        for a, b in zip(got[3:9], want[3:9]):
            np.testing.assert_allclose(a, b, rtol=RTOL_STEP)
        for a, b in zip(got[:3], want[:3]):
            scale = float(np.abs(b).max())
            assert scale > 0
            assert float(np.abs(a - b).max()) <= RTOL_STEP * scale
    for a, b in zip(_leaves_np(f"{label}_g", r0), _leaves_np(f"{label}_g",
                                                             r1)):
        np.testing.assert_array_equal(a, b)
    if label == "both_terms":
        interior = _leaves_np("interior_g", r0)
        assert any(not np.array_equal(a, b) for a, b in zip(
            _leaves_np("both_terms_g", r0)[:3], interior[:3]))


@pytest.mark.parametrize("label", ["interior", "both_terms"])
def test_all_reduced_grads_match_jax(runs, label):
    """Against the JAX package's ``make_sharded_grad_fn`` on two devices:
    the loss to rtol 1e-5, the albedo and emission gradients to rtol 3e-5,
    the vertex gradients within 2e-6 of each array's largest |g|."""
    res = runs["ranks"]["grad"][0]
    jloss, jg = runs["jax"][label]
    np.testing.assert_allclose(float(res[f"{label}_loss"]), float(jloss),
                               rtol=RTOL_LOSS)
    got = _leaves_np(f"{label}_g", res)
    want = [np.asarray(t) for t in jax.tree_util.tree_leaves(jg)]
    # JAX GradTargets' leaves: verts, albedo, emission, sph_center (xyz
    # each) and sph_radius, target_leaves' order
    assert len(want) == len(got) == 13
    for a, b in zip(got[3:9], want[3:9]):
        np.testing.assert_allclose(a, b, rtol=RTOL_MATERIAL, atol=1e-9)
    for a, b in zip(got[:3], want[:3]):
        scale = float(np.abs(b).max())
        assert scale > 0
        assert float(np.abs(a - b).max()) <= FRAC_OF_MAX_GEOMETRY * scale


def test_sgd_steps_lower_the_loss(runs):
    """SGD steps (lr 0.3) toward a target lit 1.5x brighter lower the
    all-reduced loss at every step and brighten the light (material 3);
    the ranks' updates run replicated and stay equal."""
    r0, r1 = runs["ranks"]["grad"]
    losses = r0["sgd_losses"]
    assert len(losses) == SGD_STEPS + 1
    assert all(b < a for a, b in zip(losses, losses[1:])), losses
    np.testing.assert_array_equal(r0["sgd_losses"], r1["sgd_losses"])
    np.testing.assert_array_equal(r0["sgd_emission_x"],
                                  r1["sgd_emission_x"])
    assert r0["sgd_emission_x"][3] > float(runs["ts"].mat_emission.x[3])


def test_adam_factory_matches_optax(runs):
    """One step of a ``torch.optim.Adam`` factory equals ``optax.adam`` at
    the same rate on the same all-reduced gradients, to rtol 1e-5."""
    res = runs["ranks"]["grad"][0]
    p0 = [jnp.asarray(t.detach().numpy())
          for t in rg.target_leaves(rg.targets_of(runs["ts"]))]
    grads = [jnp.asarray(g) for g in _leaves_np("interior_g", res)]
    tx = optax.adam(ADAM_LR)
    updates, _ = tx.update(grads, tx.init(p0), p0)
    want = optax.apply_updates(p0, updates)
    for r, out in enumerate(runs["ranks"]["grad"]):
        for a, b in zip(_leaves_np("adam_p", out), want):
            np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL_STEP)


# ---- the group and the CLI --------------------------------------------------

def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    return env


def test_one_rank_group_without_torchrun():
    """Without torchrun's environment, ``initialize_distributed`` forms a
    real one-rank group whose collectives run."""
    code = ("import torch, torch.distributed as dist\n"
            "from cudapathtracer_tpu_torch.parallel.mesh import "
            "initialize_distributed, gather_pixels\n"
            "m = initialize_distributed(device='cpu')\n"
            "t = torch.tensor([2.0]); dist.all_reduce(t)\n"
            "g = gather_pixels(m, torch.arange(4))\n"
            "print(m.rank, m.world, dist.get_backend(), float(t), "
            "g.tolist())\n"
            "dist.destroy_process_group()\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=REPO, env=_env())
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split() == ["0", "1", "gloo", "2.0", "[0,", "1,", "2,",
                                "3]"]


def test_initialize_refuses_what_it_cannot_do(monkeypatch):
    """No card: the default device raises before any group forms. Several
    ranks without a rendezvous raise too."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.initialize_distributed()
    with pytest.raises(ValueError, match="init_method"):
        tmesh.initialize_distributed(device="cpu", world_size=2, rank=0)
    assert not torch.distributed.is_initialized()


def test_cli_sharded_under_torchrun(tmp_path):
    """``render --sharded`` on two torchrun ranks (gloo, the CPU) writes a
    PNG byte-identical to the unsharded CLI's, and its checkpoint holds the
    whole image."""
    flags = ["render", "--scene", "cornell", "--size", str(SIZE), "--spp",
             "4", "--samples-per-call", "2", "--integrator", "pt_nee",
             "--device", "cpu"]
    module = ["-m", "cudapathtracer_tpu_torch.cli"]
    one = subprocess.Popen(
        [sys.executable, *module, *flags, "-o", str(tmp_path / "one.png")],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    ck = str(tmp_path / "ck.npz")
    two = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         "2", "--master_port", str(free_port()), *module, *flags,
         "--sharded", "--checkpoint", ck, "--checkpoint-every", "2", "-o",
         str(tmp_path / "two.png")],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=300)
    _, err = one.communicate(timeout=300)
    assert one.returncode == 0, err[-2000:]
    assert two.returncode == 0, two.stderr[-3000:]
    assert "mesh: 2 devices" in two.stderr
    assert two.stderr.count("Mrays/s") == 1
    assert (tmp_path / "one.png").read_bytes() == \
        (tmp_path / "two.png").read_bytes()
    from cudapathtracer_tpu_torch.utils.checkpoint import load_checkpoint

    st, seed = load_checkpoint(ck, device="cpu")
    assert st.n == 4 and seed == 1234 and st.img.x.shape == (SIZE * SIZE,)
