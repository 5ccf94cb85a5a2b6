"""The port's sharded checkpoints (cudapathtracer_tpu_torch/utils/
checkpoint.py: ``save_checkpoint_sharded``, ``load_checkpoint_sharded``)
held against the JAX package's on the CPU.

The format is the JAX package's member for member (name, dtype, shape), so
a single-process JAX save over the 8 virtual devices loads in a one-rank
port, and a one-rank port save loads in the JAX package on a one-device
mesh, both bit for bit. Two spawned gloo ranks
(``torch_parallel_worker.spawn_ranks``) save at 2 spp and resume to 4 bit
for bit against the uninterrupted render, and refuse a set whose ranks
saved different seeds; a load with another rank count, a missing shard or
another config raises."""

import dataclasses
import shutil

import numpy as np
import pytest
import torch
from torch_parallel_worker import SIZE, spawn_ranks

import jax

import cudapathtracer_tpu as J
from cudapathtracer_tpu.models import procedural as jproc
from cudapathtracer_tpu.parallel import mesh as jmesh
from cudapathtracer_tpu.parallel import shard as jshard
from cudapathtracer_tpu.render.renderer import build_bvh_for_scene as jbvh
from cudapathtracer_tpu.utils import checkpoint as jck

import cudapathtracer_tpu_torch as T
from cudapathtracer_tpu_torch import convert
from cudapathtracer_tpu_torch.models import procedural as tproc
from cudapathtracer_tpu_torch.parallel.mesh import TileMesh, tile_range
from cudapathtracer_tpu_torch.utils import checkpoint as tck

SEED = 1234
ONE = TileMesh(0, 1, torch.device("cpu"))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(pkg, spp):
    return pkg.RenderConfig(width=SIZE, height=SIZE, spp=spp,
                            integrator="pt_nee", samples_per_call=2)


def _bits(state):
    return [np.asarray(c).view(np.int32) for c in (*state.img, *state.comp)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks' results and files, the port's uninterrupted 4-spp
    render, and the JAX package's 2-spp sharded states (8 devices and 1)
    with their sharded saves."""
    ranks_dir = tmp_path_factory.mktemp("ranks")
    wait = spawn_ranks("checkpoint", 2, ranks_dir)
    d = tmp_path_factory.mktemp("jax")
    js = jproc.to_scene(jproc.cornell_box())
    jcam = J.make_camera(width=SIZE, height=SIZE)
    jb = jbvh(js, 4)
    out = dict(ranks_dir=ranks_dir, jax_dir=d)
    for n_dev in (8, 1):
        st = jshard.render_sharded_jit(
            js, jb, jcam, _cfg(J, 2), jax.random.PRNGKey(SEED),
            J.init_accum(_cfg(J, 2)), 2, jmesh.make_tile_mesh(n_dev))
        jck.save_checkpoint_sharded(d / f"jax{n_dev}.npz", st, SEED,
                                    _cfg(J, 2))
        out[f"jax{n_dev}"] = st
    out["full"] = T.render(tproc.to_scene(tproc.cornell_box(), "cpu"),
                           T.make_camera(width=SIZE, height=SIZE,
                                         device="cpu"),
                           _cfg(T, 4), seed=SEED, device="cpu")
    out["ranks"] = wait()["checkpoint"]
    return out


def test_members_match_the_jax_save(runs, tmp_path):
    """The port's one-rank save of the JAX state carried over has the JAX
    save's members, each with its dtype, shape and bits."""
    st = convert.accum_from_jax(convert.to_numpy_dict(runs["jax1"]), "cpu")
    tck.save_checkpoint_sharded(tmp_path / "port.npz", st, SEED,
                                _cfg(T, 2), ONE)
    ours = tmp_path / "port.npz.p0of1.npz"
    theirs = runs["jax_dir"] / "jax1.npz.p0of1.npz"
    assert ours.exists() and theirs.exists()
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert a[k].tobytes() == b[k].tobytes(), k
        assert a["n"].dtype == np.int32 and a["n"].shape == ()


def test_jax_eight_device_save_loads_in_one_rank(runs):
    """Eight shards in the JAX package's one file tile the one rank's
    range: the loaded state equals the JAX state bit for bit."""
    with np.load(runs["jax_dir"] / "jax8.npz.p0of1.npz") as z:
        assert int(z["img_x_nshards"]) == 8
    st, seed = tck.load_checkpoint_sharded(runs["jax_dir"] / "jax8.npz",
                                           ONE, _cfg(T, 2))
    assert seed == SEED and st.n == 2
    for a, b in zip(_bits(st), _bits(runs["jax8"])):
        np.testing.assert_array_equal(a, b)


def test_one_rank_save_loads_in_jax(runs, tmp_path):
    """A port save at one rank loads in the JAX package on a one-device
    mesh, bit for bit."""
    st = convert.accum_from_jax(convert.to_numpy_dict(runs["jax8"]), "cpu")
    tck.save_checkpoint_sharded(tmp_path / "p.npz", st, SEED, _cfg(T, 2),
                                ONE)
    jst, seed = jck.load_checkpoint_sharded(tmp_path / "p.npz",
                                            jmesh.make_tile_mesh(1),
                                            _cfg(J, 2))
    assert seed == SEED and int(jst.n) == 2
    for a, b in zip(_bits(jst), _bits(st)):
        np.testing.assert_array_equal(a, b)


def test_two_ranks_resume_bit_for_bit(runs):
    """Two ranks save at 2 spp, load their own files back unchanged and
    resume to 4 spp: the gathered image equals the uninterrupted render."""
    for r, res in enumerate(runs["ranks"]):
        assert bool(res["reload_equal"]), r
        assert int(res["resumed_n"]) == 4
        for k, want in zip(("img_x", "img_y", "img_z", "comp_x", "comp_y",
                            "comp_z"), _bits(runs["full"])):
            np.testing.assert_array_equal(res[f"resumed_{k}"].view(np.int32),
                                          want)
    for r in range(2):
        with np.load(runs["ranks_dir"] / f"ck.npz.p{r}of2.npz") as z:
            assert (int(z["process_index"]), int(z["process_count"])) == \
                (r, 2)
            assert int(z["img_x_o0"]) == tile_range(SIZE * SIZE,
                                                    TileMesh(r, 2, "cpu"))[0]


def test_mixed_n_seed_raises_on_every_rank(runs):
    for res in runs["ranks"]:
        assert "inconsistent checkpoint set" in str(res["mixed_raised"])


@pytest.mark.parametrize("world", [1, 4])
def test_changed_world_size_raises(runs, world):
    """A two-rank save has no file for a rank of another rank count."""
    mesh = TileMesh(0, world, torch.device("cpu"))
    with pytest.raises(FileNotFoundError, match="rank count"):
        tck.load_checkpoint_sharded(runs["ranks_dir"] / "ck.npz", mesh)


def test_a_missing_shard_raises(runs, tmp_path):
    """Drop one of the JAX save's eight shards: the range no longer tiles,
    and the load names the offset."""
    src = runs["jax_dir"] / "jax8.npz.p0of1.npz"
    with np.load(src) as z:
        members = {k: z[k] for k in z.files}
    for leaf in ("img_x", "img_y", "img_z", "comp_x", "comp_y", "comp_z"):
        members[f"{leaf}_o3"] = np.asarray(-1)
    np.savez(tmp_path / "gap.npz.p0of1.npz", **members)
    with pytest.raises(AssertionError, match="offset 96"):
        tck.load_checkpoint_sharded(tmp_path / "gap.npz", ONE)
    shutil.copy(src, tmp_path / "whole.npz.p0of1.npz")
    assert tck.load_checkpoint_sharded(tmp_path / "whole.npz", ONE)[0].n == 2


@pytest.mark.parametrize("change", [
    dict(width=32, height=32), dict(integrator="bdpt")],
    ids=["size", "integrator"])
def test_config_mismatch_raises(runs, change):
    other = dataclasses.replace(_cfg(T, 2), **change)
    with pytest.raises(AssertionError):
        tck.load_checkpoint_sharded(runs["jax_dir"] / "jax8.npz", ONE, other)


def test_accum_tile_from_jax(runs):
    """convert.accum_tile_from_jax: the rank's range of a JAX state."""
    d = convert.to_numpy_dict(runs["jax8"])
    whole = convert.accum_from_jax(d, "cpu")
    for r in range(4):
        mesh = TileMesh(r, 4, torch.device("cpu"))
        start, stop = tile_range(SIZE * SIZE, mesh)
        tile = convert.accum_tile_from_jax(d, mesh)
        assert tile.n == 2
        for a, b in zip((*tile.img, *tile.comp), (*whole.img, *whole.comp)):
            assert torch.equal(a, b[start:stop])
