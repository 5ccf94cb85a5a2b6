"""The port's threefry RNG (cudapathtracer_tpu_torch/ops/rng.py) against
jax.random, bit for bit: the same keys, sites and bounces draw the same
uint32 words and the same float32 uniforms in both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudapathtracer_tpu.ops import rng as jrng
from cudapathtracer_tpu_torch.ops import rng as trng


def _keys(seed, n):
    """n random uint32 key pairs from a numpy seed, as (jax, torch)."""
    k = np.random.default_rng(seed).integers(0, 2**32, (n, 2),
                                             dtype=np.uint64)
    return jnp.asarray(k.astype(np.uint32)), torch.from_numpy(
        k.astype(np.int64))


def _np(a):
    return np.asarray(a).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1234, 2**32 - 1])
def test_prng_key_and_sample_key(seed):
    k = jax.random.PRNGKey(seed)
    tk = trng.prng_key(seed, "cpu")
    np.testing.assert_array_equal(_np(k), tk.numpy())
    for s in (0, 1, 77, 2**31 + 5):
        np.testing.assert_array_equal(_np(jrng.sample_key(k, s)),
                                      trng.sample_key(tk, s).numpy())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fold_in_bit_exact(seed):
    jk, tk = _keys(seed, 256)
    data = np.random.default_rng(seed + 10).integers(0, 2**32, 256,
                                                     dtype=np.uint64)
    want = jax.vmap(jax.random.fold_in)(jk, jnp.asarray(
        data.astype(np.uint32)))
    got = trng.fold_in(tk, torch.from_numpy(data.astype(np.int64)))
    np.testing.assert_array_equal(_np(want), got.numpy())


@pytest.mark.parametrize("n", [1, 6, 7])
def test_uniform_bit_exact(n):
    jk, tk = _keys(5, 512)
    want = jax.vmap(lambda k: jax.random.uniform(k, (n,), jnp.float32))(jk)
    got = trng.uniform(tk, n)
    np.testing.assert_array_equal(np.asarray(want).view(np.uint32),
                                  got.numpy().view(np.uint32))


@pytest.mark.parametrize("group,bounce", [(1, 0), (1, 2), (3, 1023)])
def test_uniform_sites_bit_exact(group, bounce):
    jk, tk = _keys(group * 7 + bounce, 300)
    want = jrng.uniform_sites(jk, group, 6, bounce=bounce)
    got = trng.uniform_sites(tk, group, 6, bounce=bounce)
    assert got.shape == (6, 300)
    np.testing.assert_array_equal(np.asarray(want).view(np.uint32),
                                  got.numpy().view(np.uint32))


@pytest.mark.parametrize("site,bounce", [(1, None), (101, None), (20, 3)])
def test_uniform_site_bit_exact(site, bounce):
    jk, tk = _keys(site, 200)
    want = jrng.uniform_site(jk, site, bounce=bounce)
    got = trng.uniform_site(tk, site, bounce=bounce)
    np.testing.assert_array_equal(np.asarray(want).view(np.uint32),
                                  got.numpy().view(np.uint32))


def test_pixel_keys_bit_exact():
    skey = jrng.sample_key(jax.random.PRNGKey(1234), 3)
    idx = np.arange(4096)
    want = jrng.pixel_keys(skey, jnp.asarray(idx, jnp.uint32))
    got = trng.pixel_keys(trng.sample_key(trng.prng_key(1234, "cpu"), 3),
                          torch.from_numpy(idx))
    np.testing.assert_array_equal(_np(want), got.numpy())


def _edge_count(name, **kw):
    from cudapathtracer_tpu_torch.diff.edge_sampling import build_edge_table
    from cudapathtracer_tpu_torch.models import procedural

    tris = getattr(procedural, name)(**kw)["tris"]
    return build_edge_table(tris, device="cpu").num_edges


@pytest.mark.parametrize("seed", [0, 9, 2**32 - 1])
@pytest.mark.parametrize("n", [2, 4])
def test_split_bit_exact(seed, n):
    """The boundary terms split their fold_in keys in 2 and 4."""
    base = trng.prng_key(seed, "cpu")
    for word in (0xED6E, 0x5AD0):
        want = jax.random.split(jax.random.fold_in(
            jax.random.PRNGKey(seed), word), n)
        got = trng.split(trng.fold_in(base, word), n)
        np.testing.assert_array_equal(_np(want), got.numpy())


# spans: 1, 7, the int32 limit, and the edge counts of the boundary
# terms' scenes (the diff tests' Cornell box, the bench's colonnade)
@pytest.mark.parametrize("span", [
    1, 7, 2**31 - 1, ("cornell_box", {"with_boxes": False}),
    ("cornell_box", {}), ("colonnade", {"subdiv": 3})],
    ids=["1", "7", "int32max", "E_cornell_open", "E_cornell", "E_colonnade3"])
@pytest.mark.parametrize("seed", [0, 1234])
def test_randint_bit_exact(span, seed):
    if isinstance(span, tuple):
        span = _edge_count(span[0], **span[1])
    k = jax.random.fold_in(jax.random.PRNGKey(seed), 0xED6E)
    tk = trng.fold_in(trng.prng_key(seed, "cpu"), 0xED6E)
    want = np.asarray(jax.random.randint(k, (4096,), 0, span))
    got = trng.randint(tk, 4096, 0, span)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(want, got.numpy())
    # and the uniforms the same split's second key draws
    _, ku = jax.random.split(k)
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(ku, (1000,))).view(np.uint32),
        trng.uniform_1(trng.split(tk, 2)[1], 1000).numpy().view(np.uint32))


def test_randint_empty_and_offset_spans():
    k = jax.random.PRNGKey(3)
    tk = trng.prng_key(3, "cpu")
    for lo, hi in ((5, 5), (9, 2), (-9, 17), (-2**31, 2**31 - 1)):
        np.testing.assert_array_equal(
            np.asarray(jax.random.randint(k, (512,), lo, hi)),
            trng.randint(tk, 512, lo, hi).numpy())
