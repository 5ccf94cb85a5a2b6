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
