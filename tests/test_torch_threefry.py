"""The RNG's hash as one CUDA kernel per call (ops/kernels/threefry.py).

Every public call of ``ops/rng.py`` takes the kernel for keys on a card and
the plain int64 code for CPU keys (``test_torch_rng.py`` holds the plain
code against ``jax.random``). The CPU tests hold the dispatch, the counters
and the wrapper's operand resolution, with the launch stood in for by an
emulation that reads the operands as the kernel does and hashes with the
plain code; the tests marked ``cuda`` hold the kernel to the plain code on
the card, bit for bit, and skip where torch finds no card. The file imports
no jax: ``python -m pytest -o addopts="" --noconftest -m cuda
tests/test_torch_threefry.py``."""

import subprocess
import sys

import pytest
import torch

from cudapathtracer_tpu_torch.ops import rng
from cudapathtracer_tpu_torch.ops.kernels import kernel_counts
from cudapathtracer_tpu_torch.ops.kernels import threefry as kt

MASK = 0xFFFFFFFF


def _keys(n, seed, device="cpu", top=False):
    """n random uint32 key pairs (int64 (n, 2)); ``top``: every word with
    its top bit set, near 2^32 - 1 for a third of them."""
    g = torch.Generator().manual_seed(seed)
    k = torch.randint(0, 2**32, (n, 2), generator=g, dtype=torch.int64)
    if top:
        k = k | 0x80000000
        k[::3] = MASK - torch.randint(0, 4, (len(k[::3]), 2), generator=g)
    return k.to(device)


def _plain(fn, *args, **kw):
    """``fn`` through the plain int64 code, whatever the keys' device."""
    on_card = rng._on_card
    rng._on_card = lambda keys: False
    try:
        return fn(*args, **kw)
    finally:
        rng._on_card = on_card


def assert_same_bits(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    assert torch.equal(got.cpu(), want.cpu())


# the public calls: name -> (keys -> result); each with the count of plain
# hashes it makes on CPU keys and of launches on the card
CALLS = {
    "fold_in_int": (lambda k: rng.fold_in(k, 0xED6E), 1, 1),
    "fold_in_tensor": (lambda k: rng.fold_in(
        k, torch.arange(k.shape[0], device=k.device) * 977 + 2**31), 1, 1),
    "sample_key": (lambda k: rng.sample_key(k[0], 2**31 + 5), 1, 1),
    "pixel_keys": (lambda k: rng.pixel_keys(
        k[0], torch.arange(k.shape[0], device=k.device)), 1, 1),
    "uniform_n1": (lambda k: rng.uniform(k, 1), 1, 1),
    "uniform_6": (lambda k: rng.uniform(k, 6), 1, 1),
    "uniform_7": (lambda k: rng.uniform(k, 7), 1, 1),
    "uniform_site": (lambda k: rng.uniform_site(k, rng.Sites.LENS_U1), 2, 1),
    "uniform_site_bounce": (lambda k: rng.uniform_site(
        k, rng.Sites.PIXEL_JITTER_X, bounce=3), 3, 1),
    "uniform_sites_pt": (lambda k: rng.uniform_sites(
        k, rng.SiteGroups.PT_BOUNCE, 6, bounce=2), 2, 1),
    "uniform_sites_bdpt": (lambda k: rng.uniform_sites(
        k, rng.SiteGroups.BDPT, 7), 2, 1),
    "split": (lambda k: rng.split(k[0], 4), 1, 1),
    "randint": (lambda k: rng.randint(k[0], 1000, 0, 30786), 3, 3),
    "uniform_1_of_one_key": (lambda k: rng.uniform_1(k[0], 1000), 1, 1),
}


@pytest.mark.parametrize("name", list(CALLS))
def test_cpu_calls_take_the_plain_path_and_launch_nothing(name):
    fn, hashes, _ = CALLS[name]
    before = kernel_counts()
    fn(_keys(300, 1))
    after = kernel_counts()
    assert after["threefry_launches"] == before["threefry_launches"]
    assert after["threefry_plain_calls"] - before["threefry_plain_calls"] \
        == hashes


def test_kernel_counts_reports_the_threefry_counters():
    counts = kernel_counts()
    assert counts["threefry_launches"] == kt.threefry.launches
    assert counts["threefry_plain_calls"] == kt.threefry_plain.calls


# ---- the wrapper, with the launch emulated ----------------------------------


def _lanes_of(t, stride, lanes, offset=0):
    return torch.as_strided(t, (lanes,), (stride,),
                            t.storage_offset() + offset)


def _emulate(out, call):
    """The kernel's reads and writes for ``call``, hashed by the plain
    code: the keys and words read through their strides, the outputs
    written (lanes, n) or (n, lanes)."""
    lanes, n = call.lanes, call.n

    def word(w):
        if w.tensor is None:
            return torch.full((lanes,), w.value, dtype=torch.int64)
        return _lanes_of(w.tensor, w.stride, lanes) & MASK

    k0 = _lanes_of(call.key, call.key_stride, lanes) & MASK
    k1 = _lanes_of(call.key, call.key_stride, lanes, call.word_stride) & MASK
    zero = torch.zeros((lanes,), dtype=torch.int64)
    for w in call.folds:
        k0, k1 = kt.threefry_plain(k0, k1, zero, word(w))
    x1 = (torch.arange(n, dtype=torch.int64)[None, :] if call.last is None
          else word(call.last)[:, None])
    y0, y1 = kt.threefry_plain(k0[:, None], k1[:, None],
                               torch.zeros_like(x1), x1)
    y0, y1 = torch.broadcast_tensors(y0, y1)
    if call.kind in (kt.UNIFORM, kt.ONE_MINUS_UNIFORM):
        v = ((y0 ^ y1) >> 9 | 0x3F800000).to(torch.int32).view(
            torch.float32) - 1.0
        if call.kind == kt.ONE_MINUS_UNIFORM:
            v = 1.0 - v
    elif call.kind == kt.PAIR:
        v = torch.stack([y0, y1], dim=-1)
    else:
        v = y0 ^ y1
    if call.by_counter:
        v = v.transpose(0, 1)
    out.view(-1).copy_(v.reshape(-1))


@pytest.fixture
def launches(monkeypatch):
    """Route the public calls of CPU keys through the wrapper, its launch
    emulated; -> the list of the launches' calls."""
    calls = []

    def launch(out, call):
        calls.append(call)
        _emulate(out, call)

    monkeypatch.setattr(kt, "_launch", launch)
    monkeypatch.setattr(rng, "_on_card", lambda keys: True)
    return calls


KEY_CASES = {
    # keys: (R, seed, top bits)
    "R1": (1, 3, False),
    "R1000": (1000, 4, False),
    "R257_top_bit": (257, 5, True),
}


@pytest.mark.parametrize("case", list(KEY_CASES))
@pytest.mark.parametrize("name", list(CALLS))
def test_wrapper_emulated_equals_plain(name, case, launches):
    """Each public call through the wrapper, one launch each but randint's
    three (its split and its two draws), the launch emulated: the plain
    code's bits and shape."""
    fn, _, n_launches = CALLS[name]
    R, seed, top = KEY_CASES[case]
    keys = _keys(R, seed, top=top)
    want = _plain(fn, keys)
    before = kt.threefry.launches
    got = fn(keys)
    assert kt.threefry.launches - before == n_launches == len(launches)
    assert_same_bits(got, want)


def test_uniform_sites_rows_are_contiguous(launches):
    """uniform_sites writes (n, R) row by row, so the glue's rows are
    stride 1."""
    us = rng.uniform_sites(_keys(100, 6), rng.SiteGroups.PT_BOUNCE, 6,
                           bounce=1)
    assert us.shape == (6, 100) and us.is_contiguous()
    assert launches[0].by_counter and launches[0].per == 6


def _table(R, seed):
    """A gathered table of int64 words: its columns are (R,) views of
    stride 5."""
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 2**32, (R, 5), generator=g, dtype=torch.int64)


OPERAND_CASES = {
    # case: () -> (keys, words, last); the key stride read, each word's
    # (stride or None by value) and, for the last word, the same
    "pixel_keys": (lambda: (_keys(1, 7)[0].expand(512, 2), (),
                            torch.arange(512)), 0, [], 1),
    "sample_key_int": (lambda: (_keys(1, 8)[0], (), 2**31 + 7), 0, [],
                       None),
    "key_broadcast_to_data": (lambda: (_keys(1, 14)[0], (),
                                       torch.arange(64) + 2**32), 0, [], 1),
    "data_0d_tensor": (lambda: (_keys(64, 9), (), torch.tensor(5)), 2, [],
                       0),
    "data_column": (lambda: (_keys(64, 10), (), _table(64, 1)[:, 3]), 2, [],
                    5),
    "keys_column_pairs": (lambda: (_table(64, 2)[:, 1:3], (), 11), 5, [],
                          None),
    "two_folds": (lambda: (_keys(64, 11), (20, 3), None), 2, [None, None],
                  None),
    "fold_tensor": (lambda: (_keys(64, 12), (torch.arange(64),), None), 2,
                    [1], None),
    "split_row": (lambda: (_keys(2, 13)[1], (), None), 0, [], None),
}


@pytest.mark.parametrize("case", list(OPERAND_CASES))
def test_wrapper_resolves_operands_without_a_copy(case, launches):
    """The wrapper's operands, the launch emulated: the stride-0 key that
    pixel_keys expands, keys and words of a gathered table (stride 5), a
    0-d word (stride 0), Python ints by value: all read in place, the
    tensors handed to the launch those given (no copy), and the result
    the plain code's."""
    make, key_stride, fold_strides, last_stride = OPERAND_CASES[case]
    keys, folds, last = make()
    n = 3 if last is None else 1
    want = _plain_call(keys, folds, last, n)
    got = kt.threefry(keys, folds, last, n=n)
    call, = launches
    assert call.key_stride == key_stride
    assert call.key.data_ptr() == keys.data_ptr()
    assert call.word_stride == keys.stride(-1)
    for w, x, stride in zip(call.folds, folds, fold_strides):
        assert w.stride == (stride or 0)
        if stride is None:
            assert w.tensor is None and w.value == x & MASK
        else:
            assert w.tensor.data_ptr() == x.data_ptr()
    if last_stride is None:
        assert call.last is None or call.last.tensor is None
    else:
        assert call.last.stride == last_stride
        assert call.last.tensor.data_ptr() == last.data_ptr()
    assert_same_bits(got, want)


def _plain_call(keys, folds, last, n):
    """The plain code's key pairs of ``kt.threefry(keys, folds, last, n)``."""
    k = keys
    for w in folds:
        k = _plain(rng.fold_in, k, w)
    if last is not None:
        return _plain(rng.fold_in, k, last)
    i = torch.arange(n, dtype=torch.int64)
    y0, y1 = kt.threefry_plain(k[..., 0:1], k[..., 1:2], torch.zeros_like(i),
                               i)
    return torch.stack([y0, y1], dim=-1)


def test_wrapper_takes_a_cpu_scalar_by_value_for_card_keys(monkeypatch):
    """A one-element CPU word beside keys elsewhere comes by value."""
    calls = []
    monkeypatch.setattr(kt, "_launch", lambda out, call: calls.append(call))
    kt.threefry(_keys(8, 1).to("meta"), (torch.tensor([2**32 + 9]),),
                n=2, kind=kt.UNIFORM)
    call, = calls
    assert call.folds[0].tensor is None and call.folds[0].value == 9


def test_wrapper_imports_no_sympy():
    """A broadcast word costs no import: torch.broadcast_shapes imports
    sympy at its first call, seconds of a process's set-up on the card."""
    code = ("import sys, torch\n"
            "from cudapathtracer_tpu_torch.ops import rng\n"
            "from cudapathtracer_tpu_torch.ops.kernels import threefry as kt\n"
            "kt._launch = lambda out, call: None\n"
            "kt.threefry(torch.zeros(2, dtype=torch.int64),\n"
            "            (torch.arange(4)[:, None],), last=torch.arange(3))\n"
            "assert 'sympy' not in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_wrapper_refuses_other_dtypes_and_devices():
    keys = _keys(8, 2)
    for bad in (keys.to(torch.int32), keys.double(), keys[:, :1]):
        with pytest.raises(ValueError, match="int64 keys"):
            kt.threefry(bad, n=2)
    with pytest.raises(ValueError, match="operand on"):
        kt.threefry(keys, last=torch.arange(8, device="meta"))
    with pytest.raises(ValueError, match="operand on"):
        kt.threefry(keys.to("meta"), last=torch.arange(8))
    with pytest.raises(ValueError, match="integer"):
        kt.threefry(keys, last=torch.ones(8))
    with pytest.raises(ValueError, match="fold words"):
        kt.threefry(keys, (1, 2, 3))


# ---- on the card -----------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


CARD_KEYS = {
    # keys: (R, seed, top bits); 1000 and 65,537 are not multiples of the
    # kernel's 256-thread blocks
    "R1": (1, 21, False),
    "R1000_top_bit": (1000, 22, True),
    "R65537": (65537, 23, False),
    "R1048576": (1048576, 24, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_KEYS))
@pytest.mark.parametrize("name", list(CALLS))
def test_cuda_kernel_equals_plain(name, case, dev):
    fn, _, n_launches = CALLS[name]
    R, seed, top = CARD_KEYS[case]
    keys = _keys(R, seed, dev, top=top)
    want = _plain(fn, keys)
    before = kernel_counts()
    got = fn(keys)
    torch.cuda.synchronize()
    after = kernel_counts()
    assert after["threefry_launches"] - before["threefry_launches"] \
        == n_launches
    assert after["threefry_plain_calls"] == before["threefry_plain_calls"]
    assert_same_bits(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("group,bounce", [(g, b) for g in (1, 2)
                                          for b in (0, 1, 2)])
def test_cuda_uniform_sites_groups_and_bounces(group, bounce, dev):
    keys = _keys(262_144, 31 + bounce, dev)
    n = 6 if group == rng.SiteGroups.PT_BOUNCE else 7
    got = rng.uniform_sites(keys, group, n, bounce=bounce)
    assert got.is_contiguous() and got.shape == (n, 262_144)
    assert_same_bits(got, _plain(rng.uniform_sites, keys, group, n,
                                 bounce=bounce))


# randint's spans in the shape cell: the pixels of 256^2, the edges of its
# mesh, its light triangles; and the int32 limit
@pytest.mark.cuda
@pytest.mark.parametrize("span", [65_536, 30_786, 2, 2**31 - 1])
def test_cuda_split_and_randint_at_the_shape_cells_spans(span, dev):
    key = rng.fold_in(rng.prng_key(2**32 - 1, dev), 0x5AD0)
    for k in rng.split(key, 4):
        assert_same_bits(rng.randint(k, 65_536, 0, span),
                         _plain(rng.randint, k, 65_536, 0, span))
        assert_same_bits(rng.uniform_1(k, 65_536),
                         _plain(rng.uniform_1, k, 65_536))
    assert_same_bits(rng.split(key, 4), _plain(rng.split, key, 4))


@pytest.mark.cuda
def test_cuda_fold_in_words_near_the_top(dev):
    """fold_in of words with the top bit set, near 2^32 - 1, negative
    (their low 32 bits) and past 2^32, as ints and as tensors."""
    keys = _keys(1000, 41, dev, top=True)
    for word in (2**31, 2**32 - 1, -1, 2**32 + 5, 2**40 + 2**31):
        assert_same_bits(rng.fold_in(keys, word),
                         _plain(rng.fold_in, keys, word))
    data = torch.tensor([2**32 - 1, -1, 2**31, 0, 2**33 + 1] * 200,
                        device=dev)
    assert_same_bits(rng.fold_in(keys, data), _plain(rng.fold_in, keys,
                                                     data))


SAMPLE_INTEGRATORS = ("pt_nee", "bdpt")


@pytest.mark.cuda
@pytest.mark.parametrize("integrator", SAMPLE_INTEGRATORS)
def test_cuda_sample_through_kernel_equals_plain(integrator, dev,
                                                 monkeypatch):
    """One 64^2 sample with the RNG's kernel, counted, then with the plain
    code serving the same CUDA keys: the same image, bit for bit; one
    launch for every call the kernel served, no plain hash."""
    from cudapathtracer_tpu_torch.render import renderer
    from test_torch_fma import _sample_setup

    scene, cam, cfg, bvh = _sample_setup(integrator, dev)
    prep = renderer.make_packet_prep(scene, bvh, cfg.intersector)
    key = rng.prng_key(5, dev)
    served = []
    on_card = rng._on_card

    def counted(keys):
        served.append(keys.shape)
        return on_card(keys)

    monkeypatch.setattr(rng, "_on_card", counted)
    before = kernel_counts()
    got = renderer.render_batch(scene, bvh, cam, cfg, key,
                                renderer.init_accum(cfg, device=dev), 1,
                                prep=prep)
    torch.cuda.synchronize()
    after = kernel_counts()
    assert len(served) >= 5
    assert after["threefry_launches"] - before["threefry_launches"] \
        == len(served)
    assert after["threefry_plain_calls"] == before["threefry_plain_calls"]
    monkeypatch.setattr(rng, "_on_card", lambda keys: False)
    want = renderer.render_batch(scene, bvh, cam, cfg, key,
                                 renderer.init_accum(cfg, device=dev), 1,
                                 prep=prep)
    for x, y in zip((*got.img, *got.comp), (*want.img, *want.comp)):
        assert_same_bits(x, y)
