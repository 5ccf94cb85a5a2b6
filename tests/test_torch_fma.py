"""The glue's fused multiply-add as one CUDA kernel (ops/kernels/fma.py).

``vecmath.fma`` takes the ``__fmaf_rn`` kernel for float32 tensors on a
card and its plain version, the float64 emulation, on the CPU. The CPU
tests hold the dispatch and the wrapper's operand resolution (with the
launch stubbed); the tests marked ``cuda`` hold the kernel to the emulation
on the card, bit for bit (NaN for NaN), and skip where torch finds no card.
The file imports no jax: ``python -m pytest -o addopts="" --noconftest -m
cuda tests/test_torch_fma.py``."""

import pytest
import torch

import cudapathtracer_tpu_torch as T
from cudapathtracer_tpu_torch.models import procedural as tproc
from cudapathtracer_tpu_torch.ops import vecmath
from cudapathtracer_tpu_torch.ops.kernels import fma as kfma
from cudapathtracer_tpu_torch.ops.kernels import kernel_counts
from cudapathtracer_tpu_torch.ops.rng import prng_key
from cudapathtracer_tpu_torch.render import renderer
from test_torch_vecmath_grad import emulated_fma

N = 4096


def _triples(n, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    a, b = (torch.randn(n, generator=g) * 3.0 for _ in range(2))
    # c near -a*b, so that the result lives in the product's low bits
    c = -(a * b) * (1 + torch.randn(n, generator=g) * 1e-6)
    return a.to(device), b.to(device), c.to(device)


def test_cpu_fma_is_the_emulation_and_launches_nothing():
    a, b, c = _triples(N, 0)
    counts = kernel_counts()
    assert torch.equal(vecmath.fma(a, b, c), emulated_fma(a, b, c))
    want = emulated_fma(a, torch.tensor(0.1), c)
    assert torch.equal(vecmath.fma(a, 0.1, c), want)
    after = kernel_counts()
    assert after["fma_plain_calls"] == counts["fma_plain_calls"] + 2
    assert after["fma_launches"] == counts["fma_launches"]


def _stub_launch(calls):
    """A launch that records its operands and computes their elements with
    the plain version, reading each operand as the kernel would."""

    def launch(out, ops):
        calls.append(ops)
        n = out.numel()
        cols = [torch.full((n,), v) if t is None
                else torch.as_strided(t, (n,), (s,)) for t, s, v in ops]
        out.view(-1).copy_(kfma.fma_plain(*cols))

    return launch


def _table(seed, device):
    """A gathered table: its columns are (N,) views of stride 9."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn((N, 9), generator=g).to(device)


OPERAND_CASES = {
    # case: (a, b, c, device) -> operands; the strides the kernel reads
    # them with, an operand expanded
    "full": (lambda a, b, c, d: (a, b, c), (1, 1, 1), False),
    "one_element": (lambda a, b, c, d: (a, b[:1], c), (1, 0, 1), False),
    "number": (lambda a, b, c, d: (a, 0.1, c), (1, 0, 1), False),
    "strided": (lambda a, b, c, d: (_table(1, d)[:, 4], b,
                                    _table(2, d)[:, 0]),
                (9, 1, 9), False),
    "misaligned": (lambda a, b, c, d: (a[1:], b[1:], c[:-1]), (1, 1, 1),
                   False),
    # (64, 64) by (64,) by one element: b is expanded, a and c are not
    "broadcast": (lambda a, b, c, d: (a.view(64, 64), b[:64], c[:1]),
                  (1, 1, 0), True),
}


@pytest.mark.parametrize("case", list(OPERAND_CASES))
def test_wrapper_resolves_operands_without_a_copy(case, monkeypatch):
    """The wrapper's operands, launch stubbed: a full tensor (stride 1), a
    one-element tensor (stride 0), a Python number (by value, as float32),
    a gathered column (stride 9) and a misaligned view are read in place;
    only a broadcast is expanded first, and only it counts in
    ``expanded``."""
    make, strides, expanded = OPERAND_CASES[case]
    a, b, c = make(*_triples(N, 3), "cpu")
    calls = []
    monkeypatch.setattr(kfma, "_launch", _stub_launch(calls))
    launches, copies = kfma.fma.launches, kfma.fma.expanded
    got = kfma.fma(a, b, c)
    assert kfma.fma.launches == launches + 1
    assert kfma.fma.expanded == copies + expanded
    ops, = calls
    assert [s for _, s, _ in ops] == list(strides)
    for x, (t, _, value) in zip((a, b, c), ops):
        if torch.is_tensor(x):
            # read in place, but for the broadcast's b
            assert (t is x) == (not (expanded and x is b))
        else:
            assert t is None and value == x
    want = emulated_fma(a, torch.tensor(b), c) if case == "number" else \
        emulated_fma(a, b, c)
    assert got.shape == want.shape and torch.equal(got, want)


def test_wrapper_refuses_other_dtypes_and_devices():
    a, b, c = _triples(8, 4)
    with pytest.raises(ValueError, match="float32"):
        kfma.fma(a, b.double(), c)
    with pytest.raises(ValueError, match="operand on"):
        kfma.fma(a, b, c.to("meta"))


@pytest.mark.parametrize("x,want", [
    (torch.zeros(5), 1),
    (torch.zeros(1), 0),
    (torch.zeros(10)[::3], 3),
    (torch.zeros(5, 9)[:, 2], 9),
    (torch.zeros(3, 1, 4), 1),
    (torch.zeros(()), 0),
    (torch.zeros(4, 5).t(), None),
    (torch.zeros(4, 6)[:, :3], None),
])
def test_flat_stride(x, want):
    assert kfma.flat_stride(x) == want


# ---- on the card -----------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def assert_same_bits(got, want):
    """Bit for bit, NaN for NaN (a NaN's payload is the device's)."""
    assert got.shape == want.shape and got.dtype == want.dtype
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32),
                       want[~nan].view(torch.int32))


def _random_bits(n, seed, device):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-2**31, 2**31, (n,), generator=g,
                         dtype=torch.int64).to(torch.int32).view(
                             torch.float32).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bits", "near_cancel"])
def test_cuda_kernel_matches_emulation_on_random_triples(kind, dev):
    """2^22 triples: random bit patterns (every exponent, subnormals, inf
    and NaN) and triples whose result lives in the product's low bits, as
    contiguous tensors and as misaligned views."""
    n = 2 ** 22
    if kind == "bits":
        a, b, c = (_random_bits(n + 1, s, dev) for s in (1, 2, 3))
    else:
        a, b, c = _triples(n + 1, 5, dev)
    launches = kfma.fma.launches
    assert_same_bits(kfma.fma(a[:n], b[:n], c[:n]),
                     kfma.fma_plain(a[:n], b[:n], c[:n]))
    assert_same_bits(kfma.fma(a[1:], b[1:], c[:-1]),
                     kfma.fma_plain(a[1:], b[1:], c[:-1]))
    torch.cuda.synchronize()
    assert kfma.fma.launches == launches + 2


F32_MAX = 3.4028234663852886e38
TINY = 2.0 ** -75
HARD_CASES = [
    # signed zeros
    (0.0, 1.0, 0.0), (-0.0, 1.0, 0.0), (-0.0, 1.0, -0.0), (0.0, -1.0, -0.0),
    (1.0, 1.0, -1.0), (-1.0, 1.0, 1.0), (1e-30, -1e-30, 0.0),
    # subnormal results: 2^-150 ties to 0, 1.5 * 2^-150 rounds up
    (TINY, TINY, 0.0), (1.5 * TINY, TINY, 0.0), (-1.5 * TINY, TINY, 0.0),
    (2.0 ** -70, 2.0 ** -70, 2.0 ** -140), (3 * 2.0 ** -80, 2.0 ** -60,
                                            -(2.0 ** -149)),
    (2.0 ** -63, 2.0 ** -63, -(2.0 ** -126)),
    # halfway ties from an exact product, broken by c in the last place
    (1 + 2.0 ** -12, 1 + 2.0 ** -12, 0.0),
    (1 + 2.0 ** -12, 1 + 2.0 ** -12, 2.0 ** -60),
    (1 + 2.0 ** -12, 1 + 2.0 ** -12, -(2.0 ** -60)),
    (1 + 2.0 ** -23, 1 + 2.0 ** -23, -1.0),
    (1 + 3 * 2.0 ** -12, 1 + 2.0 ** -12, 0.0),
    (-(1 + 2.0 ** -12), 1 + 2.0 ** -12, 2.0 ** -70),
    # overflow, and none where the sum comes back in range
    (F32_MAX, 2.0, 0.0), (F32_MAX, -2.0, 0.0), (F32_MAX, 2.0, -F32_MAX),
    (F32_MAX, 1.0, F32_MAX * 2.0 ** -24), (F32_MAX, 1.0, F32_MAX * 2.0 ** -25),
    # infinities and NaN
    (float("inf"), 0.0, 1.0), (float("inf"), 1.0, float("-inf")),
    (float("inf"), 2.0, 1.0), (0.0, float("-inf"), 0.0),
    (float("nan"), 1.0, 1.0), (1.0, float("nan"), 1.0),
    (1.0, 1.0, float("nan")), (0.0, 0.0, float("nan")),
]


@pytest.mark.cuda
def test_cuda_kernel_matches_emulation_on_hard_cases(dev):
    a, b, c = (torch.tensor(col, dtype=torch.float32, device=dev)
               for col in zip(*HARD_CASES))
    got = kfma.fma(a, b, c)
    assert_same_bits(got, kfma.fma_plain(a, b, c))
    assert_same_bits(got.cpu(), kfma.fma_plain(a.cpu(), b.cpu(), c.cpu()))
    # one element at a time, b by value
    for i, (x, y, z) in enumerate(HARD_CASES):
        one = kfma.fma(a[i:i + 1], y, c[i:i + 1])
        assert_same_bits(one, got[i:i + 1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(OPERAND_CASES) + ["cpu_scalar"])
def test_cuda_operand_forms_match_emulation(case, dev):
    """Each operand form of the wrapper on the card (strided columns, one
    element, a number or a CPU scalar by value, a broadcast) against the
    emulation on the same operands."""
    if case == "cpu_scalar":
        a, b, c = _triples(N, 6, dev)
        b = torch.tensor(0.3)
        expanded = False
    else:
        make, _, expanded = OPERAND_CASES[case]
        a, b, c = make(*_triples(N, 6, dev), dev)
    copies = kfma.fma.expanded
    got = kfma.fma(a, b, c)
    assert kfma.fma.expanded == copies + expanded
    assert_same_bits(got, kfma.fma_plain(a, b, c))


@pytest.mark.cuda
@pytest.mark.parametrize("b_shape", [(N,), (1,), ()],
                         ids=["full", "broadcast1", "scalar"])
def test_cuda_fma_function_gradients(b_shape, dev):
    """Through ``_FMA`` with the kernel in its forward: the emulation's
    values bit for bit, and the product rule's gradients (g*b, g*a, g; a
    broadcast operand's sum formed in float64 and rounded once), as autograd
    through the emulation gives them on the CPU
    (``test_torch_vecmath_grad.py``)."""
    g = torch.Generator().manual_seed(7)
    a = (torch.randn(N, generator=g) * 3.0).to(dev)
    b = torch.randn(b_shape, generator=g).to(dev)
    c = torch.randn(N, generator=g).to(dev)
    cot = torch.randn(N, generator=g).to(dev)
    leaves = [t.clone().requires_grad_() for t in (a, b, c)]
    launches = kfma.fma.launches
    got = vecmath.fma(*leaves)
    assert kfma.fma.launches == launches + 1
    assert type(got.grad_fn).__name__ == "_FMABackward"
    assert_same_bits(got.detach(), kfma.fma_plain(a, b, c))
    ga, gb, gc = torch.autograd.grad(got, leaves, cot)
    assert_same_bits(ga, cot * b)
    want_gb = (cot.double() * a.double()).sum_to_size(b.shape).float() \
        if b.shape != a.shape else cot * a
    assert_same_bits(gb, want_gb)
    assert_same_bits(gc, cot)


SAMPLE_CASES = {
    "pt_nee": (lambda: tproc.colonnade(subdiv=1), (0.0, 2.0, 3.4), 2.0),
    "bdpt": (lambda: tproc.cornell_with_sphere_mesh(subdiv=2),
             (0.0, 1.0, 3.0), 3.0),
}


def _sample_setup(integrator, dev):
    desc, pos, focal = SAMPLE_CASES[integrator]
    scene = tproc.to_scene(desc(), dev)
    cam = T.make_camera(pos=pos, focal_length=focal, width=64, height=64,
                        device=dev)
    cfg = T.RenderConfig(width=64, height=64, spp=1, integrator=integrator,
                         num_bounces=3)
    bvh = renderer.build_bvh_for_scene(scene, cfg.leaf_size,
                                       cluster_size=cfg.cluster_size)
    return scene, cam, cfg, bvh


@pytest.mark.cuda
@pytest.mark.parametrize("integrator", list(SAMPLE_CASES))
def test_cuda_sample_through_kernel_equals_emulation(integrator, dev,
                                                     monkeypatch):
    """One 64^2 sample rendered through the kernel and once more with the
    emulation serving the same CUDA tensors: the same image, bit for
    bit."""
    scene, cam, cfg, bvh = _sample_setup(integrator, dev)
    got = T.render(scene, cam, cfg, seed=99, bvh=bvh)
    monkeypatch.setattr(kfma, "fma", kfma.fma_plain)
    want = T.render(scene, cam, cfg, seed=99, bvh=bvh)
    for x, y in zip((*got.img, *got.comp), (*want.img, *want.comp)):
        assert_same_bits(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("integrator", list(SAMPLE_CASES))
def test_cuda_sample_launches_one_kernel_per_fma(integrator, dev,
                                                 monkeypatch):
    """``kernel_counts()`` over one sample: a launch for every float32 FMA
    the glue calls, none expanded, no emulated call."""
    scene, cam, cfg, bvh = _sample_setup(integrator, dev)
    prep = renderer.make_packet_prep(scene, bvh, cfg.intersector)
    state = renderer.init_accum(cfg, device=dev)
    key = prng_key(5, dev)
    calls = []
    rounded = vecmath._fma_rounded

    def counted(a, b, c):
        calls.append(a.dtype)
        return rounded(a, b, c)

    monkeypatch.setattr(vecmath, "_fma_rounded", counted)
    before = kernel_counts()
    renderer.render_batch(scene, bvh, cam, cfg, key, state, 1, prep=prep)
    torch.cuda.synchronize()
    after = kernel_counts()
    assert len(calls) > 100 and set(calls) == {torch.float32}
    assert after["fma_launches"] - before["fma_launches"] == len(calls)
    assert after["fma_expanded"] == before["fma_expanded"]
    assert after["fma_plain_calls"] == before["fma_plain_calls"]
