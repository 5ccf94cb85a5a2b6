"""What the port's card tests share: the ``dev`` fixture, which skips where
torch finds no NVIDIA GPU, the launch check ``launched`` and the golden
tests' image rule ``image_rule``. It imports no jax, nor do the card test
files, so they run on a machine without the JAX package, and without
tests/conftest.py, which imports it:

    python -m pytest -o addopts="" --noconftest -m cuda \\
        tests/test_torch_card.py tests/test_torch_*_cuda.py \\
        tests/test_torch_dense_*.py tests/test_torch_fma.py \\
        tests/test_torch_threefry.py
"""

import numpy as np
import pytest
import torch

from cudapathtracer_tpu_torch.ops.kernels import kernel_counts

FOLDS = ("k1", "k2", "k3")


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; torch finds none")
    return torch.device("cuda")


def launched(before, kernel):
    """The launches since ``before`` (a ``kernel_counts()``); raises unless
    ``kernel`` (k1, k2 or k3) and the glue's FMA and threefry launched, no
    other fold kernel did and no plain version ran."""
    now = kernel_counts()
    diff = {k: now[k] - before[k] for k in now}
    others = [f for f in FOLDS if f != kernel and diff[f"{f}_launches"]]
    plain = {k: v for k, v in diff.items() if "plain" in k and v}
    assert diff[f"{kernel}_launches"] > 0 and diff["fma_launches"] > 0 \
        and diff["threefry_launches"] > 0 and not others and not plain, diff
    return diff


def image_rule(got, want):
    """tests/test_goldens.py:_check's rule between two (H, W, 3) u8
    images: under 0.5% of channels differ by more than 2."""
    assert got.shape == want.shape
    frac = float((np.abs(got.astype(np.int32) - want.astype(np.int32))
                  > 2).mean())
    assert frac < 0.005, f"{frac:.2%} of channels differ by more than 2"
