"""The closest-hit key of the gated fold (csrc/gated_fold.cuh:fold_key),
through its torch twin (ops/kernels/dense_resident.py:fold_key).

K2 and K3 fold a member's tests in any order, each an atomicMin on the
ray's key. That is exact only if the minimum key over the init (cap, -1)
and the tests' (ts, id) is what K1's sequential fold
``ts < t or (ts == t and id < best)`` keeps from (cap, -1). The cases below
hold the two equal, bit for bit, over random sequences: exact-t ties,
MAX_FLOAT rejects, a cap equal to a hit's t, masked lanes (init -3e38) and
a negative cap. The sequences are made from a seed with numpy; nothing
here needs a card."""

import numpy as np
import pytest
import torch

from cudapathtracer_tpu_torch.ops.kernels.dense_resident import (
    MASKED_T_INIT,
    fold_key,
    unpack_key,
)
from cudapathtracer_tpu_torch.utils.constants import MAX_FLOAT

N_SEQ = 64
LEN = 48


def _sequences(case, rng):
    """(cap (N,), ts (N, LEN), ids (N, LEN)) float32 / int32 for one case."""
    ids = rng.integers(0, 5000, (N_SEQ, LEN)).astype(np.int32)
    if case == "ties":          # few distinct t: many exact ties
        ts = rng.choice(np.float32([0.5, 1.25, 2.0]), (N_SEQ, LEN))
        cap = np.full(N_SEQ, 3.0, np.float32)
    elif case == "rejects":     # mostly misses, no cap below MAX_FLOAT
        ts = np.where(rng.random((N_SEQ, LEN)) < 0.9, MAX_FLOAT,
                      rng.uniform(0.1, 50.0, (N_SEQ, LEN)))
        cap = np.full(N_SEQ, MAX_FLOAT, np.float32)
    elif case == "cap_is_hit":  # the cap equals one of the hits' t
        ts = rng.uniform(0.1, 10.0, (N_SEQ, LEN)).astype(np.float32)
        cap = ts[np.arange(N_SEQ), rng.integers(0, LEN, N_SEQ)]
    elif case == "masked":      # masked lanes: nothing beats the init
        ts = np.where(rng.random((N_SEQ, LEN)) < 0.5, MAX_FLOAT,
                      rng.uniform(0.1, 10.0, (N_SEQ, LEN)))
        cap = np.full(N_SEQ, MASKED_T_INIT, np.float32)
    elif case == "negative_cap":
        ts = rng.uniform(0.1, 10.0, (N_SEQ, LEN)).astype(np.float32)
        cap = -rng.uniform(0.0, 5.0, N_SEQ).astype(np.float32)
    else:                       # random hits, rejects and caps
        ts = np.where(rng.random((N_SEQ, LEN)) < 0.3, MAX_FLOAT,
                      rng.uniform(0.1, 20.0, (N_SEQ, LEN)))
        cap = rng.uniform(1.0, 30.0, N_SEQ).astype(np.float32)
    return cap.astype(np.float32), ts.astype(np.float32), ids


def _sequential(cap, ts, ids):
    """K1's bw_fold update from (cap, -1), one sequence at a time."""
    out_t = np.empty_like(cap)
    out_id = np.empty(cap.shape, np.int32)
    for i in range(cap.shape[0]):
        t, best = cap[i], np.int32(-1)
        for s, j in zip(ts[i], ids[i]):
            if s < t or (s == t and j < best):
                t, best = s, j
        out_t[i], out_id[i] = t, best
    return out_t, out_id


@pytest.mark.parametrize("case", ["ties", "rejects", "cap_is_hit", "masked",
                                  "negative_cap", "random"])
def test_min_key_is_sequential_fold(case):
    rng = np.random.default_rng(["ties", "rejects", "cap_is_hit", "masked",
                                 "negative_cap", "random"].index(case))
    cap, ts, ids = _sequences(case, rng)
    want_t, want_id = _sequential(cap, ts, ids)
    keys = torch.cat([
        fold_key(torch.from_numpy(cap)[:, None],
                 torch.full((N_SEQ, 1), -1, dtype=torch.int32)),
        fold_key(torch.from_numpy(ts), torch.from_numpy(ids))], dim=1)
    # any order of the atomics gives the same minimum
    perm = torch.from_numpy(rng.permutation(LEN + 1))
    got_t, got_id = unpack_key(keys[:, perm].amin(dim=1))
    np.testing.assert_array_equal(got_t.numpy().view(np.int32),
                                  want_t.view(np.int32))
    np.testing.assert_array_equal(got_id.numpy(), want_id)
    if case not in ("masked", "negative_cap"):
        assert (want_id >= 0).any()


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_key_orders_as_t_then_id(sign):
    """Over random pairs (no zeros: the key puts -0 below +0), the key's
    order is the lexicographic order of (t, id), and unpack_key inverts it
    bit for bit."""
    rng = np.random.default_rng(7)
    n = 4096
    t = (sign * rng.choice(np.float32([0.25, 1.0, 3.5, 1e-30, 1e38]), n)
         * rng.choice(np.float32([1.0, 1.0000001, 2.0]), n)).astype(np.float32)
    t[::5] = MAX_FLOAT
    ids = rng.integers(-1, 1 << 30, n).astype(np.int32)
    k = fold_key(torch.from_numpy(t), torch.from_numpy(ids)).numpy()
    i, j = rng.integers(0, n, (2, 20000))
    lex_less = (t[i] < t[j]) | ((t[i] == t[j]) & (ids[i] < ids[j]))
    np.testing.assert_array_equal(k[i] < k[j], lex_less)
    back_t, back_id = unpack_key(torch.from_numpy(k))
    np.testing.assert_array_equal(back_t.numpy().view(np.int32),
                                  t.view(np.int32))
    np.testing.assert_array_equal(back_id.numpy(), ids)
