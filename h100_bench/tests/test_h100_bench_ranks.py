"""A cell on several cards, rehearsed on the CPU: four ranks over gloo
(processes of their own), each rendering its Morton range and gathering
the image every pass; the same run with the exchange between ranks left
out, which the check must fail; and a rank that loads a forbidden module,
which fails the run."""

from __future__ import annotations

import pytest
import torch

from h100_bench import harness
from h100_bench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


def _no_exchange(mesh, x):
    """The gather with the exchange left out: each rank's own range, the
    others' pixels zero."""
    from cudapathtracer_tpu_torch.parallel.mesh import _map_pixels

    def local(t):
        out = torch.zeros((t.shape[0] * mesh.world,) + t.shape[1:],
                          dtype=t.dtype, device=t.device)
        out[mesh.rank * t.shape[0]:(mesh.rank + 1) * t.shape[0]] = t
        return out
    return _map_pixels(local, x)


def faulty_rank(*args):
    from cudapathtracer_tpu_torch.parallel import mesh

    mesh.gather_pixels = _no_exchange
    harness.rank_main(*args)


def jax_rank(*args):
    """A rank that finds a module of JAX loaded after its window."""
    import sys
    import types

    sys.modules["jax"] = types.ModuleType("jax")
    harness.rank_main(*args)


def _run(root, **kw):
    torch.set_num_threads(1)
    return harness.run("tiny_col.x4", 2 ** 31 + 5, 0.5, False, device="cpu",
                       **tiny.where(root), **kw)


def test_four_ranks_gather_the_image(root):
    line = _run(root)
    assert line["correct"] is True
    assert line["device"]["count"] == 4
    assert set(line["metrics"]) == {"mrays_per_s", "pass_ms_p95", "setup_s"}


def test_exchange_left_out_is_not_correct(root, monkeypatch):
    from cudapathtracer_tpu_torch.parallel import mesh

    monkeypatch.setattr(mesh, "gather_pixels", _no_exchange)
    assert _run(root, rank_target=faulty_rank)["correct"] is False


def test_a_forbidden_module_on_another_rank_fails_the_run(root):
    with pytest.raises(RuntimeError, match="ranks"):
        _run(root, rank_target=jax_rank)
