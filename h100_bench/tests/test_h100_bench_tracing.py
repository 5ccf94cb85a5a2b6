"""The readers of the program's own spans and counters
(``metrics/glue_ms_per_sample.render.py``,
``sort_cull_ms_per_sample.render.py``, ``live_rays_pct.render.py``,
``recompute_ms.train.py``) on records made up here with known answers; on
a tree without the program's tracing module, and on a run without device
work, each reads nothing."""

from __future__ import annotations

import sys
from types import SimpleNamespace

import pytest

from cudapathtracer_tpu_torch.utils import tracing
from h100_bench import harness
from h100_bench.tests.tiny import BENCH

FACILITY = "cudapathtracer_tpu_torch.utils.tracing"
MS = 1_000_000   # ns


@pytest.fixture(autouse=True)
def tracing_off():
    yield
    tracing.enable(False)


def _recs(*rows):
    """Rows (name, id, parent, start ms, end ms, device ms, attrs): the
    records of one thread, each root's id worked out from its parents; a
    name ending in "+" is a count of n = attrs."""
    by_id, out = {}, []
    for name, i, parent, s, e, dev, attrs in rows:
        root = i if parent is None else by_id[parent].root
        count = name.endswith("+")
        r = tracing.Record("count" if count else "span", name.rstrip("+"),
                           i, parent, root, 1, int(s * MS), int(e * MS),
                           {} if count else attrs, attrs if count else None,
                           dev)
        by_id[i] = r
        out.append(r)
    return out


RENDER = _recs(
    # pass 1, one sample: radiance 10 ms with traces 2 + 3 ms under it;
    # the primary trace under the root itself is not glue
    ("render.batch", 1, None, 0, 20, 20.0, {"samples": 1}),
    ("packets.trace", 2, 1, 0, 4, 4.0, {"rays": 100}),
    ("integrator.radiance", 3, 1, 4, 14, 10.0, {}),
    ("packets.trace", 4, 3, 5, 7, 2.0, {"rays": 100}),
    ("packets.sort", 5, 4, 5, 6, 1.0, {}),
    ("packets.cull", 6, 4, 6, 7, 2.0, {}),
    ("packets.live_rays+", 7, 4, 7, 7, None, 50),
    ("packets.trace", 8, 3, 8, 11, 3.0, {"rays": 100,
                                         "packets.live_rays": 100}),
    # pass 2, two samples: radiance 30, a trace of 10; sort 2, cull 4
    ("render.batch", 9, None, 30, 70, 40.0, {"samples": 2}),
    ("integrator.radiance", 10, 9, 30, 60, 30.0, {}),
    ("packets.trace", 11, 10, 40, 50, 10.0, {"rays": 50}),
    ("packets.sort", 12, 11, 40, 42, 2.0, {}),
    ("packets.cull", 13, 11, 42, 46, 4.0, {}),
    # pass 3, one sample, no events: the host interval stands in (7 ms)
    ("render.batch", 14, None, 80, 90, None, {"samples": 1}),
    ("integrator.radiance", 15, 14, 80, 87, None, {}),
    ("packets.cull", 16, 14, 87, 87.5, None, {}),
)
# the live count of trace 4 as its attribute, as the program adds it
RENDER[3] = RENDER[3]._replace(attrs={"rays": 100, "packets.live_rays": 50})

TRAIN = _recs(
    ("diff.forward", 1, None, 0, 10, 10.0, {}),
    ("diff.recompute", 2, None, 50, 52, 2.0, {"sample": 0}),
    ("diff.recompute", 3, None, 60, 63, 3.0, {"sample": 1}),
    ("diff.forward", 4, None, 100, 110, 10.0, {}),
    ("diff.forward", 5, None, 200, 210, 10.0, {}),
    ("diff.recompute", 6, None, 250, 254, 4.0, {"sample": 0}),
)

CASES = {
    # medians of 5, 10, 7 and of 3, 3, 0.5
    "glue_ms_per_sample.render": (RENDER, 7.0),
    "sort_cull_ms_per_sample.render": (RENDER, 3.0),
    # 150 live of 200 counted lanes; trace 11 counted none
    "live_rays_pct.render": (RENDER, 75.0),
    # steps of 5 and 4 ms; the second forward has none
    "recompute_ms.train": (TRAIN, 4.5),
}


def _readings(events=10):
    return SimpleNamespace(trace=SimpleNamespace(device_events=events))


@pytest.mark.parametrize("name", sorted(CASES))
def test_reader_known_answer(name, monkeypatch):
    recs, want = CASES[name]
    reader = harness.load_reader(BENCH, name)
    assert tracing.enabled()
    monkeypatch.setattr(tracing, "records", lambda: list(recs))
    assert reader.read(_readings()) == pytest.approx(want, rel=1e-12)
    assert reader.read(_readings(events=0)) is None
    monkeypatch.setattr(tracing, "records", lambda: [])
    assert reader.read(_readings()) is None


@pytest.mark.parametrize("name", sorted(CASES))
def test_reader_without_the_facility_reads_nothing(name, monkeypatch):
    monkeypatch.setitem(sys.modules, FACILITY, None)
    reader = harness.load_reader(BENCH, name)
    assert not tracing.enabled()
    assert reader.read(_readings()) is None
