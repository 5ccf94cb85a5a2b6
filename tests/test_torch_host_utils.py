"""The port's host utilities held against the JAX package's on the CPU:
utils/png.py (byte for byte), utils/keeper.py (on synthetic images),
utils/profiling.py (the reference's Mrays/s accounting, the slow-lap
watchdog, the out.csv bytes, device_health and HealthWatchdog, as
tests/test_profiling.py checks them, and profile_trace), render's
``progress_cb`` and write_render's choice of format by extension."""

import time

import numpy as np
import pytest
import torch

from cudapathtracer_tpu.utils import keeper as jkeeper
from cudapathtracer_tpu.utils import png as jpng
from cudapathtracer_tpu.utils import profiling as jprof

import cudapathtracer_tpu_torch as T
from cudapathtracer_tpu_torch.models import procedural as tproc
from cudapathtracer_tpu_torch.utils import keeper as tkeeper
from cudapathtracer_tpu_torch.utils import png as tpng
from cudapathtracer_tpu_torch.utils import profiling as tprof
from cudapathtracer_tpu_torch.utils.ppm import read_ppm


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _image(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


@pytest.mark.parametrize("flip_x", [True, False])
@pytest.mark.parametrize("shape", [(16, 16), (5, 7), (64, 32)])
def test_write_png_matches_jax_byte_for_byte(shape, flip_x, tmp_path):
    img = _image(*shape, seed=shape[0] * 100 + shape[1])
    tpng.write_png(tmp_path / "t.png", img, flip_x=flip_x)
    jpng.write_png(tmp_path / "j.png", img, flip_x=flip_x)
    assert (tmp_path / "t.png").read_bytes() == \
        (tmp_path / "j.png").read_bytes()
    back = tpng.read_png(tmp_path / "t.png")
    np.testing.assert_array_equal(back, img[:, ::-1] if flip_x else img)
    np.testing.assert_array_equal(back, jpng.read_png(tmp_path / "j.png"))


def test_read_png_filters_match_jax(tmp_path):
    """Scanlines with the Sub and Up filters (JAX read_png's two), written
    by hand."""
    import struct
    import zlib

    img = _image(3, 4, seed=7).astype(np.int32)
    raw = b"\x00" + img[0].astype(np.uint8).tobytes()
    sub = img[1].copy()
    sub[1:] = (img[1][1:] - img[1][:-1]) % 256
    raw += b"\x01" + sub.astype(np.uint8).tobytes()
    raw += b"\x02" + ((img[2] - img[1]) % 256).astype(np.uint8).tobytes()
    p = tmp_path / "f.png"
    with open(p, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(tpng._chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 3, 8, 2, 0,
                                                 0, 0)))
        f.write(tpng._chunk(b"IDAT", zlib.compress(raw)))
        f.write(tpng._chunk(b"IEND", b""))
    np.testing.assert_array_equal(tpng.read_png(p), img.astype(np.uint8))
    np.testing.assert_array_equal(tpng.read_png(p), jpng.read_png(p))


@pytest.mark.parametrize("size", [64, 128])
def test_keeper_matches_jax(size):
    keeper, ours = _image(size, size, 1), _image(size, size, 2)
    np.testing.assert_array_equal(tkeeper.to_linear(keeper),
                                  jkeeper.to_linear(keeper))
    np.testing.assert_array_equal(tkeeper.block32(keeper),
                                  jkeeper.block32(keeper))
    b = tkeeper.block32(ours)
    tr, jr = tkeeper.regions(b), jkeeper.regions(b)
    assert list(tr) == list(jr)
    for k in tr:
        np.testing.assert_array_equal(tr[k], jr[k])
    assert tkeeper.region_ratios(keeper, ours) == \
        jkeeper.region_ratios(keeper, ours)


def test_mrays_accounting_matches_jax():
    # kernel.cu:757: rays = IMAGE_SIZE * NUM_SAMPLES * (NUM_BOUNCES+1)
    for args in ((512 * 512, 100, 3, 1.0), (64 * 64, 7, 2, 0.37)):
        assert tprof.mrays_per_sec(*args) == jprof.mrays_per_sec(*args)
    assert tprof.mrays_per_sec(512 * 512, 100, 3, 1.0) == \
        512 * 512 * 100 * 4 / 1e6


@pytest.mark.parametrize("device", [None, "cpu"])
def test_render_timer_watchdog_fires(device):
    warnings = []
    t = tprof.RenderTimer(slow_threshold_s=0.01, on_slow=warnings.append,
                          device=device).start()
    time.sleep(0.03)
    t.lap("slow sample")
    t.lap("fast sample")
    assert len(warnings) == 1 and "slow sample" in warnings[0]
    assert warnings[0].startswith("-----Possible too long execution of ")
    rep = t.report(64 * 64, 2, 3)
    assert list(rep) == ["total_ms", "ms_per_loop", "mrays_per_sec"]
    assert rep["total_ms"] > 0 and rep["mrays_per_sec"] > 0
    assert rep["ms_per_loop"] == pytest.approx(rep["total_ms"] / 2)


def test_dump_visit_csv_matches_jax(tmp_path):
    v = np.array([3, 0, 7, 12], np.int32)
    tprof.dump_visit_csv(str(tmp_path / "t.csv"), torch.from_numpy(v))
    tprof.dump_visit_csv(str(tmp_path / "n.csv"), v)
    jprof.dump_visit_csv(str(tmp_path / "j.csv"), v)
    want = (tmp_path / "j.csv").read_bytes()
    assert want == b"3,\n0,\n7,\n12,\n"
    assert (tmp_path / "t.csv").read_bytes() == want
    assert (tmp_path / "n.csv").read_bytes() == want


def test_device_health_on_the_cpu_has_the_jax_keys():
    h = tprof.device_health("cpu")
    assert list(h) == list(jprof.device_health())
    assert h["platform"] == "cpu"
    assert h["temperature_c"] is None and h["hbm_bytes_in_use"] is None \
        and h["hbm_bytes_limit"] is None


def test_health_watchdog_pauses_and_resumes():
    calls = {"n": 0}
    seen = []

    def gate(health):
        seen.append(health["platform"])
        calls["n"] += 1
        return calls["n"] <= 2  # pause for two polls, then clear

    msgs = []
    w = tprof.HealthWatchdog(should_pause=gate, poll_s=0.01,
                             on_pause=msgs.append, device="cpu")
    assert w.check() is True
    assert msgs == ["render paused: device health gate", "render resumed"]
    assert seen == ["cpu"] * 3
    # disabled by default, like the reference's commented-out loop
    assert tprof.HealthWatchdog().check() is False


def test_progress_cb_once_per_chunk():
    cfg = T.RenderConfig(width=8, height=8, spp=5, integrator="pt_nee",
                         samples_per_call=2)
    calls = []
    st = T.render(tproc.to_scene(tproc.cornell_box(), "cpu"),
                  T.make_camera(width=8, height=8, device="cpu"), cfg,
                  progress_cb=lambda done, s: calls.append((done, s.n)),
                  device="cpu")
    assert calls == [(2, 2), (4, 4), (5, 5)] and st.n == 5


def test_write_render_picks_the_format_by_extension(tmp_path):
    cfg = T.RenderConfig(width=8, height=8, spp=1, integrator="pt_nee")
    st = T.render(tproc.to_scene(tproc.cornell_box(), "cpu"),
                  T.make_camera(width=8, height=8, device="cpu"), cfg,
                  device="cpu")
    T.write_render(tmp_path / "a.png", st, cfg)
    T.write_render(tmp_path / "a.PPM", st, cfg)
    want = T.finalize_image(st, cfg)[:, ::-1]
    np.testing.assert_array_equal(tpng.read_png(tmp_path / "a.png"), want)
    np.testing.assert_array_equal(read_ppm(str(tmp_path / "a.PPM")), want)
    assert (tmp_path / "a.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_profile_trace_writes_a_trace(tmp_path):
    with tprof.profile_trace(tmp_path) as prof:
        torch.ones(64).cumsum(0)
    assert any("cumsum" in e.key for e in prof.key_averages())
    assert any(p.name.endswith(".pt.trace.json") for p in tmp_path.iterdir())
