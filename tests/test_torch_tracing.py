"""The port's spans (aivc_tpu_torch/tracing.py) on the host: off by
default and free when off, their nesting and wave ids, the spans a tiny
RA clip records through FrameCodec, the same bytes and planes with
recording on and off, the clock shared with torch.profiler, and the
split of a trace's idle card time by the innermost span."""

import sys
import threading
import time
import tracemalloc
from pathlib import Path

import numpy as np
import pytest
import torch

from aivc_tpu_torch import smoke, tracing
from aivc_tpu_torch.pipeline.codec import FrameCodec
from aivc_tpu_torch.pipeline.video import (
    decode_video,
    encode_video,
    synthetic_frames,
)
from aivc_tpu_torch.utils.checkpoint import load_checkpoint

ROOT = Path(__file__).resolve().parents[1]
CKPT = ROOT / "models_ckpt" / "tiny-toy"
H = W = 64
WAVE = 4

ENCODE = {"video.encode", "video.gop", "launch", "launch.upload",
          "launch.mofnet", "launch.warp", "launch.codecnet",
          "launch.planes", "finish", "finish.pull", "finish.k1",
          "finish.pack"}
DECODE = {"video.decode", "video.gop", "batch", "batch.parse",
          "batch.upload", "batch.k2", "batch.nets", "planes.pull"}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Test workers share the host's cores: a small PyTorch pool keeps
    them from oversubscribing it (spinning OpenMP threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    return synthetic_frames(9, H, W)


def _codec(backend: str = "device") -> FrameCodec:
    return FrameCodec(*load_checkpoint(CKPT, device="cpu"), H, W,
                      device="cpu", entropy_backend=backend)


def _code(frames, backend: str = "device"):
    """A fresh codec's RA stream of ``frames`` and its decoded planes."""
    codec = _codec(backend)
    enc = encode_video(codec, frames, smoke.ra_coding(8), wave_batch=WAVE)
    dec = decode_video(codec, enc.bitstream)
    return enc, {i: dec[i].planes for i in sorted(dec)}


def _boom():
    raise AssertionError("the clock was read with tracing off")


def test_off_by_default_records_nothing_and_reads_no_clock(monkeypatch,
                                                           frames):
    assert tracing.new_wave() is None
    monkeypatch.setattr(tracing, "_now", _boom)
    sp = tracing.span("launch", wave=None, k=3, frame_type=1)
    assert sp is tracing.NOOP
    with tracing.span("finish.k1") as inner:
        inner.note(K=8, steps=2)
        assert inner is tracing.NOOP
    # A whole encode and decode with spans everywhere, no clock read.
    enc, dec = _code(frames[:5])
    assert enc.bitstream and len(dec) == 5


def test_off_allocates_nothing():
    def loop(n):
        for _ in range(n):
            with tracing.span("batch.k2", K=8, steps=3) as sp:
                sp.note(K=8)

    loop(10)
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        tracemalloc.reset_peak()
        current, _ = tracemalloc.get_traced_memory()
        loop(20000)
        _, peak = tracemalloc.get_traced_memory()
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    # 20,000 spans kept would take megabytes; nothing is kept, nothing
    # grows, and no block of the module's is left.
    assert peak - current < 1024
    only = [tracemalloc.Filter(True, tracing.__file__)]
    grown = after.filter_traces(only).compare_to(
        before.filter_traces(only), "lineno")
    assert all(st.count_diff <= 0 for st in grown)
    assert len({id(tracing.span("pool")) for _ in range(100)}) == 1


def test_spans_nest_with_parents_and_wave_ids():
    with tracing.recording() as rec:
        wave = tracing.new_wave()
        with tracing.span("launch", wave=wave, k=3, frame_type=2) as top:
            with tracing.span("launch.mofnet") as mid:
                with tracing.span("mesh.gather"):
                    time.sleep(0.002)
            time.sleep(0.002)
            with tracing.span("launch.warp") as warp:
                pass
        with tracing.span("finish", wave=wave, k=3) as fin:
            with tracing.span("finish.k1") as k1:
                k1.note(K=16, steps=5)
        seen = []
        worker = threading.Thread(target=lambda: seen.append(
            tracing.span("pool").__enter__()))
        worker.start()
        worker.join()
    assert tracing.new_wave() is None
    by_name = {s.name: s for s in rec.spans}
    assert [s.name for s in rec.spans] == [
        "mesh.gather", "launch.mofnet", "launch.warp", "launch",
        "finish.k1", "finish"]
    assert top.parent is None and fin.parent is None
    assert mid.parent == top.id and warp.parent == top.id
    assert by_name["mesh.gather"].parent == mid.id
    assert k1.parent == fin.id
    # The wave id and k of the launch are the finish's and inherited.
    assert {s.wave for s in rec.spans} == {wave}
    assert {s.k for s in rec.spans} == {3}
    assert top.attrs == {"frame_type": 2} and k1.attrs == {"K": 16,
                                                           "steps": 5}
    assert len({s.id for s in rec.spans}) == len(rec.spans)
    # Another thread starts its own stack.
    assert seen[0].parent is None and seen[0].wave is None
    # Self time: the duration less what the children cover.
    kids = (mid.end - mid.start) + (warp.end - warp.start)
    assert rec.self_ns(top) == top.end - top.start - kids
    assert rec.self_ns(top) >= 2e6
    summary = rec.summary()
    assert summary["launch"]["n"] == 1
    assert summary["launch"]["self_seconds"] == pytest.approx(
        rec.self_ns(top) / 1e9)
    assert rec.seconds("mesh.gather") >= 0.002
    assert by_name["launch"].cls == "dispatch"
    assert by_name["finish"].cls == "host"


def test_names_and_nesting_are_refused():
    with tracing.recording():
        with pytest.raises(ValueError, match="no span"):
            tracing.span("launch.nothing")
        with pytest.raises(RuntimeError, match="already"):
            with tracing.recording():
                pass
    assert tracing.span("pool") is tracing.NOOP


def test_ra_clip_records_the_tables_spans(frames):
    codec = _codec()
    with tracing.recording() as enc_rec:
        enc = encode_video(codec, frames, smoke.ra_coding(8),
                           wave_batch=WAVE)
    with tracing.recording() as dec_rec:
        dec = decode_video(codec, enc.bitstream)
        for i in sorted(dec):
            dec[i].planes
    assert {s.name for s in enc_rec.spans} == ENCODE
    assert {s.name for s in dec_rec.spans} == DECODE
    assert len(enc_rec.named("video.encode")) == 1
    assert len(dec_rec.named("video.decode")) == 1
    launches, finishes = enc_rec.named("launch"), enc_rec.named("finish")
    # 1_GOP_8 in waves of at most 4: I, P, B, B+B, B x 4 = 5 waves.
    assert len(launches) == len(finishes) == 5
    assert [s.wave for s in launches] == [s.wave for s in finishes]
    assert len({s.wave for s in launches}) == 5
    assert [s.k for s in launches] == [s.k for s in finishes]
    assert sum(s.k for s in launches) == 9
    for fin in finishes:
        assert len([s for s in enc_rec.spans if s.parent == fin.id
                    and s.name == "finish.k1"]) == 1
    # K and steps: one K1 launch a wave, at the stream's K.
    ks = smoke.stream_ks(enc.bitstream)
    k1 = enc_rec.named("finish.k1")
    assert sorted(s.attrs["K"] for s in k1 for _ in range(s.k)) == sorted(ks)
    assert all(s.attrs["steps"] >= 1 for s in k1)
    assert len(dec_rec.named("batch")) == 5
    k2 = dec_rec.named("batch.k2")
    assert {s.attrs["K"] for s in k2} == set(ks)
    # the children of a wave share its id; everything inside a call
    for s in enc_rec.spans:
        assert s.name.startswith("video.") or s.wave is not None
    assert len(dec_rec.named("planes.pull")) == 5


def test_host_backend_records_the_pool(frames):
    codec = _codec("host")
    with tracing.recording() as rec:
        encode_video(codec, frames[:5], smoke.ra_coding(4), wave_batch=2)
    pools = rec.named("pool")
    assert pools and all(s.cls == "host" for s in pools)
    finish_ids = {s.id for s in rec.named("finish")}
    assert all(s.parent in finish_ids for s in pools)
    assert "finish.k1" not in {s.name for s in rec.spans}


def test_bytes_and_planes_equal_with_tracing_on_and_off(frames):
    off_enc, off_dec = _code(frames)
    with tracing.recording() as rec:
        on_enc, on_dec = _code(frames)
    assert rec.spans
    assert on_enc.bitstream == off_enc.bitstream
    assert sorted(on_dec) == sorted(off_dec)
    for i in off_dec:
        for c in ("y", "u", "v"):
            assert np.array_equal(on_dec[i][c], off_dec[i][c])
            assert np.array_equal(on_enc.decoded_frames[i][c],
                                  off_enc.decoded_frames[i][c])


def test_spans_land_on_the_profilers_timeline():
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            tracing.recording() as rec:
        with record_function("warm"):
            pass
        for i in range(3):
            with tracing.span("batch.parse"):
                time.sleep(0.001)
                with record_function(f"probe{i}"):
                    time.sleep(0.002)
                time.sleep(0.001)
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    events = {e.name: e for e in prof.events()}
    spans = rec.on_trace(start_ns)
    assert len(spans) == 3 and spans[0]["class"] == "host"
    for i, s in enumerate(spans):
        e = events[f"probe{i}"]
        assert s["start_us"] <= e.time_range.start + 50
        assert e.time_range.end <= s["end_us"] + 50
        # and the range sits well inside: the span's sleeps flank it
        assert e.time_range.start - s["start_us"] >= 900
        assert s["end_us"] - e.time_range.end >= 900


@pytest.mark.parametrize("kernels,spans,want", [
    # no span: all idle is outside
    ([(10, 20), (30, 40)], [], {None: 80.0}),
    # a dispatch parent with a host child: the gap between kernels
    # splits at the child's edges
    ([(0, 10), (50, 100)],
     [(0, 100, "dispatch"), (20, 45, "host")],
     {"dispatch": 15.0, "host": 25.0}),
    # overlapping kernels count once; idle outside every span
    ([(0, 30), (10, 20), (60, 100)], [(40, 50, "host")],
     {"host": 10.0, None: 20.0}),
    # the window clips the idle ends; spans out of order
    ([(20, 30)], [(50, 200, "host"), (-50, 50, "dispatch")],
     {"dispatch": 40.0, "host": 50.0, None: 0.0}),
    # a busy card leaves nothing
    ([(-5, 105)], [(0, 100, "host")], {}),
])
def test_idle_by_splits_a_hand_placed_trace(kernels, spans, want):
    got = tracing.idle_by(kernels, spans, 0.0, 100.0)
    assert {k: v for k, v in got.items() if v} == {k: v for k, v in
                                                    want.items() if v}
    idle = 100.0 - tracing.union_length(
        (max(a, 0.0), min(b, 100.0)) for a, b in kernels)
    assert sum(got.values()) == pytest.approx(idle)


def test_idle_by_takes_the_innermost_span():
    kernels = [(0, 10), (90, 100)]
    spans = [(0, 100, "launch"), (10, 60, "launch.codecnet"),
             (20, 30, "mesh.gather"), (60, 90, "finish.pull")]
    got = tracing.idle_by(kernels, spans, 0.0, 100.0)
    assert got == {"launch.codecnet": 40.0, "mesh.gather": 10.0,
                   "finish.pull": 30.0}


def test_threads_record_every_span_with_their_own_parents():
    """More threads than cores opening nested spans at once, the switch
    interval shortened: every span is kept, with a unique id and its own
    thread's parent."""
    n_threads, n_spans = 24, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tracing.recording() as rec:
            def work():
                for _ in range(n_spans):
                    with tracing.span("batch", wave=tracing.new_wave(),
                                      k=1):
                        with tracing.span("batch.k2"):
                            pass

            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    spans = rec.spans
    assert len(spans) == 2 * n_threads * n_spans
    assert len({s.id for s in spans}) == len(spans)
    parents = {s.id: s for s in spans if s.name == "batch"}
    assert len({s.wave for s in parents.values()}) == n_threads * n_spans
    for s in spans:
        if s.name == "batch":
            assert s.parent is None
        else:
            p = parents[s.parent]
            assert p.thread == s.thread and p.wave == s.wave
            assert p.start <= s.start <= s.end <= p.end
