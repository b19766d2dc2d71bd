"""The encode's launch/finish split with lookahead (pipeline/video.py:
encode_gop, FrameCodec.encode_frames_launch / encode_frames_finish;
aivc_tpu/pipeline/video.py:94-133), on the host with tiny-toy at 64x64.

* AIVC_PIPELINE_LOOKAHEAD 0, 2 and 4 write the same bytes, with either
  entropy backend: the K policy runs in encode_frames_finish, which
  sees the waves in coding order, so each of its calls sees the same
  history at every lookahead (recorded here); at 2 and 4 waves are
  really launched ahead (the order of launches and finishes is
  recorded).  At lookahead 4 the stream equals aivc_tpu's encode at its
  lookahead 4 byte for byte.
* A resumed encode (stream_dir) at lookahead 2 writes the bytes of an
  encode in one go at lookahead 0.
* Over a spatial mesh (two gloo ranks, spatial 2) at lookahead 4 the
  stream equals one process's at lookahead 0, and each rank's decode is
  bit-exact: every rank issues the same collectives in the same order.
"""

import os
from pathlib import Path

import pytest
import torch

from aivc_tpu.config import CodingConfig as JCodingConfig
from aivc_tpu.pipeline import video as jvideo
from aivc_tpu_torch import smoke
from aivc_tpu_torch.parallel.launch import run_ranks
from aivc_tpu_torch.pipeline import video as tvideo
from aivc_tpu_torch.pipeline.codec import FrameCodec
from aivc_tpu_torch.utils.checkpoint import load_checkpoint
from test_torch_dense_v1 import _jax_codec
from tests.torch_train_ref import limit_threads

ROOT = Path(__file__).resolve().parents[1]
TINY = ROOT / "models_ckpt" / "tiny-toy"
H = W = 64
N, GOP, WAVE = 9, 8, 2


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = limit_threads()
    yield
    torch.set_num_threads(n)


def _codec(backend: str = "device") -> FrameCodec:
    return FrameCodec(*load_checkpoint(TINY, device="cpu"), H, W,
                      device="cpu", entropy_backend=backend)


def _encode(codec, frames, depth: int, monkeypatch, **kw):
    monkeypatch.setenv("AIVC_PIPELINE_LOOKAHEAD", str(depth))
    return tvideo.encode_video(codec, frames, smoke.ra_coding(kw.pop(
        "gop", GOP)), wave_batch=WAVE, **kw).bitstream


class _Recorder:
    """Records each launch ("L") and finish ("F") of a codec, and what
    its K policy sees at each call: the frame type and the hints."""

    def __init__(self, codec: FrameCodec, monkeypatch):
        self.events, self.k_calls = [], []
        launch, finish, pick = (codec.encode_frames_launch,
                                codec.encode_frames_finish, codec._pick_k)

        def on_launch(*a, **kw):
            self.events.append("L")
            return launch(*a, **kw)

        def on_finish(*a, **kw):
            self.events.append("F")
            return finish(*a, **kw)

        def on_pick(frame_type, n_total):
            self.k_calls.append((frame_type, n_total,
                                 dict(codec._k_hint)))
            return pick(frame_type, n_total)

        monkeypatch.setattr(codec, "encode_frames_launch", on_launch)
        monkeypatch.setattr(codec, "encode_frames_finish", on_finish)
        monkeypatch.setattr(codec, "_pick_k", on_pick)

    def max_in_flight(self) -> int:
        depth = most = 0
        for e in self.events:
            depth += 1 if e == "L" else -1
            most = max(most, depth)
        return most


@pytest.mark.parametrize("backend", ["device", "host"])
def test_lookahead_writes_the_same_bytes(monkeypatch, backend):
    frames = tvideo.synthetic_frames(N, H, W)
    streams, records = {}, {}
    for depth in (0, 2, 4):
        codec = _codec(backend)
        rec = _Recorder(codec, monkeypatch)
        streams[depth] = _encode(codec, frames, depth, monkeypatch)
        records[depth] = rec
        waves = rec.events.count("L")
        assert rec.events.count("F") == waves > depth
        assert rec.max_in_flight() == depth + 1
    assert streams[2] == streams[0] and streams[4] == streams[0]
    if backend == "device":
        assert records[0].k_calls and all(
            records[d].k_calls == records[0].k_calls for d in (2, 4))
        monkeypatch.setenv("AIVC_PIPELINE_LOOKAHEAD", "4")
        jstream = jvideo.encode_video(
            _jax_codec(TINY, H, W), frames, JCodingConfig(
                coding_config="RA", gop_size=GOP, intra_period=GOP),
            wave_batch=WAVE).bitstream
        assert streams[4] == jstream


def test_lookahead_resumed_encode(monkeypatch, tmp_path):
    frames = tvideo.synthetic_frames(N, H, W)
    whole = _encode(_codec(), frames, 0, monkeypatch, gop=4)
    store = tmp_path / "streams"
    first = _encode(_codec(), frames, 2, monkeypatch, gop=4,
                    stream_dir=str(store))
    assert first == whole
    os.remove(store / "gop_00001.bin")
    resumed = _encode(_codec(), frames, 2, monkeypatch, gop=4,
                      stream_dir=str(store))
    assert resumed == whole


def test_lookahead_over_spatial_mesh(monkeypatch, tmp_path):
    frames = tvideo.synthetic_frames(N, H, W)
    one = _encode(_codec(), frames, 0, monkeypatch)
    monkeypatch.setenv("AIVC_PIPELINE_LOOKAHEAD", "4")
    res = run_ranks("aivc_tpu_torch.smoke:rank_mesh_codec", 2, "gloo",
                    tmp_path, device="cpu", timeout_s=120,
                    kwargs=dict(ckpt=str(TINY), frames=frames, gop=GOP,
                                wave_batch=WAVE, spatial=2))
    assert res[0]["bitstream"] == res[1]["bitstream"] == one
