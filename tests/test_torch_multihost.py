"""GOP round-robin over torch.distributed (aivc_tpu_torch/parallel/
multihost.py) on two gloo ranks on the host, against aivc_tpu.

* tests/test_multihost.py's GOP_WORKER case (48x64, 9 random frames, RA
  GOP 4, wave batch 2; tiny-toy): both ranks return the same stream,
  equal byte for byte to aivc_tpu's single-process encode_video, which
  the port decodes here bit-exactly against the ranks' reconstructions
  (at 48x64 K stays 8, so the rank count does not move the bytes).
* _allgather_bytes over two ranks with empty and unequal lists, and in
  one process without a group; encode_video_multihost in one process
  equals encode_video.
* AIVC_VRANS_K set to a K the policy does not pick (64x64: the policy
  picks 8): the port's stream equals JAX's under the same setting.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from aivc_tpu.config import CodingConfig as JCodingConfig
from aivc_tpu.pipeline import video as jvideo
from aivc_tpu_torch import smoke
from aivc_tpu_torch.config import CodingConfig
from aivc_tpu_torch.parallel.launch import run_ranks
from aivc_tpu_torch.parallel.multihost import (
    _allgather_bytes,
    encode_video_multihost,
)
from aivc_tpu_torch.pipeline import video as tvideo
from aivc_tpu_torch.pipeline.codec import FrameCodec
from aivc_tpu_torch.utils.checkpoint import load_checkpoint
from test_torch_dense_v1 import _jax_codec
from tests.torch_train_ref import limit_threads

ROOT = Path(__file__).resolve().parents[1]
TINY = ROOT / "models_ckpt" / "tiny-toy"


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = limit_threads()
    yield
    torch.set_num_threads(n)


def _gop_worker_frames(h=48, w=64, n=9):
    """The frames of tests/test_multihost.py:GOP_WORKER."""
    rng = np.random.default_rng(7)
    frames = []
    for _ in range(n):
        y = rng.integers(0, 255, (h, w), dtype=np.uint8)
        frames.append({"y": y, "u": y[::2, ::2] // 2 + 40,
                       "v": 200 - y[::2, ::2] // 2})
    return frames


def _jax_stream(frames, h, w, gop=4, wave_batch=2):
    return jvideo.encode_video(
        _jax_codec(TINY, h, w), frames, JCodingConfig(
            coding_config="RA", gop_size=gop, intra_period=gop),
        wave_batch=wave_batch).bitstream


def test_round_robin_matches_jax_single_process(tmp_path):
    frames = _gop_worker_frames()
    res = run_ranks("aivc_tpu_torch.smoke:rank_round_robin", 2, "gloo",
                    tmp_path, device="cpu",
                    kwargs=dict(ckpt=str(TINY), frames=frames, gop=4,
                                wave_batch=2))
    stream = res[0]["bitstream"]
    assert res[1]["bitstream"] == stream
    assert stream == _jax_stream(frames, 48, 64)
    # 1_GOP_4 is 5 frames: rank 0 coded GOP 0, rank 1 GOP 1 (frames 5-8
    # and a repeat of frame 8)
    assert sorted(res[0]["md5"]) == [0, 1, 2, 3, 4]
    assert sorted(res[1]["md5"]) == [5, 6, 7, 8]
    md5 = {**res[0]["md5"], **res[1]["md5"]}
    codec = FrameCodec(*load_checkpoint(TINY, device="cpu"), 48, 64,
                       device="cpu")
    assert smoke.recon_md5(tvideo.decode_video(codec, stream),
                           range(9)) == md5
    assert smoke.stream_ks(stream) == [8] * 10


def test_allgather_bytes_over_two_ranks(tmp_path):
    lists = [[b"", b"abc", bytes(range(256)) * 3], []]
    res = run_ranks("tests.torch_ranks:allgather_bytes", 2, "gloo",
                    tmp_path, device="cpu", kwargs={"lists": lists})
    assert res == [lists, lists]
    assert _allgather_bytes([b"x", b""]) == [[b"x", b""]]
    assert _allgather_bytes([]) == [[]]


def test_multihost_in_one_process_equals_encode_video():
    frames = tvideo.synthetic_frames(5, 64, 64)
    cfg, model = load_checkpoint(TINY, device="cpu")
    coding = CodingConfig(coding_config="RA", gop_size=4, intra_period=4)
    decoded = {}
    stream = encode_video_multihost(
        FrameCodec(cfg, model, 64, 64, device="cpu"), frames, coding,
        wave_batch=2, decoded=decoded)
    enc = tvideo.encode_video(FrameCodec(cfg, model, 64, 64, device="cpu"),
                              frames, coding, wave_batch=2)
    assert stream == enc.bitstream
    assert smoke.recon_md5(decoded, range(5)) == smoke.recon_md5(
        enc.decoded_frames, range(5))


def test_vrans_k_override_matches_jax(monkeypatch):
    frames = tvideo.synthetic_frames(5, 64, 64)
    cfg, model = load_checkpoint(TINY, device="cpu")
    coding = CodingConfig(coding_config="RA", gop_size=4, intra_period=4)

    def port():
        return tvideo.encode_video(FrameCodec(cfg, model, 64, 64,
                                              device="cpu"),
                                   frames, coding, wave_batch=2).bitstream

    assert set(smoke.stream_ks(port())) == {8}
    monkeypatch.setenv("AIVC_VRANS_K", "32")
    stream = port()
    assert set(smoke.stream_ks(stream)) == {32}
    assert stream == _jax_stream(frames, 64, 64)
