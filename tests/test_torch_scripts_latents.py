"""``latent_range`` of the port on the host against the JAX package:
tiny-toy at 48x64, 9 frames of every held-out family, rates 0 and 2.
The reference is the library calls of scripts/latent_range.py:56-86 in
the same order (JAX's launch handles y_cqm, y_cqc, z_qm, z_qc; the
port's q_m, q_c, z_m, z_c).  The printed JSON must be equal: every
number in it is an integer.

A launch that is never finished leaves the codec as it was: after the
measurement the same codec encodes the clip into the bytes a fresh
codec writes.
"""

import json
import sys

import numpy as np
import pytest

import torch

from aivc_tpu_torch.scripts import latent_range
from torch_scripts_ref import ROOT, TINY_TOY, limit_threads, run_port

H, W, N = 48, 64, 9
RATES = (0.0, 2.0)
ARGV = ["--cpu", "--ckpt", TINY_TOY, "--h", H, "--w", W, "--frames", N,
        "--rates", "0,2"]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = limit_threads()
    yield
    torch.set_num_threads(n)


def jax_measure():
    sys.path.insert(0, str(ROOT / "scripts"))
    from eval_data import FAMILIES, heldout_clips

    from aivc_tpu.config import CodingConfig
    from aivc_tpu.gop import generate_gop_struct
    from aivc_tpu.pipeline.codec import FrameCodec
    from aivc_tpu.pipeline.video import wave_groups
    from aivc_tpu.utils.checkpoint import load_checkpoint

    cfg, params = load_checkpoint(TINY_TOY)
    codec = FrameCodec(cfg, params, H, W)
    clips = heldout_clips(N, H, W)
    max_y = max_z = 0
    hist = np.zeros(10, np.int64)
    for r in RATES:
        coding = CodingConfig(coding_config="RA", gop_size=8,
                              intra_period=8, idx_rate=r)
        gop = generate_gop_struct(coding.gop_struct_name())
        for frames in clips:
            decoded = {}
            for ftype, specs in wave_groups(gop, 4):
                handles = codec.encode_frames_launch(
                    [frames[s.idx] for s in specs],
                    [decoded.get(s.prev_ref) for s in specs],
                    [decoded.get(s.next_ref) for s in specs], ftype, r)
                for spec, dec in zip(specs, handles["decoded"]):
                    decoded[spec.idx] = dec.ref
                for key in ("y_cqm", "y_cqc"):
                    if handles.get(key) is not None:
                        q = np.abs(np.asarray(handles[key][0]))
                        max_y = max(max_y, int(q.max()))
                        for i in range(10):
                            hist[i] += int((q >= (1 << i)).sum())
                for key in ("z_qm", "z_qc"):
                    if handles.get(key) is not None:
                        z = np.abs(np.asarray(handles[key]))
                        max_z = max(max_z, int(z.max()))
                handles.clear()
    return latent_range.report(str(TINY_TOY), max_y, max_z, hist,
                               len(FAMILIES))


def test_json_equals_jax():
    rc, out = run_port(latent_range.main, ARGV)
    assert rc == 0
    got = json.loads(out.strip().splitlines()[-1])
    assert got == jax_measure()
    assert got["max_abs_y"] > 0 and got["count_ge_pow2"]["1"] > 0


def test_unfinished_launches_leave_the_codec_usable():
    from aivc_tpu_torch.eval.clips import heldout_clips
    from aivc_tpu_torch.pipeline.codec import FrameCodec
    from aivc_tpu_torch.pipeline.video import encode_video
    from aivc_tpu_torch.scripts.eval_ckpt import coding_for
    from aivc_tpu_torch.utils.checkpoint import load_checkpoint

    cfg, model = load_checkpoint(TINY_TOY, device="cpu")
    clips = heldout_clips(N, H, W, ["wheel", "photowarp"])
    coding = coding_for("RA", 8, 1.0)

    def stream(codec):
        return encode_video(codec, clips[1], coding, wave_batch=4).bitstream

    fresh = stream(FrameCodec(cfg, model, H, W, device="cpu"))
    codec = FrameCodec(cfg, model, H, W, device="cpu")
    latent_range.measure(codec, clips, [0.0, 2.0])
    assert stream(codec) == fresh


def test_no_card_exits_2(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert latent_range.main([str(a) for a in ARGV[1:]]) == 2
    assert "--cpu" in capsys.readouterr().err
