"""``probe_motion`` of the port on the host against the JAX package:
tiny-toy at 64x64, the first 4 held-out families (5 frames), rates 0, 1
and 2.  The reference is the calls of scripts/probe_motion.py:49-86 with
the frames scaled to [0, 1] as every coding path feeds them (the JAX
script hands MOFNet uint8 values: the stated departure of the port).
Each percentile of |raw flow|, |alpha logit| and |beta logit| within
1e-5 relative + 1e-6 of JAX's (measured 2.5e-6 relative at most).
The printed lines keep the JAX script's format.
"""

import re
import sys

import numpy as np
import pytest

import torch

from aivc_tpu_torch.scripts import probe_motion
from torch_scripts_ref import ROOT, TINY_TOY, limit_threads, run_port

H = W = 64
RATES = (0.0, 1.0, 2.0)
ARGV = ["--cpu", "--ckpt", TINY_TOY, "--h", H, "--w", W, "--rates", "0,1,2"]
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = limit_threads()
    yield
    torch.set_num_threads(n)


def jax_percentiles():
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, str(ROOT / "scripts"))
    from eval_data import heldout_clips

    from aivc_tpu.config import FRAME_B
    from aivc_tpu.models.fullnet import FullNet
    from aivc_tpu.ops.layers import yuv420_to_444
    from aivc_tpu.utils.checkpoint import load_checkpoint

    cfg, params = load_checkpoint(TINY_TOY)
    model = FullNet(cfg)

    def pad64(x):
        h, w = x.shape[1:3]
        return jnp.pad(x, ((0, 0), (0, (-h) % 64), (0, (-w) % 64), (0, 0)),
                       mode="edge")

    @jax.jit
    def mof_b(frame, prev, nxt, idx_rate):
        def run(m):
            out6, _ = m.mofnet(jnp.concatenate([frame, prev, nxt], axis=-1),
                               jnp.concatenate([prev, nxt], axis=-1),
                               idx_rate, FRAME_B, False, None)
            return out6
        return model.apply(params, method=run)

    stats = {"raw_flow": [], "logit_a": [], "logit_b": []}
    for clip in heldout_clips(5, H, W)[:4]:
        f444 = [pad64(yuv420_to_444(*(jnp.asarray(
            fr[c][None, ..., None], jnp.float32) / 255.0 for c in "yuv")))
            for fr in clip]
        prev, cur, nxt = f444[0], f444[2], f444[4]
        for r in RATES:
            out6 = np.asarray(mof_b(cur, prev, nxt, r), np.float32)
            stats["logit_a"].append(np.abs(out6[..., 0]).ravel())
            stats["logit_b"].append(np.abs(out6[..., 1]).ravel())
            stats["raw_flow"].append(np.abs(out6[..., 2:6]).ravel())
    return {k: np.percentile(np.concatenate(v), probe_motion.PERCENTILES)
            for k, v in stats.items()}


def test_percentiles_match_jax():
    from aivc_tpu_torch.eval.clips import FAMILIES, heldout_clips
    from aivc_tpu_torch.utils.checkpoint import load_checkpoint

    _, model = load_checkpoint(TINY_TOY, device="cpu")
    got = probe_motion.probe(model, heldout_clips(5, H, W,
                                                  list(FAMILIES)[:4]),
                             RATES, "cpu")
    ref = jax_percentiles()
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def test_lines():
    rc, out = run_port(probe_motion.main, ARGV)
    assert rc == 0
    lines = out.strip().splitlines()
    assert lines[0] == (f"ckpt {TINY_TOY}: flow_bound=0.0 ac_max_val=256 "
                        "gdn_clamp=0.0")
    num = r"\d+\.\d{3}"
    for line, k in zip(lines[1:], ("raw_flow", "logit_a", "logit_b")):
        assert re.fullmatch(
            rf"{k:9s} p50 {num}  p90 {num}  p99 {num}  p99\.9 {num}  "
            rf"max {num}", line), line


def test_no_card_exits_2(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert probe_motion.main([str(a) for a in ARGV[1:]]) == 2
    assert "--cpu" in capsys.readouterr().err
