"""The port's quality metrics (aivc_tpu_torch/ops/metrics.py) against
aivc_tpu/ops/metrics.py on the host, on even and odd image sizes (the
odd ones take the reflect pad before each pooling, and the smallest
scales a window narrower than 11 taps), and ``evaluate_frames``'s MS-SSIM
against the JAX pipeline's on the same decoded frames.

Tolerance 5e-6 absolute on SSIM / MS-SSIM values in [0, 1]: the port
filters with two 1-D passes, JAX with one 2-D convolution, so the sums
run in another order, and the variances E[x^2] - mu^2 cancel digits.
Against the same MS-SSIM in float64, JAX is off by up to 2.0e-6 on these
images and the port by 7.2e-7; measured 2.7e-6 between the two.  PSNR
and MSE: 1e-6 relative.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from aivc_tpu.ops import metrics as jm
from aivc_tpu.pipeline import video as jvideo
from aivc_tpu_torch.ops import metrics as tm
from aivc_tpu_torch.pipeline import video as tvideo

ATOL = 5e-6


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Test workers share the host's cores: a small PyTorch pool keeps
    them from oversubscribing it (spinning OpenMP threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pair(b, h, w, c, seed, noise=0.1):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 0.5 + 0.3 * np.sin(xx / 7.0 + seed) * np.cos(yy / 5.0)
    a = np.clip(base[None, :, :, None] + 0.05 * rng.standard_normal(
        (b, h, w, c)), 0, 1).astype(np.float32)
    d = np.clip(a + noise * rng.standard_normal(a.shape), 0, 1).astype(
        np.float32)
    return a, d


def _nchw(a):
    return torch.tensor(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("hw", [(64, 96), (75, 53), (9, 14)])
def test_ssim_matches_jax(hw):
    a, d = _pair(2, *hw, 3, seed=hw[0])
    js, jcs = jm.ssim(jnp.array(a), jnp.array(d))
    ts, tcs = tm.ssim(_nchw(a), _nchw(d))
    assert abs(float(ts) - float(js)) <= ATOL
    assert abs(float(tcs) - float(jcs)) <= ATOL


@pytest.mark.parametrize("hw", [(96, 128), (101, 67)])
def test_msssim_matches_jax(hw):
    a, d = _pair(1, *hw, 1, seed=hw[1])
    ref = float(jm.msssim(jnp.array(a), jnp.array(d)))
    out = float(tm.msssim(_nchw(a), _nchw(d)))
    assert abs(out - ref) <= ATOL
    assert 0.0 < out < 1.0


@pytest.mark.parametrize("hw", [(64, 64), (70, 90)])
def test_yuv_metrics_match_jax(hw):
    h, w = hw
    planes = {}
    for k, (ph, pw) in (("y", (h, w)), ("u", (h // 2, w // 2)),
                        ("v", (h // 2, w // 2))):
        planes[k] = _pair(1, ph, pw, 1, seed=ph + pw + len(k))
    ja = {k: jnp.array(v[0]) for k, v in planes.items()}
    jd = {k: jnp.array(v[1]) for k, v in planes.items()}
    ta = {k: _nchw(v[0]) for k, v in planes.items()}
    td = {k: _nchw(v[1]) for k, v in planes.items()}
    assert abs(float(tm.yuv_msssim(ta, td)) - float(jm.yuv_msssim(ja, jd))
               ) <= ATOL
    ref = float(jm.yuv_mse(ja, jd))
    assert abs(float(tm.yuv_mse(ta, td)) - ref) <= 1e-6 * ref
    ref = float(jm.yuv_psnr(ja, jd))
    assert abs(float(tm.yuv_psnr(ta, td)) - ref) <= 1e-6 * ref
    ms = float(jm.yuv_msssim(ja, jd))
    assert abs(float(tm.msssim_db(ms)) - float(jm.msssim_db(ms))) <= 1e-5


def test_evaluate_frames_ms_ssim_matches_jax():
    frames = tvideo.synthetic_frames(3, 72, 96, seed=4)
    rng = np.random.default_rng(5)
    decoded = {i: {k: np.clip(f[k].astype(np.int32) + rng.integers(
        -6, 7, f[k].shape), 0, 255).astype(np.uint8) for k in f}
        for i, f in enumerate(frames)}
    ref = jvideo.evaluate_frames(frames, decoded)
    out = tvideo.evaluate_frames(frames, decoded, device="cpu")
    assert abs(out["psnr"] - ref["psnr"]) <= 1e-6 * ref["psnr"]
    assert abs(out["ms_ssim"] - ref["ms_ssim"]) <= ATOL
    assert abs(out["ms_ssim_db"] - ref["ms_ssim_db"]) <= 1e-3


def test_evaluate_frames_needs_the_card_unless_told(monkeypatch):
    """Like the port's other entry points it runs on the card by default
    and raises without one rather than fall back to the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    frames = tvideo.synthetic_frames(1, 32, 32, seed=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tvideo.evaluate_frames(frames, dict(enumerate(frames)))
