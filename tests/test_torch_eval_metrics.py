"""The port's evaluation helpers against the JAX package's, on the host.

* ``ops/metrics_np.py`` (``psnr_np``, ``ssim_np``, ``msssim_np``) and
  ``ops/bd_metrics.py`` (``bd_psnr``, ``bd_rate``) are copies of JAX's:
  equal to the bit on the cases of tests/test_ops.py:262-300 and on
  seeded random inputs, and they raise where JAX's raise.
* The port's torch MS-SSIM (ops/metrics.py, float32) against the numpy
  oracle (float64).  Limit 2e-4, as tests/test_ops.py holds JAX's
  ``msssim``; measured at most 1.3e-6 here (odd and even sizes, three
  distortion levels), and 1.1e-7 for ``evaluate_frames``' aggregate on a
  240x416 held-out clip.
"""

import numpy as np
import pytest

import torch

from aivc_tpu.ops import bd_metrics as jbd
from aivc_tpu.ops import metrics_np as jnp_metrics
from aivc_tpu_torch.ops import bd_metrics as tbd
from aivc_tpu_torch.ops import metrics_np as tnp_metrics
from aivc_tpu_torch.ops.metrics import msssim

MSSSIM_TOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Test workers share the host's cores: a small PyTorch pool keeps
    them from oversubscribing it (spinning OpenMP threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _same_float(a: float, b: float) -> bool:
    return np.float64(a).tobytes() == np.float64(b).tobytes()


def _pair(seed: int, shape, noise: float, dtype=np.float32):
    rng = np.random.default_rng(seed)
    a = rng.random(shape).astype(dtype)
    b = np.clip(a + rng.normal(0, noise, shape), 0, 1).astype(dtype)
    return a, b


@pytest.mark.parametrize("shape,noise,dtype", [
    ((192, 176), 0.05, np.float32),     # tests/test_ops.py:266
    ((32, 32), 1.0, np.float32),        # tests/test_ops.py:276 (random b)
    ((61, 97), 0.02, np.float64),
    ((240, 416), 0.1, np.float32),
    ((7, 9), 0.3, np.float64),          # window smaller than 11
])
def test_numpy_oracle_equals_jax_to_the_bit(shape, noise, dtype):
    a, b = _pair(sum(shape), shape, noise, dtype)
    assert _same_float(tnp_metrics.psnr_np(a, b), jnp_metrics.psnr_np(a, b))
    assert _same_float(tnp_metrics.psnr_np(a * 255, b * 255, 255.0),
                       jnp_metrics.psnr_np(a * 255, b * 255, 255.0))
    s_t, cs_t = tnp_metrics.ssim_np(a, b)
    s_j, cs_j = jnp_metrics.ssim_np(a, b)
    assert _same_float(s_t, s_j) and _same_float(cs_t, cs_j)
    if min(shape) >= 16:     # five scales need 2^4 rows and columns
        assert _same_float(tnp_metrics.msssim_np(a, b),
                           jnp_metrics.msssim_np(a, b))
    assert _same_float(tnp_metrics.psnr_np(a, a), jnp_metrics.psnr_np(a, a))


def _analytic_curves():
    """tests/test_ops.py:284-300: a reference curve and shifted ones."""
    rates = [400.0, 800.0, 1600.0, 3200.0, 6400.0]
    ref = [(r, 30.0 + 3.0 * np.log2(r / 400.0)) for r in rates]
    return ref, {"same": ref,
                 "saved": [(r * 0.8, q) for r, q in ref],
                 "better": [(r, q + 1.5) for r, q in ref],
                 "worse": [(r * 1.25, q) for r, q in ref]}


@pytest.mark.parametrize("case", ["same", "saved", "better", "worse",
                                  "random"])
def test_bd_metrics_equal_jax_to_the_bit(case):
    ref, tests = _analytic_curves()
    if case == "random":
        rng = np.random.default_rng(11)
        rates = np.sort(rng.uniform(0.02, 0.4, 6))
        ref = [(float(r), float(28 + 4 * np.log2(r / 0.02)
                                + rng.normal(0, 0.2))) for r in rates]
        test = [(float(r * rng.uniform(0.8, 1.1)), float(q + rng.normal(
            0.3, 0.2))) for r, q in ref]
    else:
        test = tests[case]
    assert _same_float(tbd.bd_rate(ref, test), jbd.bd_rate(ref, test))
    assert _same_float(tbd.bd_psnr(ref, test), jbd.bd_psnr(ref, test))
    if case == "saved":
        assert abs(tbd.bd_rate(ref, test) + 20.0) < 0.5
    if case == "better":
        assert abs(tbd.bd_psnr(ref, test) - 1.5) < 1e-6


@pytest.mark.parametrize("bad", ["three_points", "zero_rate", "disjoint"])
def test_bd_metrics_refuse_as_jax(bad):
    ref, _ = _analytic_curves()
    test = {"three_points": ref[:3],
            "zero_rate": [(0.0, 30.0)] + ref[1:],
            "disjoint": [(r * 1e4, q + 100) for r, q in ref]}[bad]
    for mod in (tbd, jbd):
        for fn in (mod.bd_rate, mod.bd_psnr):
            with pytest.raises(ValueError):
                fn(ref, test)


@pytest.mark.parametrize("shape,noise", [((192, 176), 0.05),
                                         ((121, 203), 0.02),
                                         ((240, 416), 0.15)])
def test_torch_msssim_within_limit_of_the_oracle(shape, noise):
    a, b = _pair(sum(shape) + 1, shape, noise)
    got = float(msssim(torch.from_numpy(a)[None, None],
                       torch.from_numpy(b)[None, None]))
    err = abs(got - tnp_metrics.msssim_np(a, b))
    assert err <= MSSSIM_TOL, err


def test_evaluate_frames_ms_ssim_within_limit_of_the_oracle():
    """The golden runner's aggregate (per frame and plane, averaged over
    the frames, weighted by the plane's pixel count) computed with the
    oracle, against evaluate_frames on a held-out clip and a degraded
    copy of it."""
    from aivc_tpu_torch.eval.clips import heldout_clips
    from aivc_tpu_torch.eval.golden import oracle_ms_ssim
    from aivc_tpu_torch.pipeline.video import evaluate_frames

    frames = heldout_clips(2, 240, 416, names=["rotpan"])[0]
    rng = np.random.default_rng(3)
    noisy = {i: {c: np.clip(f[c].astype(np.int16) + rng.integers(
        -12, 13, f[c].shape), 0, 255).astype(np.uint8) for c in "yuv"}
        for i, f in enumerate(frames)}
    got = evaluate_frames(frames, noisy, device="cpu")["ms_ssim"]
    err = abs(got - oracle_ms_ssim(frames, noisy)["ms_ssim"])
    assert err <= MSSSIM_TOL, err
