"""The port's float warps against the JAX package's, on the host:

* ``warp_vclamped`` (the plain version of kernel K5) against
  aivc_tpu/ops/warp_pallas.py:warp_pallas in interpret mode, at flow
  magnitudes 0, 0.7, 5 and 20 (20 is past the +-15 row clamp).
  Tolerance 1e-6 absolute on values in [-5, 5]; measured 4.8e-7 (an
  ulp or two: XLA on the CPU contracts some of the multiply-adds).
* ``warp_plain`` / ``motion_compensation`` against aivc_tpu/ops/warp.py's
  ``warp`` / ``motion_compensation``.  Tolerance 1e-6; measured 0.
* ``warp``'s route under AIVC_WARP=pallas and JAX's shape rule.
"""

import importlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from aivc_tpu.ops.warp_pallas import warp_pallas
from aivc_tpu_torch.ops import warp as tw

# aivc_tpu.ops shadows its warp submodule with the function.
jw = importlib.import_module("aivc_tpu.ops.warp")
ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Test workers share the host's cores: a small PyTorch pool keeps
    them from oversubscribing it (spinning OpenMP threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(b, h, w, c, mag, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    flow = (rng.standard_normal((b, h, w, 2)) * mag).astype(np.float32)
    return x, flow


def _nchw(a):
    return torch.tensor(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("mag", [0.0, 0.7, 5.0, 20.0])
def test_vclamped_matches_warp_pallas(mag):
    x, flow = _inputs(2, 64, 128, 3, mag, seed=int(mag * 10))
    ref = np.asarray(warp_pallas(jnp.array(x), jnp.array(flow),
                                 interpret=True))
    out = _nhwc(tw.warp_vclamped(_nchw(x), _nchw(flow)))
    assert np.abs(out - ref).max() <= ATOL
    if mag == 20.0:
        # The clamp engaged: the unclamped warp differs.
        assert np.abs(out - _nhwc(tw.warp_plain(_nchw(x), _nchw(flow)))
                      ).max() > 0.1


def test_vclamped_rejects_bad_shapes():
    x = torch.zeros((1, 1, 256, 200))
    with pytest.raises(ValueError):
        tw.warp_vclamped(x, torch.zeros((1, 2, 256, 200)))
    with pytest.raises(ValueError):
        warp_pallas(jnp.zeros((1, 256, 200, 1)), jnp.zeros((1, 256, 200, 2)),
                    interpret=True)
    with pytest.raises(ValueError):     # no row block in [8, 256]
        tw.warp_vclamped(torch.zeros((1, 1, 257, 128)),
                         torch.zeros((1, 2, 257, 128)))


@pytest.mark.parametrize("mag", [0.7, 20.0])
def test_warp_and_motion_compensation_match_jax(mag, monkeypatch):
    monkeypatch.setattr(jw, "_USE_PALLAS", False)
    monkeypatch.setattr(tw, "_USE_PALLAS", False)
    x, flow = _inputs(2, 40, 72, 3, mag, seed=3)
    nxt, flow2 = _inputs(2, 40, 72, 3, mag, seed=4)
    beta = np.random.default_rng(5).random((2, 40, 72, 1)).astype(
        np.float32)
    ref = np.asarray(jw.warp(jnp.array(x), jnp.array(flow)))
    out = _nhwc(tw.warp(_nchw(x), _nchw(flow)))
    assert np.abs(out - ref).max() <= ATOL
    ref = np.asarray(jw.motion_compensation(
        jnp.array(x), jnp.array(nxt), jnp.array(flow), jnp.array(flow2),
        jnp.array(beta)))
    out = _nhwc(tw.motion_compensation(_nchw(x), _nchw(nxt), _nchw(flow),
                                       _nchw(flow2), _nchw(beta)))
    assert np.abs(out - ref).max() <= ATOL


@pytest.mark.parametrize("hw,clamped", [((128, 128), True),
                                        ((768, 128), True),
                                        ((64, 192), False),
                                        ((320, 128), False)])
def test_warp_route_follows_jax_shape_rule(hw, clamped, monkeypatch):
    """With the switch on, W % 128 == 0 and H % min(H, 256) == 0 take the
    vertically clamped warp; other shapes the plain one, as in JAX."""
    monkeypatch.setattr(tw, "_USE_PALLAS", True)
    h, w = hw
    x = torch.rand((1, 1, h, w), generator=torch.Generator().manual_seed(0))
    flow = torch.zeros((1, 2, h, w))
    flow[:, 1] = 20.0
    got = tw.warp(x, flow)
    assert torch.equal(got, (tw.warp_vclamped if clamped
                             else tw.warp_plain)(x, flow))
    if clamped:   # 20 rows is past the clamp: the plain warp differs
        assert not torch.equal(got, tw.warp_plain(x, flow))
