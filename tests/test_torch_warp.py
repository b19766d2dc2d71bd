"""The port's plain packed warp against aivc_tpu/ops/warp.py:warp_packed and
the bounded-flow Pallas kernel in interpret mode (as
tests/test_warp_bounded.py:41-55).  Bit-identical: the port evaluates the
same expression tree op by op (no FMA contraction)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from aivc_tpu.ops.warp import pack_yuv_u32 as j_pack
from aivc_tpu.ops.warp import warp_packed as j_warp
from aivc_tpu.ops.warp_pallas import warp_bounded_pallas
from aivc_tpu_torch.ops import warp as tw


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Test workers share the host's cores: a small PyTorch pool keeps
    them from oversubscribing it (spinning OpenMP threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _setup(b, h, w, fb, seed, extreme=False):
    rng = np.random.default_rng(seed)
    x = (np.round(rng.random((b, h, w, 3)) * 255.0) / 255.0).astype(
        np.float32)
    if extreme:
        flow = np.where(rng.random((b, h, w, 2)) < 0.5, -float(fb),
                        float(fb)).astype(np.float32)
    else:
        flow = rng.uniform(-fb, fb, size=(b, h, w, 2)).astype(np.float32)
    return x, flow


def _port(x, flow):
    packed = tw.pack_yuv_u32(torch.from_numpy(x).permute(0, 3, 1, 2))
    out = tw.warp_packed(packed, torch.from_numpy(flow[..., 0]),
                         torch.from_numpy(flow[..., 1]))
    return packed, out.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("shape,fb,extreme", [((2, 32, 128), 8, False),
                                              ((1, 64, 256), 30, False),
                                              ((1, 32, 192), 12, False),
                                              ((1, 32, 128), 16, True)])
def test_warp_packed_bitexact(shape, fb, extreme):
    b, h, w = shape
    x, flow = _setup(b, h, w, fb, seed=h + w, extreme=extreme)
    packed, out = _port(x, flow)
    jp = j_pack(jnp.asarray(x))
    np.testing.assert_array_equal(packed.numpy().astype(np.uint32),
                                  np.asarray(jp))
    ref = np.asarray(j_warp(jp, jnp.asarray(flow)))
    np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))
    pal = np.asarray(warp_bounded_pallas(jp, jnp.asarray(flow), fb=fb,
                                         interpret=True))
    # The Pallas kernel may contract one multiply-add (<= 1 ulp); its own
    # test holds it to warp_packed at 3e-7 (tests/test_warp_bounded.py).
    np.testing.assert_allclose(out, pal, rtol=0, atol=3e-7)


def test_unbounded_flow_matches():
    """The plain warp (and K3) has no bound: large flows clamp to the
    border exactly as warp_packed does."""
    x, flow = _setup(1, 16, 24, 200, seed=4)
    _, out = _port(x, flow)
    ref = np.asarray(j_warp(j_pack(jnp.asarray(x)), jnp.asarray(flow)))
    np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))


def test_engine_choice():
    assert tw.warp_engine(32.0) == "bounded"
    assert tw.warp_engine(38.0) == "bounded"
    assert tw.warp_engine(38.5) == "packed"
    assert tw.warp_engine(0.0) == "packed"


def test_mc_warp_on_host_is_plain():
    x, flow = _setup(1, 16, 32, 8, seed=7)
    packed = tw.pack_yuv_u32(torch.from_numpy(x).permute(0, 3, 1, 2))
    u = torch.from_numpy(flow[..., 0])
    v = torch.from_numpy(flow[..., 1])
    for engine in ("bounded", "packed"):
        assert torch.equal(tw.mc_warp(packed, u, v, engine),
                           tw.warp_packed(packed, u, v))
