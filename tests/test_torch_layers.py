"""The port's float layers against the JAX package, op by op, at f32 and
bf16.  Same inputs and parameters (numpy, from a seed) go through both.

Tolerances (float sums are reassociated differently by XLA and by
PyTorch, and bf16 rounds at other places), with the largest error
measured on the CPU:
  f32   atol 2e-5                                  (measured 3.4e-6)
  bf16  atol max(0.1, 0.05 x the output's range)   (measured 0.094 on
        outputs up to 10, i.e. under 1% of the range)
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from aivc_tpu.ops import entropy_models as jem
from aivc_tpu.ops import gain as jgain
from aivc_tpu.ops import gdn as jgdn
from aivc_tpu.ops import layers as jl
from aivc_tpu_torch import kernels
from aivc_tpu_torch.models import conditional as tm
from aivc_tpu_torch.ops import entropy_models as tem
from aivc_tpu_torch.ops import gain as tgain
from aivc_tpu_torch.ops import gdn as tgdn
from aivc_tpu_torch.ops import layers as tl
from aivc_tpu_torch.ops.quantizer import quantize
from aivc_tpu_torch.utils.checkpoint import params_from_jax

F32_ATOL = 2e-5
BF16_ATOL, BF16_RTOL = 0.1, 0.05


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Test workers share the host's cores: a small PyTorch pool keeps
    them from oversubscribing it (spinning OpenMP threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _perturb(tree, rng, scale=0.3):
    """Random parameters of the init's shapes (init gains/GDN are near
    identity, which would hide layout errors)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng, scale)
        else:
            v = np.asarray(v, np.float32)
            out[k] = (v + scale * rng.standard_normal(v.shape)
                      .astype(np.float32) * (np.abs(v).mean() + 0.1))
    return out


def _run(jmod, tmod, x_nhwc, wrap: str, seed: int = 0):
    """Apply both modules to the same input and parameters; returns
    (jax NHWC output, port output moved to NHWC)."""
    rng = np.random.default_rng(seed)
    params = jax.jit(jmod.init)(jax.random.PRNGKey(0),
                                jnp.asarray(x_nhwc))["params"]
    params = _perturb(jax.tree_util.tree_map(np.asarray, params), rng)
    ref = np.asarray(jax.jit(jmod.apply)({"params": params},
                                         jnp.asarray(x_nhwc)), np.float32)
    sd = {k.split(".", 1)[1]: v
          for k, v in params_from_jax({wrap: params}).items()}
    tmod.load_state_dict(sd)
    x = torch.from_numpy(x_nhwc).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        out = tmod(x).float().permute(0, 2, 3, 1).numpy()
    return ref, out


def _check(ref, out, dtype):
    assert ref.shape == out.shape
    err = np.abs(ref - out).max()
    if dtype == "float32":
        assert err <= F32_ATOL, err
    else:
        scale = np.abs(ref).max() + 1e-6
        assert err <= max(BF16_ATOL, BF16_RTOL * scale), (err, scale)


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nl,stride,k", [("gdn", 2, 5), ("leaky_relu", 1, 3),
                                         ("gdn_inverse@16!lp", 2, 5)])
def test_conv_block(dtype, nl, stride, k):
    x = _x((2, 16, 24, 8))
    ref, out = _run(jl.ConvBlock(12, k, stride, nl, dtype),
                    tl.ConvBlock(8, 12, k, stride, nl, dtype), x,
                    "ConvBlock_0")
    _check(ref, out, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nl", ["gdn_inverse!lp", "no"])
def test_up_block_shuffle_order(dtype, nl):
    x = _x((1, 8, 12, 10), seed=2)
    ref, out = _run(jl.UpBlock(6, 5, nl, dtype),
                    tl.UpBlock(10, 6, 5, nl, dtype), x, "UpBlock_0")
    _check(ref, out, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_simplified_attention(dtype):
    x = _x((1, 8, 8, 16), seed=3)
    ref, out = _run(jl.SimplifiedAttention(16, dtype=dtype),
                    tl.SimplifiedAttention(16, dtype=dtype), x,
                    "SimplifiedAttention_0")
    _check(ref, out, dtype)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("clamp", [0.0, 4.0])
@pytest.mark.parametrize("dtype,lowp", [("float32", False),
                                        ("bfloat16", False),
                                        ("bfloat16", True)])
def test_gdn_apply(inverse, clamp, dtype, lowp):
    rng = np.random.default_rng(4)
    c = 16
    x = (rng.standard_normal((2, 6, 5, c)) * 2).astype(np.float32)
    beta = (1.0 + 0.5 * rng.random(c)).astype(np.float32)
    gamma = (0.1 * np.eye(c) + 0.05 * rng.random((c, c))).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = np.asarray(jgdn.gdn_apply(jnp.asarray(x).astype(jd),
                                    jnp.asarray(beta), jnp.asarray(gamma),
                                    inverse, clamp, lowp), np.float32)
    td = tl.DTYPES[dtype]
    out = tgdn.gdn_apply(torch.from_numpy(x).permute(0, 3, 1, 2).to(td),
                         torch.from_numpy(beta), torch.from_numpy(gamma),
                         inverse, clamp, lowp)
    # the promotion rules match: lowp bf16 stays bf16, f32 params promote
    expect = torch.bfloat16 if (dtype == "bfloat16" and lowp) else (
        torch.float32)
    assert out.dtype == expect
    _check(ref, out.float().permute(0, 2, 3, 1).numpy(), dtype)


def test_yuv_boundary_layers():
    rng = np.random.default_rng(5)
    y = rng.random((2, 12, 10, 1)).astype(np.float32)
    u = rng.random((2, 6, 5, 1)).astype(np.float32)
    v = rng.random((2, 6, 5, 1)).astype(np.float32)
    ref = np.asarray(jl.yuv420_to_444(y, u, v))
    nchw = [torch.from_numpy(a).permute(0, 3, 1, 2) for a in (y, u, v)]
    x444 = tl.yuv420_to_444(*nchw)
    np.testing.assert_array_equal(x444.permute(0, 2, 3, 1).numpy(), ref)
    jy, ju, jv = jl.x444_to_yuv420(jnp.asarray(ref))
    ty, tu, tv = tl.x444_to_yuv420(x444)
    for a, b in ((jy, ty), (ju, tu), (jv, tv)):
        np.testing.assert_allclose(b.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(a), rtol=0, atol=1e-7)


@pytest.mark.parametrize("idx", [0.0, 0.25, 1.0, 1.7, 2.0, 3.5, -1.0])
def test_interpolate_gain(idx):
    g = np.random.default_rng(6).normal(size=(3, 8)).astype(np.float32)
    ref = np.asarray(jgain.interpolate_gain(jnp.asarray(g), idx))
    out = tgain.interpolate_gain(torch.from_numpy(g), idx).numpy()
    np.testing.assert_allclose(out, ref, rtol=2e-6, atol=0)


def test_factorized_prior_cdf_and_laplace():
    rng = np.random.default_rng(7)
    c = 6
    jp = jem.FactorizedPrior(c)
    x = rng.uniform(-20, 20, size=(c, 50)).astype(np.float32)
    params = jax.jit(jp.init)(jax.random.PRNGKey(3), jnp.zeros((1, 2, 2, c)))
    params = jax.tree_util.tree_map(np.asarray, params)["params"]
    ref = np.asarray(jp.apply({"params": params}, jnp.asarray(x),
                              method=jp.cdf))
    tp = tem.FactorizedPrior(c)
    tp.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    with torch.no_grad():
        out = tp.cdf(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    y = rng.integers(-10, 10, size=(100,)).astype(np.float32)
    s = np.exp(rng.uniform(-3, 3, size=(100,))).astype(np.float32)
    np.testing.assert_allclose(
        tem.laplace_bin_prob(torch.from_numpy(y), torch.from_numpy(s)).numpy(),
        np.asarray(jem.laplace_bin_prob(jnp.asarray(y), jnp.asarray(s))),
        rtol=0, atol=1e-6)
    h = rng.normal(size=(1, 3, 4, 8)).astype(np.float32) * 20
    jmu, jsig = jem.pdf_parameterize(jnp.asarray(h), 4)
    tmu, tsig = tem.pdf_parameterize(
        torch.from_numpy(h).permute(0, 3, 1, 2), 4)
    np.testing.assert_array_equal(tmu.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jmu))
    np.testing.assert_allclose(tsig.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jsig), rtol=1e-6)


def test_quantize_rounds_half_to_even_and_clips():
    x = torch.tensor([-300.0, -2.5, -0.5, 0.5, 1.5, 2.4999, 300.0])
    assert quantize(x, 256).tolist() == [-256, -2, -0, 0, 2, 2, 255]
    np.testing.assert_array_equal(
        quantize(x, 64).numpy(),
        np.clip(np.asarray(jnp.round(jnp.asarray(x.numpy()))), -64, 63))


# ---------------------------------------------------------------------------
# The staged route of the bf16 nets (kernel K6 and channels-last
# activations).  K6 itself runs on the card alone (tests/test_torch_cuda.py);
# here its plain version, and the route with the plain version standing in
# for the kernel on the host.
# ---------------------------------------------------------------------------

def _replicate_gather(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Replication padding by clamped indices, independent of F.pad."""
    B, C, H, W = x.shape
    ys = (torch.arange(H + 2 * pad) - pad).clamp(0, H - 1)
    xs = (torch.arange(W + 2 * pad) - pad).clamp(0, W - 1)
    return x[:, :, ys][:, :, :, xs]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fmt", ["nchw", "channels_last"])
@pytest.mark.parametrize("pad", [1, 2])
@pytest.mark.parametrize("shape, channels", [((2, 8, 7, 13), None),
                                             ((1, 6, 5, 9), 8)])
def test_pad_stage_plain_is_replicate_pad_cast_channels_last(
        dtype, fmt, pad, shape, channels):
    g = torch.Generator().manual_seed(sum(shape) + pad)
    x = (torch.randn(shape, generator=g) * 3).to(dtype)
    if fmt == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    out = tl.pad_stage_plain(x, pad, channels)
    B, C, H, W = shape
    co = channels or C
    assert out.shape == (B, co, H + 2 * pad, W + 2 * pad)
    assert out.dtype == torch.bfloat16
    assert out.is_contiguous(memory_format=torch.channels_last)
    assert not out.is_contiguous()
    want = F.pad(x, (pad, pad, pad, pad), mode="replicate").to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    assert torch.equal(out[:, :C], want)
    # The cast commutes with the replication: padding the bf16 values
    # gives the same bits.
    assert torch.equal(out[:, :C],
                       _replicate_gather(x.to(torch.bfloat16), pad))
    # The channels past C, up to ``channels``, are zeros.
    assert not out[:, C:].any()
    # On the host the dispatcher takes the plain version and launches
    # nothing.
    before = dict(kernels.LAUNCHES)
    assert torch.equal(tl.pad_stage(x, pad, channels), out)
    assert kernels.LAUNCHES == before


def _perturbed(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("gamma"):
                p.copy_(torch.sqrt(torch.rand(p.shape, generator=g) * 0.05))
            elif name.endswith("beta"):
                p.copy_(torch.sqrt(torch.rand(p.shape, generator=g) + 0.5))
            else:
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    return module


def _transform(name: str):
    """(a bf16 transform of the codec's kinds at small widths, its input
    shape, its output shape, its ConvBlock / UpBlock count)."""
    if name == "g_a":
        return (tm.AnalysisTransform(6, 16, 24, 5, True, "bfloat16"),
                (2, 6, 64, 48), (2, 24, 4, 3), 16)
    if name == "g_s":
        return (tm.SynthesisTransform(24, 16, 3, 5, True, "bfloat16"),
                (2, 24, 4, 3), (2, 3, 64, 48), 16)
    if name == "h_a":
        return (tm.HyperAnalysis(24, 16, 16, "bfloat16"), (2, 24, 8, 12),
                (2, 16, 2, 3), 3)
    return (tm.HyperSynthesis(16, 16, 48, "bfloat16"), (2, 16, 2, 3),
            (2, 48, 8, 12), 3)


@pytest.mark.parametrize("name", ["g_a", "g_s", "h_a", "h_s"])
def test_bf16_transform_staged_route_keeps_nchw_f32(name, monkeypatch):
    """A bf16 transform returns NCHW-contiguous float32 of the same shape on
    the host route and on the staged route (the host standing in for the
    card, K6's plain version for the kernel), the same values on both;
    every block stages its input, and every one behind the transform's
    entry gets it channels-last."""
    module, in_shape, out_shape, n_blocks = _transform(name)
    _perturbed(module, 3)
    x = torch.randn(in_shape, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        host = module(x)
        staged_inputs = []

        def stage(t, pad, channels):
            staged_inputs.append(t)
            return tl.pad_stage_plain(t, pad, channels)

        monkeypatch.setattr(tl, "_on_card", lambda t: True)
        monkeypatch.setattr(tl, "pad_stage_cuda", stage)
        kernels.reset_launches()
        staged = module(x)
    for out in (host, staged):
        assert out.shape == out_shape
        assert out.dtype == torch.float32
        assert out.is_contiguous()
    assert torch.equal(staged, host)
    assert len(staged_inputs) == n_blocks
    assert kernels.FALLBACKS["conv_stage"] == 0
    assert staged_inputs[0].is_contiguous()       # the transform's input
    assert staged_inputs[0].dtype == torch.float32
    for t in staged_inputs[1:]:
        assert kernels.layout(t) == torch.channels_last


def _block(kind: str, dtype: str):
    if kind == "conv":
        return tl.ConvBlock(8, 8, 3, 1, "relu", dtype)
    return tl.UpBlock(8, 8, 3, "leaky_relu", dtype)


@pytest.mark.parametrize("kind", ["conv", "up"])
@pytest.mark.parametrize("case, staged", [
    ("bf16", True), ("bf16_no_grad_mode", True), ("float32", False),
    ("grad", False), ("input_grad", False), ("rows", False),
    ("host", False)])
def test_stage_route_predicate(kind, case, staged, monkeypatch):
    """The staged route takes bf16 calls on the card on the whole frame
    where autograd needs no graph; float32 nets, grad-needing calls and
    row bands keep the other route, which counts in
    FALLBACKS["conv_stage"] on the card."""
    block = _block(kind, "float32" if case == "float32" else "bfloat16")
    x = torch.randn((1, 8, 6, 5))
    if case != "host":
        monkeypatch.setattr(tl, "_on_card", lambda t: True)
    if case in ("bf16", "float32", "rows", "host"):
        block.requires_grad_(False)
    if case == "input_grad":
        block.requires_grad_(False)
        x.requires_grad_(True)
    if case == "rows":
        block.rows = object()
    with torch.set_grad_enabled(case != "bf16_no_grad_mode"):
        assert block.takes_stage(x) is staged
        if case in ("float32", "grad", "input_grad"):
            kernels.reset_launches()
            block(x)
            assert kernels.FALLBACKS["conv_stage"] == 1
            assert kernels.LAUNCHES["conv_stage"] == 0


@pytest.mark.parametrize("c", [1, 3, 8])
def test_staged_upblock_conv_order_and_shuffle(c):
    """An UpBlock's conv on the staged route (5 input channels, staged as
    8 with zeros) emits its channels in shuffle_order, and shuffle_staged
    of that channels-last output is pixel_shuffle of the conv's own
    output, laid out channels-last."""
    block = _perturbed(tl.UpBlock(5, c, 3, "no", "bfloat16"), c)
    assert block.Conv_0.stage_channels == 8
    x = torch.randn((2, 5, 4, 7)).to(torch.bfloat16)
    with torch.no_grad():
        want = F.pixel_shuffle(block.Conv_0(x), 2)
        y = block.Conv_0.staged(tl.pad_stage_plain(x, 0, 8))
        got = tl.shuffle_staged(y)
    assert got.shape == want.shape
    assert torch.equal(got, want)
    if c > 1:
        assert kernels.layout(got) == torch.channels_last
