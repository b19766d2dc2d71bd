"""Kernel K7's plain version (ops/conv1x1.py) and the staged route of
ELIC's transforms (models/elic.py) on the host.  K7 itself runs on the
card alone (tests/test_torch_cuda.py).

On the card, cuDNN's bf16 convolution rounds its sum to bf16 and PyTorch
adds the bias in a pass of its own; on the host oneDNN adds the bias
before it rounds.  K7 computes the card's arithmetic, so here the unfused
module runs at the card's rounding points: the ``card_bias`` fixture makes
every convolution add its bias after the convolution has rounded.
"""

import dataclasses

import pytest
import torch
import torch.nn.functional as F

from aivc_tpu_torch import kernels
from aivc_tpu_torch.config import ElicConfig
from aivc_tpu_torch.models import elic as me
from aivc_tpu_torch.ops import conv1x1 as c1
from aivc_tpu_torch.ops import layers as tl

CL = torch.channels_last
# Pixel counts with a ragged tile: 91 and 135 pixels.
SHAPES = [(1, 7, 13), (3, 5, 9)]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Test workers share the host's cores: a small PyTorch pool keeps
    them from oversubscribing it (spinning OpenMP threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card_bias(monkeypatch):
    """Every conv2d / conv_transpose2d adds its bias after the
    convolution, as PyTorch does behind cuDNN on the card."""
    conv2d, conv_t = F.conv2d, F.conv_transpose2d

    def later(fn):
        def run(x, w, b=None, *args, **kw):
            y = fn(x, w, None, *args, **kw)
            return y if b is None else y + b.view(1, -1, 1, 1)
        return run

    monkeypatch.setattr(F, "conv2d", later(conv2d))
    monkeypatch.setattr(F, "conv_transpose2d", later(conv_t))


def _perturbed(module, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in sorted(module.named_parameters()):
            v = torch.randn(p.shape, generator=g)
            p.copy_(v / p[0].numel() ** 0.5 if name.endswith("weight")
                    else 0.3 * v)
    return module


def _act(shape, c, seed, scale=1.0):
    b, h, w = shape
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((b, c, h, w), generator=g) * scale).to(
        torch.bfloat16).contiguous(memory_format=CL)


# ---------------------------------------------------------------------------
# The plain version against the module's own arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("c", [32, 96, 192, 320])
def test_plain_is_the_bottleneck_bit_for_bit(card_bias, c, shape):
    """A Bottleneck's staged route (K7's plain version for conv a with the
    relu epilogue and conv c with the residual one, the 3x3 conv without
    its bias between them) equals its unfused forward, bit for bit, and
    keeps the activations channels-last."""
    block = _perturbed(me.Bottleneck(c, "bfloat16"), c)
    x = _act(shape, c, c + 1, 2.0)
    with torch.no_grad():
        want = block(x.contiguous())
        got = block.staged(x)
    assert got.dtype == torch.bfloat16
    assert got.is_contiguous(memory_format=CL)
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("c", [32, 192, 320])
def test_plain_is_the_attention_bit_for_bit(card_bias, c, shape):
    """An Attention's staged route (six staged bottlenecks, then K7's
    plain version with the gate epilogue) equals its unfused forward, bit
    for bit."""
    block = _perturbed(me.Attention(c, "bfloat16"), 2 * c)
    x = _act(shape, c, c + 2, 2.0)
    with torch.no_grad():
        want = block(x.contiguous())
        got = block.staged(x)
    assert got.is_contiguous(memory_format=CL)
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("k, n", [(16, 16), (16, 48), (48, 32), (96, 192),
                                  (192, 96), (192, 192), (160, 320),
                                  (320, 160), (320, 320), (112, 304)])
@pytest.mark.parametrize("epilogue", c1.EPILOGUES)
def test_plain_epilogues_are_the_unfused_ops(card_bias, epilogue, k, n,
                                             shape):
    """Each epilogue of the plain version, at widths that are multiples of
    16 up to 320, equals the module's ops on a Conv's bf16 parameters:
    relu(conv(x)); res + conv(relu(r + b_in)), r a 3x3 conv's raw output
    and b_in its bias; res + t * sigmoid(conv(x)).  On the host
    ``conv1x1`` is the plain version and launches nothing."""
    conv = _perturbed(tl.Conv(k, n, 1, dtype="bfloat16"), k * n)
    w, b = conv.staged_params()
    x = _act(shape, k, k + n, 2.0)
    res = _act(shape, n, k + n + 1)
    trunk = _act(shape, n, k + n + 2)
    b_in = (torch.linspace(-1.0, 1.0, k) * 0.7).to(torch.bfloat16)
    with torch.no_grad():
        if epilogue == "relu":
            want = torch.relu(conv(x.contiguous()))
        elif epilogue == "residual":
            want = res + conv(torch.relu(x + b_in.view(1, -1, 1, 1)))
        else:
            want = res + trunk * torch.sigmoid(conv(x.contiguous()))
        before = dict(kernels.LAUNCHES)
        got = c1.conv1x1(x, w.flatten(1), b, epilogue, bias_in=b_in,
                         residual=res, trunk=trunk)
    assert kernels.LAUNCHES == before
    assert got.is_contiguous(memory_format=CL)
    assert torch.equal(got, want.contiguous(memory_format=CL))


@pytest.mark.parametrize("k, n, ok", [(16, 16, True), (320, 320, True),
                                      (192, 96, True), (8, 16, False),
                                      (24, 32, False), (32, 40, False),
                                      (336, 32, False), (32, 336, False),
                                      (0, 16, False)])
def test_fits_takes_multiples_of_16_up_to_320(k, n, ok):
    assert c1.fits(k, n) is ok


# ---------------------------------------------------------------------------
# The wrapper refuses what the kernel does not take (before any launch)
# ---------------------------------------------------------------------------

def _args(k=32, n=16, shape=(2, 3, 5)):
    b, h, w = shape

    def act(c):
        return torch.zeros((b, c, h, w), dtype=torch.bfloat16).contiguous(
            memory_format=CL)

    return dict(x=act(k), weight=torch.zeros((n, k), dtype=torch.bfloat16),
                bias=torch.zeros(n, dtype=torch.bfloat16),
                bias_in=torch.zeros(k, dtype=torch.bfloat16),
                residual=act(n), trunk=act(n))


def _call(epilogue="gate", **kw):
    a = _args()
    a.update(kw)
    return c1.conv1x1_cuda(a["x"], a["weight"], a["bias"], epilogue,
                           a["bias_in"], a["residual"], a["trunk"])


@pytest.mark.parametrize("case, match", [
    ("x_float32", "x must be bfloat16"),
    ("weight_float32", "weight must be bfloat16"),
    ("trunk_half", "trunk must be bfloat16"),
    ("x_nchw", r"x must be contiguous"),
    ("residual_nchw", r"residual must be contiguous"),
    ("weight_transposed", r"weight must be contiguous"),
    ("k_24", "multiple of 16"),
    ("n_8", "multiple of 16"),
    ("k_336", "multiple of 16"),
    ("x_grad", "forward-only"),
    ("weight_grad", "forward-only"),
    ("no_trunk", "needs trunk"),
    ("no_residual", "needs residual"),
    ("bias_shape", r"bias must have shape"),
    ("residual_shape", r"residual must have shape"),
    ("epilogue", "epilogue must be one of"),
    ("on_host", "must be on the card"),
])
def test_wrapper_refuses_wrong_inputs(case, match):
    a = _args()
    if case == "x_float32":
        kw = dict(x=a["x"].float())
    elif case == "weight_float32":
        kw = dict(weight=a["weight"].float())
    elif case == "trunk_half":
        kw = dict(trunk=a["trunk"].half())
    elif case == "x_nchw":
        kw = dict(x=a["x"].contiguous())
    elif case == "residual_nchw":
        kw = dict(residual=a["residual"].contiguous())
    elif case == "weight_transposed":
        kw = dict(weight=torch.zeros((32, 16), dtype=torch.bfloat16).t())
    elif case == "k_24":
        kw = _args(k=24)
    elif case == "n_8":
        kw = _args(n=8)
    elif case == "k_336":
        kw = _args(k=336)
    elif case == "x_grad":
        kw = dict(x=a["x"].clone().requires_grad_())
    elif case == "weight_grad":
        kw = dict(weight=a["weight"].clone().requires_grad_())
    elif case == "no_trunk":
        kw = dict(trunk=None)
    elif case == "no_residual":
        with pytest.raises(ValueError, match=match):
            _call("residual", residual=None)
        return
    elif case == "bias_shape":
        kw = dict(bias=torch.zeros(17, dtype=torch.bfloat16))
    elif case == "residual_shape":
        kw = dict(residual=a["residual"][:1])
    elif case == "epilogue":
        with pytest.raises(ValueError, match=match):
            _call("silu")
        return
    else:
        kw = {}
    with pytest.raises(ValueError, match=match):
        _call(**kw)


# ---------------------------------------------------------------------------
# The staged route of ELIC's transforms on the host (the plain versions of
# K6 and K7 standing in for the kernels)
# ---------------------------------------------------------------------------

# A small ELIC whose 1x1 widths K7 takes: 32 -> 16 -> 32, 64 -> 32 -> 64.
SMALL = ElicConfig(name="elic-small", n=32, m=64, groups=(4, 4, 8, 16, 32),
                   ctx_hidden=(12, 8), agg_hidden=(24, 16),
                   dtype="bfloat16")


def _small(cfg=SMALL):
    model = _perturbed(me.Elic(cfg), 11)
    return model


class _Card:
    """The host standing in for the card on the staged route: the route
    predicate sees a card, K6 runs its plain version, and each K6 call's
    input is kept."""

    def __init__(self, monkeypatch):
        self.stage_inputs = []

        def stage(t, pad, channels=None):
            self.stage_inputs.append(t)
            return tl.pad_stage_plain(t, pad, channels)

        monkeypatch.setattr(tl, "_on_card", lambda t: True)
        monkeypatch.setattr(tl, "pad_stage_cuda", stage)


def test_staged_synthesis_is_the_unfused_one(card_bias, monkeypatch):
    """g_s on the staged route (K6 at its entry, channels-last bf16
    through every layer, K7's plain version in every bottleneck and gate,
    the transposed convs on their cached channels-last weights) returns
    the unfused route's NCHW float32, bit for bit, with no fallback."""
    model = _small()
    y = torch.round(torch.randn((2, 64, 3, 5),
                                generator=torch.Generator().manual_seed(5))
                    * 3)
    with torch.no_grad():
        want = model.synthesize(y)
        card = _Card(monkeypatch)
        kernels.reset_launches()
        got = model.synthesize(y)
    assert got.shape == (2, 3, 48, 80) and got.dtype == torch.float32
    assert got.is_contiguous()
    assert torch.equal(got, want)
    assert kernels.FALLBACKS["conv1x1"] == 0
    assert len(card.stage_inputs) == 1
    assert card.stage_inputs[0].shape == y.shape


def test_staged_analysis_matches_the_unfused_one(card_bias, monkeypatch):
    """g_a on the staged route: K6 casts the NCHW frame with zero channels
    up to 8, and every layer after the entry conv equals the unfused
    route's on the same input, bit for bit.  The whole analysis agrees to
    within a few bf16 ulps only: the host's convolution sums 3 channels
    and the staged 8 (five of them zero) in different orders, and the
    entry conv's rounding differences carry through g_a."""
    model = _small()
    x = torch.rand((2, 3, 64, 80), generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        want = model.analyze(x)
        h = model.g_a.conv_0(x.to(torch.bfloat16))
        rest = me.Stack([(n, getattr(model.g_a, n))
                         for n in model.g_a.order[1:]])
        want_rest = rest(h)
        card = _Card(monkeypatch)
        kernels.reset_launches()
        got = model.analyze(x)
        got_rest = rest.staged(h.contiguous(memory_format=CL))
    assert torch.equal(got_rest, want_rest)
    assert got.shape == want.shape == (2, 64, 4, 5)
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert float((got - want).abs().max()) <= 0.05 * float(want.abs().max())
    assert kernels.FALLBACKS["conv1x1"] == 0
    assert len(card.stage_inputs) == 1
    assert card.stage_inputs[0].dtype == torch.float32
    assert card.stage_inputs[0].is_contiguous()


@pytest.mark.parametrize("case, staged", [
    ("bf16", True), ("no_grad_mode", True), ("float32", False),
    ("grad", False), ("widths", False), ("host", False)])
def test_elic_stage_route_predicate(case, staged, monkeypatch):
    """The transforms take the staged route in bf16 on the card where no
    autograd graph is wanted and every 1x1 width fits K7; otherwise the
    unfused route, whose Bottleneck and Attention calls on the card count
    each 1x1 conv in FALLBACKS["conv1x1"]: two in each of g_a's 21
    bottlenecks (9 alone, 12 in its two attentions) and the two gates."""
    cfg = SMALL
    if case == "float32":
        cfg = dataclasses.replace(SMALL, dtype="float32")
    if case == "widths":
        cfg = ElicConfig(name="elic-tiny", n=16, m=40,
                         groups=(2, 2, 4, 8, 24), ctx_hidden=(12, 8),
                         agg_hidden=(24, 16), dtype="bfloat16")
    model = _small(cfg)
    assert model.k7_widths is (case != "widths")
    if case != "grad":
        model.requires_grad_(False)
    if case != "host":
        _Card(monkeypatch)
    x = torch.rand((1, 3, 64, 64))
    with torch.set_grad_enabled(case != "no_grad_mode"):
        assert model.takes_stage(x, model.g_a.conv_0) is staged
        if case in ("float32", "grad", "widths"):
            kernels.reset_launches()
            with torch.no_grad():
                model.g_a(x.to(model.dt))
            assert kernels.FALLBACKS["conv1x1"] == 2 * 21 + 2
            assert kernels.LAUNCHES["conv1x1"] == 0


@pytest.mark.parametrize("cout", [8, 3])
def test_tconv_staged_weight_is_cached_per_version(cout):
    """TConv's staged weight is made once per parameter version (its
    outputs rounded up to 8 with zeros): the same tensors on a second
    call, new ones after the parameters change, and the staged conv
    equals the unfused one on channels-last input."""
    t = _perturbed(me.TConv(16, cout, "bfloat16"), 4)
    w1, b1 = t.staged_params()
    w2, _ = t.staged_params()
    assert w1 is w2
    assert w1.shape == (16, 8, 5, 5) and w1.is_contiguous(memory_format=CL)
    assert b1.shape == (8,) and not w1[:, cout:].any() and not b1[cout:].any()
    x = _act((2, 3, 4), 16, 9)
    with torch.no_grad():
        got = t.staged(x)
        assert got.shape == (2, cout, 6, 8)
        assert torch.equal(got, t(x.contiguous()))
        t.weight.mul_(2.0)
    w3, _ = t.staged_params()
    assert w3 is not w1
    assert torch.equal(w3.float(), (2 * w1.float()))
