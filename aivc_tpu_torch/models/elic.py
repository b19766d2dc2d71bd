"""ELIC, NCHW: He, Yang, Peng, Ma, Qin, Wang, "ELIC: Efficient Learned
Image Compression with Unevenly Grouped Space-Channel Contextual Adaptive
Coding", CVPR 2022, arXiv 2203.10886, sections 3-4, with the mean-scale
hyperprior of Minnen, Balle, Toderici 2018 (arXiv 1809.02736).  An
intra-only image codec: the coding pipeline runs it All-Intra
(pipeline/elic.py).

  g_a:  conv5 s2 -> N, 3 bottlenecks; conv5 s2 -> N, 3 bottlenecks,
        attention; conv5 s2 -> N, 3 bottlenecks; conv5 s2 -> M, attention
  g_s:  the mirror: attention; tconv5 s2 -> N, 3 bottlenecks; tconv5 s2
        -> N, attention, 3 bottlenecks; tconv5 s2 -> N, 3 bottlenecks;
        tconv5 s2 -> 3
  bottleneck(x) = x + conv1(C/2 -> C)(relu(conv3(relu(conv1(C -> C/2)(x)))))
  attention(x)  = x + trunk(x) * sigmoid(conv1(branch(x))), trunk and
                  branch three bottlenecks each (Cheng et al. 2020 without
                  the non-local part)
  h_a:  conv3 M -> N, relu, conv5 s2, relu, conv5 s2; z has N channels
        and a factorized prior (ops/entropy_models.py:FactorizedPrior)
  h_s:  tconv5 s2 N, relu, tconv5 s2 3N/2, relu, conv3 -> 2M: the hyper
        parameters of every group
  SCCTX: y is split into the uneven channel groups ``cfg.groups``
        (16, 16, 32, 64, 192), coded in order, each in two checkerboard
        passes: anchors ((row + col) even) first, then the non-anchors.
        Group k's channel context is a stack over the decoded groups < k
        (conv5 -> 224, relu, conv5 -> 128, relu, conv5 -> 2 g_k; none for
        the first group); its spatial context a checkerboard-masked conv5
        g_k -> 2 g_k over its own decoded anchors, zero in the anchor
        pass; a 1x1 aggregation stack (-> 640, relu, -> 512, relu, ->
        2 g_k) maps [hyper parameters, channel context, spatial context]
        to the pass's mean and scale.  Ten dependent steps a frame.

Departures from the paper, all of the codec's making:
* the input is the codec's 4:4:4 YUV frame in [0, 1] (4:2:0 chroma
  repeated 2x2), not RGB;
* convolutions run in ``cfg.dtype`` (bfloat16 by default) with float32
  parameters (ops/layers.py:Conv); latents, mean and scale are float32;
* every convolution pads with zeros; the frame itself is edge-padded to
  a multiple of 64 by the codec;
* the widths of the context and aggregation stacks (224 / 128, 640 / 512)
  are a reading of the paper's figure, not numbers it states;
* the Cheng attention's residual units add no ReLU after the sum;
* scales are bounded below by 0.11 and coded with a Gaussian quantised
  to the codec's 64 log-spaced scale bins (coding/cdf.py), symbols
  clipped to +-ac_max_val.

The staged route of g_a and g_s (bf16 on the card, no autograd graph:
``ops/layers.py:takes_stage``, and every 1x1 width one that kernel K7
takes): the activations stay channels-last bf16 from the transform's
entry to its exit.  The frame (g_a) or y_hat (g_s) enters through kernel
K6 (``pad_stage``, pad 0; the frame's 3 channels with zeros up to 8), the
strided convs run as ``Conv.staged`` with their cached channels-last
weights, the transposed convs with a bf16 channels-last weight made once
per parameter version (``TConv.staged``), and every bottleneck and gate
through K7 (ops/conv1x1.py): conv a with its bias and ReLU, the 3x3 conv
without its bias, conv c taking that bias and ReLU on its load and the
residual in its epilogue, the gate its bias, sigmoid, product and sum.
The transform returns NCHW float32 (``nchw_f32``), as on the other route,
which the host, float32 and training take as before.  K7's launches count
in ``kernels.LAUNCHES["conv1x1"]``; each 1x1 conv of a Bottleneck or
Attention call on the card on the other route in
``kernels.FALLBACKS["conv1x1"]``.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from aivc_tpu_torch import kernels
from aivc_tpu_torch.config import ElicConfig
from aivc_tpu_torch.ops import conv1x1 as c1
from aivc_tpu_torch.ops import layers
from aivc_tpu_torch.ops.entropy_models import FactorizedPrior
from aivc_tpu_torch.ops.layers import DTYPES, Conv, nchw_f32

SCALE_MIN = 0.11


def anchor_mask(h: int, w: int, device=None) -> torch.Tensor:
    """bool [h, w]: the checkerboard's anchors, (row + col) even."""
    r = torch.arange(h, device=device)[:, None]
    c = torch.arange(w, device=device)[None, :]
    return (r + c) % 2 == 0


class TConv(nn.Module):
    """Transposed 5x5 conv of stride 2, [B, cin, H, W] -> [B, cout, 2H,
    2W] (padding 2, output padding 1).  ``weight`` is [cout, cin, k, k],
    as a conv's, and runs transposed; compute in ``dtype``."""

    def __init__(self, cin: int, cout: int, dtype: str, k: int = 5):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.dt = DTYPES[dtype]
        self._staged = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dt
        k = self.weight.shape[-1]
        w = self.weight.transpose(0, 1).contiguous().to(dt)
        return F.conv_transpose2d(x.to(dt), w, self.bias.to(dt), stride=2,
                                  padding=k // 2, output_padding=1)

    def staged_params(self):
        """(weight [cin, co, k, k] bf16 channels-last, bias [co] bf16),
        co the outputs rounded up to 8 with zeros (g_s's last conv: 3 -> 8,
        which cuDNN's NHWC kernels run 1.16x as fast as 3 on the H100):
        made again only after the parameters change, keyed as
        ``Conv.staged_params`` keys its cache."""
        p = (self.weight, self.bias)
        key = None if any(t.is_inference() for t in p) else tuple(
            v for t in p for v in (t._version, t.data_ptr()))
        if key is None or self._staged is None or self._staged[0] != key:
            with torch.no_grad():
                pad = -self.weight.shape[0] % 8
                w = F.pad(self.weight.transpose(0, 1),
                          (0, 0, 0, 0, 0, pad))
                self._staged = (key, (
                    w.to(self.dt).contiguous(
                        memory_format=torch.channels_last),
                    F.pad(self.bias, (0, pad)).to(self.dt)))
        return self._staged[1]

    def staged(self, x: torch.Tensor) -> torch.Tensor:
        """The staged route: x bf16 channels-last; out channels-last (a
        view of the first outputs where they were rounded up)."""
        w, b = self.staged_params()
        k = self.weight.shape[-1]
        y = F.conv_transpose2d(x, w, b, stride=2, padding=k // 2,
                               output_padding=1)
        return y[:, :self.weight.shape[0]]


class MaskedConv(Conv):
    """5x5 conv whose taps at an even distance from the centre are zero:
    a non-anchor sees only the anchors around it."""

    def __init__(self, cin: int, cout: int, dtype: str, k: int = 5):
        super().__init__(cin, cout, k, 1, dtype, padding=k // 2)
        taps = ~anchor_mask(k, k)
        self.register_buffer("mask", taps.float()[None, None],
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dt
        return F.conv2d(x.to(dt), (self.weight * self.mask).to(dt),
                        self.bias.to(dt), padding=self.padding)


def _k7_params(conv: Conv):
    """A 1x1 conv's cached bf16 (weight [N, K], bias [N]) for K7."""
    w, b = conv.staged_params()
    return w.flatten(1), b


class Bottleneck(nn.Module):
    def __init__(self, c: int, dtype: str):
        super().__init__()
        self.a = Conv(c, c // 2, 1, dtype=dtype)
        self.b = Conv(c // 2, c // 2, 3, dtype=dtype, padding=1)
        self.c = Conv(c // 2, c, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if layers._on_card(x):
            kernels.FALLBACKS["conv1x1"] += 2
        return x + self.c(torch.relu(self.b(torch.relu(self.a(x)))))

    def staged(self, x: torch.Tensor) -> torch.Tensor:
        """The staged route: x bf16 channels-last, out the same."""
        h = c1.conv1x1(x, *_k7_params(self.a), "relu")
        w, bias_in = self.b.staged_params()
        r = F.conv2d(h, w, None, padding=self.b.padding)
        return c1.conv1x1(r, *_k7_params(self.c), "residual",
                          bias_in=bias_in, residual=x)


class Attention(nn.Module):
    def __init__(self, c: int, dtype: str):
        super().__init__()
        for i in range(3):
            setattr(self, f"trunk_{i}", Bottleneck(c, dtype))
            setattr(self, f"branch_{i}", Bottleneck(c, dtype))
        self.gate = Conv(c, c, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if layers._on_card(x):
            kernels.FALLBACKS["conv1x1"] += 1
        t = b = x
        for i in range(3):
            t = getattr(self, f"trunk_{i}")(t)
            b = getattr(self, f"branch_{i}")(b)
        return x + t * torch.sigmoid(self.gate(b))

    def staged(self, x: torch.Tensor) -> torch.Tensor:
        """The staged route: x bf16 channels-last, out the same."""
        t = b = x
        for i in range(3):
            t = getattr(self, f"trunk_{i}").staged(t)
            b = getattr(self, f"branch_{i}").staged(b)
        return c1.conv1x1(b, *_k7_params(self.gate), "gate", residual=x,
                          trunk=t)


class Stack(nn.Module):
    """Layers applied in order; a None layer is a ReLU."""

    def __init__(self, layers):
        super().__init__()
        self.order: List[Optional[str]] = []
        for name, layer in layers:
            if layer is not None:
                setattr(self, name, layer)
            self.order.append(name if layer is not None else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name in self.order:
            x = torch.relu(x) if name is None else getattr(self, name)(x)
        return x

    def staged(self, x: torch.Tensor) -> torch.Tensor:
        """Each layer's staged route in order (g_a and g_s: no ReLU)."""
        for name in self.order:
            x = getattr(self, name).staged(x)
        return x


RELU = ("relu", None)


def _conv(cin, cout, k, dtype, stride=1):
    return Conv(cin, cout, k, stride, dtype, padding=k // 2)


def _res(c, dtype, first):
    return [(f"res_{first + i}", Bottleneck(c, dtype)) for i in range(3)]


class Elic(nn.Module):
    """The transforms, hyperprior and context model of ``cfg``; the codec
    calls the stages (``analyze`` ... ``synthesize``)."""

    def __init__(self, cfg: ElicConfig):
        super().__init__()
        self.cfg = cfg
        n, m, d = cfg.n, cfg.m, cfg.dtype
        self.dt = DTYPES[d]
        self.g_a = Stack(
            [("conv_0", _conv(3, n, 5, d, 2))] + _res(n, d, 0)
            + [("conv_1", _conv(n, n, 5, d, 2))] + _res(n, d, 3)
            + [("att_0", Attention(n, d)), ("conv_2", _conv(n, n, 5, d, 2))]
            + _res(n, d, 6)
            + [("conv_3", _conv(n, m, 5, d, 2)), ("att_1", Attention(m, d))])
        self.g_s = Stack(
            [("att_0", Attention(m, d)), ("up_0", TConv(m, n, d))]
            + _res(n, d, 0)
            + [("up_1", TConv(n, n, d)), ("att_1", Attention(n, d))]
            + _res(n, d, 3) + [("up_2", TConv(n, n, d))] + _res(n, d, 6)
            + [("up_3", TConv(n, 3, d))])
        self.h_a = Stack([("conv_0", _conv(m, n, 3, d)), RELU,
                          ("conv_1", _conv(n, n, 5, d, 2)), RELU,
                          ("conv_2", _conv(n, n, 5, d, 2))])
        self.h_s = Stack([("up_0", TConv(n, n, d)), RELU,
                          ("up_1", TConv(n, 3 * n // 2, d)), RELU,
                          ("conv_0", _conv(3 * n // 2, 2 * m, 3, d))])
        self.pdf_z = FactorizedPrior(n)
        # K7 takes every 1x1 conv of the bottlenecks and gates.
        self.k7_widths = all(c1.fits(k, o) for c in (n, m)
                             for k, o in ((c, c // 2), (c // 2, c), (c, c)))
        ch, cc = cfg.ctx_hidden
        ah, ao = cfg.agg_hidden
        done = 0
        for k, g in enumerate(cfg.groups):
            grp = nn.Module()
            if k:
                grp.cc = Stack([("conv_0", _conv(done, ch, 5, d)), RELU,
                                ("conv_1", _conv(ch, cc, 5, d)), RELU,
                                ("conv_2", _conv(cc, 2 * g, 5, d))])
            grp.sc = MaskedConv(g, 2 * g, d)
            cin = 2 * m + 2 * g * (2 if k else 1)
            grp.pa = Stack([("conv_0", _conv(cin, ah, 1, d)), RELU,
                            ("conv_1", _conv(ah, ao, 1, d)), RELU,
                            ("conv_2", _conv(ao, 2 * g, 1, d))])
            setattr(self, f"group_{k}", grp)
            done += g

    # -- stages (float32 in and out) --------------------------------------
    def takes_stage(self, x: torch.Tensor, first: nn.Module) -> bool:
        """The staged route for a transform whose first layer is
        ``first``: ops/layers.py:takes_stage, and widths K7 takes."""
        return self.k7_widths and layers.takes_stage(x, first)

    def _staged(self, stack: Stack, x: torch.Tensor,
                channels: Optional[int] = None) -> torch.Tensor:
        x = x.detach()
        x = layers.pad_stage(x.contiguous(memory_format=kernels.layout(x)),
                             0, channels)
        return nchw_f32(stack.staged(x))

    def analyze(self, x: torch.Tensor) -> torch.Tensor:
        """Padded 4:4:4 frame [B, 3, H, W] -> y [B, M, H/16, W/16]."""
        if self.takes_stage(x, self.g_a.conv_0):
            return self._staged(self.g_a, x, self.g_a.conv_0.stage_channels)
        return self.g_a(x.to(self.dt)).float()

    def hyper_analyze(self, y: torch.Tensor) -> torch.Tensor:
        return self.h_a(y.to(self.dt)).float()

    def hyper_synthesize(self, z_q: torch.Tensor) -> torch.Tensor:
        """Decoded z -> the hyper parameters [B, 2M, 4 hz, 4 wz]."""
        return self.h_s(z_q.to(self.dt)).float()

    def channel_context(self, k: int, done: List[torch.Tensor]):
        """Group k's channel context [B, 2 g_k, ...] from the decoded
        groups < k (None for the first group)."""
        if not k:
            return None
        grp = getattr(self, f"group_{k}")
        return grp.cc(torch.cat(done, dim=1).to(self.dt)).float()

    def spatial_context(self, k: int, anchors: torch.Tensor) -> torch.Tensor:
        """Group k's spatial context from its decoded anchors (zero at the
        non-anchors)."""
        return getattr(self, f"group_{k}").sc(anchors).float()

    def params(self, k: int, hyper: torch.Tensor, cc: Optional[torch.Tensor],
               sc: torch.Tensor):
        """-> (mu, sigma) of group k, float32, from the hyper parameters,
        the channel context and the spatial context."""
        g = self.cfg.groups[k]
        parts = [hyper] + ([cc] if cc is not None else []) + [sc]
        out = getattr(self, f"group_{k}").pa(
            torch.cat(parts, dim=1).to(self.dt)).float()
        return out[:, :g], torch.clamp_min(out[:, g:], SCALE_MIN)

    def synthesize(self, y_hat: torch.Tensor) -> torch.Tensor:
        """y_hat [B, M, h, w] -> the 4:4:4 frame [B, 3, 16 h, 16 w]."""
        if self.takes_stage(y_hat, self.g_s.att_0.gate):
            return self._staged(self.g_s, y_hat)
        return self.g_s(y_hat.to(self.dt)).float()
