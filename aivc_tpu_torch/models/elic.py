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
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from aivc_tpu_torch.config import ElicConfig
from aivc_tpu_torch.ops.entropy_models import FactorizedPrior
from aivc_tpu_torch.ops.layers import DTYPES, Conv

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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dt
        k = self.weight.shape[-1]
        w = self.weight.transpose(0, 1).contiguous().to(dt)
        return F.conv_transpose2d(x.to(dt), w, self.bias.to(dt), stride=2,
                                  padding=k // 2, output_padding=1)


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


class Bottleneck(nn.Module):
    def __init__(self, c: int, dtype: str):
        super().__init__()
        self.a = Conv(c, c // 2, 1, dtype=dtype)
        self.b = Conv(c // 2, c // 2, 3, dtype=dtype, padding=1)
        self.c = Conv(c // 2, c, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.c(torch.relu(self.b(torch.relu(self.a(x)))))


class Attention(nn.Module):
    def __init__(self, c: int, dtype: str):
        super().__init__()
        for i in range(3):
            setattr(self, f"trunk_{i}", Bottleneck(c, dtype))
            setattr(self, f"branch_{i}", Bottleneck(c, dtype))
        self.gate = Conv(c, c, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = b = x
        for i in range(3):
            t = getattr(self, f"trunk_{i}")(t)
            b = getattr(self, f"branch_{i}")(b)
        return x + t * torch.sigmoid(self.gate(b))


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
    def analyze(self, x: torch.Tensor) -> torch.Tensor:
        """Padded 4:4:4 frame [B, 3, H, W] -> y [B, M, H/16, W/16]."""
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
        return self.g_s(y_hat.to(self.dt)).float()
