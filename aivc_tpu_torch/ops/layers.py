"""Convolutional building blocks, NCHW.

Counterparts of aivc_tpu/ops/layers.py.  Submodule names follow the flax
auto-names (``ConvBlock_0``, ``Conv_0``, ``GDN_0`` ...) so that the
checkpoint tree maps onto ``state_dict`` keys one to one
(utils/checkpoint.py:params_from_jax).

* Convolutions run in the block's compute type (``dtype``), with
  replication padding, through cuDNN (``F.conv2d``).  The JAX package's
  S2DConv and LanePackedConv only reschedule the same sums and share the
  parameter tree (layers.py:96-105,143-162); the port runs the plain conv.
* ``UpBlock`` is the shuffle mode (layers.py:209-261): a conv to 4x
  channels and a pixel shuffle.  Its weights are stored in
  ``pixel_shuffle``'s (c, i, j) channel order.
* Row bands: a ``ConvBlock`` or ``UpBlock`` whose ``rows`` is a
  ``parallel/halo.py:RowBand`` runs on this rank's band of the frame's
  rows; its replication padding takes the halo rows from the bands above
  and below (the frame's edge row at its top and bottom), so each output
  row is the whole frame's.  A stride-2 conv keeps the rows aligned
  because every band starts on a multiple of 16 rows
  (parallel/mesh.py:check_rows); an UpBlock doubles its band.
  ``split_rows`` sets ``rows`` on every block of a module; the codec and
  the trainer set it on the stages they split.
* The staged route (bf16 nets on the card): a ``ConvBlock`` or ``UpBlock``
  whose compute type is bf16, called on the card on the whole frame
  (``rows`` None) where autograd needs no graph (``takes_stage``), pads,
  casts and lays out its input channels-last in one pass, kernel K6
  (``pad_stage_cuda``, csrc/kernels.cu:pad_stage_*_kernel; its plain
  version ``pad_stage_plain``), with zero channels up to a multiple of 8
  (``Conv.stage_channels``), and its conv reads that with a bf16
  channels-last weight made once per parameter version
  (``Conv.staged_params``): cuDNN runs its NHWC kernels with no transpose,
  and its output stays channels-last, as do the GDN layers', the
  activations', the residual adds', the attention's and the pixel
  shuffle's (``shuffle_staged``: the UpBlock's conv emits its channels
  in (i, j, c) order, so the shuffle copies whole pixels).  A transform
  takes NCHW input (``entry``: not cast where K6 casts) and returns
  NCHW-contiguous float32 (``nchw_f32``), as on every other route.
  K6's launches count in ``kernels.LAUNCHES["conv_stage"]``; a block
  call on the card that pads the other way (float32 nets, training, row
  bands) in ``kernels.FALLBACKS["conv_stage"]``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from aivc_tpu_torch import kernels
from aivc_tpu_torch.ops import ties
from aivc_tpu_torch.ops.gdn import GDN

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def replication_pad(x: torch.Tensor, pad: int, rows=None) -> torch.Tensor:
    """Replication padding of [B, C, H, W]; of a row band where ``rows``
    (a RowBand) is set: its halo rows from the neighbouring bands."""
    if rows is not None:
        return rows.pad(x, pad)
    if pad == 0:
        return x
    return F.pad(x, (pad, pad, pad, pad), mode="replicate")


def pad_stage_plain(x: torch.Tensor, pad: int,
                    channels: Optional[int] = None) -> torch.Tensor:
    """Plain version of kernel K6: [B, C, H, W] (any type, any layout)
    replication-padded by ``pad`` on each side, cast to bf16 and laid out
    channels-last, with zero channels after the C up to ``channels``
    (default C).  Replication and the cast commute, so padding first in
    x's type gives the same values."""
    if pad:
        x = F.pad(x, (pad, pad, pad, pad), mode="replicate")
    if channels is not None and channels > x.shape[1]:
        x = F.pad(x, (0, 0, 0, 0, 0, channels - x.shape[1]))
    return x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)


def pad_stage_cuda(x: torch.Tensor, pad: int,
                   channels: Optional[int] = None) -> torch.Tensor:
    """Kernel K6 on the card, the contract of ``pad_stage_plain``, bit
    for bit: x f32 or bf16 [B, C, H, W], NCHW-contiguous or channels-last
    (anything else is refused), ``pad`` >= 0, ``channels`` >= C (default
    C).  Out: bf16 channels-last [B, channels, H + 2 pad, W + 2 pad].
    Forward only: an x that requires grad is refused (the blocks hand it
    a detached x, under no graph)."""
    if x.requires_grad:
        raise ValueError("pad_stage_cuda is forward-only; x must not "
                         "require grad")
    if x.dim() != 4:
        raise ValueError(f"x must be [B, C, H, W], got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if pad < 0:
        raise ValueError(f"pad must be >= 0, got {pad}")
    B, C, H, W = x.shape
    co = C if channels is None else channels
    if co < C:
        raise ValueError(f"channels must be >= {C}, got {co}")
    fmt = kernels.layout(x)
    kernels.require(x, "x", x.dtype, (B, C, H, W), fmt)
    out = torch.empty((B, co, H + 2 * pad, W + 2 * pad), device=x.device,
                      dtype=torch.bfloat16,
                      memory_format=torch.channels_last)
    rc = kernels.lib().aivc_pad_stage(
        x.data_ptr(), int(x.dtype == torch.bfloat16),
        int(fmt == torch.channels_last), B, C, H, W, pad, co,
        out.data_ptr(), kernels.stream_ptr())
    kernels.check("conv_stage", rc)
    kernels.LAUNCHES["conv_stage"] += 1
    return out


def pad_stage(x: torch.Tensor, pad: int,
              channels: Optional[int] = None) -> torch.Tensor:
    """K6 for a tensor on the card, its plain version on the host."""
    if _on_card(x):
        return pad_stage_cuda(x, pad, channels)
    return pad_stage_plain(x, pad, channels)


def _on_card(x: torch.Tensor) -> bool:
    return x.device.type == "cuda"


def takes_stage(x: torch.Tensor, conv: "Conv", rows=None) -> bool:
    """The staged route for ``conv``'s input x: bf16 compute, on the
    card, the whole frame (``rows`` None), and no autograd graph wanted
    (grad mode off, or neither x nor the conv's parameters require grad),
    as GDN.takes_kernel."""
    needs_graph = torch.is_grad_enabled() and (
        x.requires_grad or conv.weight.requires_grad
        or conv.bias.requires_grad)
    return (conv.dt == torch.bfloat16 and rows is None and _on_card(x)
            and not needs_graph)


def shuffle_order(c: int) -> torch.Tensor:
    """The 4c channels of a shuffle UpBlock's conv in (i, j, c) order:
    position (2 i + j) c + k holds pixel_shuffle's channel 4 k + 2 i + j."""
    return torch.arange(4 * c).view(c, 4).t().reshape(-1)


def shuffle_staged(y: torch.Tensor) -> torch.Tensor:
    """``pixel_shuffle(., 2)`` of a channels-last [B, 4C, H, W] whose
    channels come in ``shuffle_order``: [B, C, 2H, 2W] channels-last,
    out[b, c, 2h + i, 2w + j] = y[b, (2i + j) C + c, h, w]; one copy,
    whole pixels of C channels at a time."""
    B, C4, H, W = y.shape
    C = C4 // 4
    t = y.permute(0, 2, 3, 1).reshape(B, H, W, 2, 2, C)
    t = t.permute(0, 1, 3, 2, 4, 5).reshape(B, 2 * H, 2 * W, C)
    return t.permute(0, 3, 1, 2)


def nchw_f32(x: torch.Tensor) -> torch.Tensor:
    """A transform's output: float32, NCHW-contiguous (one copy from the
    staged route's channels-last bf16; ``x.float()`` on the other routes,
    whose x is NCHW already)."""
    return x.to(torch.float32, memory_format=torch.contiguous_format)


def split_rows(module: nn.Module, rows) -> None:
    """Run every ConvBlock and UpBlock of ``module`` on the row band
    ``rows`` (a RowBand; None: the whole frame)."""
    for m in module.modules():
        if isinstance(m, (ConvBlock, UpBlock, SimplifiedAttention)):
            m.rows = rows


class Conv(nn.Module):
    """A conv whose parameters stay float32 and whose compute runs in
    ``dtype`` (flax ``nn.Conv(dtype=...)`` semantics: input, kernel and
    bias are cast, the output keeps the compute type).  ``padding``
    zero-pads each side (the AIVC blocks pad by replication before)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 dtype: str = "float32", padding: int = 0):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.stride = stride
        self.padding = padding
        self.dt = DTYPES[dtype]
        # The staged route's order of the output channels (None: the
        # parameters' own; an UpBlock's: shuffle_order).
        self.out_order = None
        self._staged = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dt
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                        stride=self.stride, padding=self.padding)

    @property
    def stage_channels(self) -> int:
        """The input channels of the staged route: the conv's, rounded up
        to 8 with zero channels (K6 writes them; the weight has zeros
        there), so that cuDNN's bf16 NHWC kernels run on the tensor cores
        (with 6 it takes a generic engine, 2.6-3.5x as slow on the H100
        at 1080p)."""
        return -(-self.weight.shape[1] // 8) * 8

    def staged_params(self):
        """(weight, bias) in the compute type, the weight channels-last
        with ``stage_channels`` inputs, both in ``out_order``: made again
        only after the parameters change, keyed as GDN.kernel_params keys
        its cache (on every call where they are inference tensors)."""
        p = (self.weight, self.bias)
        key = None if any(t.is_inference() for t in p) else tuple(
            v for t in p for v in (t._version, t.data_ptr()))
        if key is None or self._staged is None or self._staged[0] != key:
            with torch.no_grad():
                w, b = self.weight, self.bias
                w = F.pad(w, (0, 0, 0, 0, 0,
                              self.stage_channels - w.shape[1]))
                if self.out_order is not None:
                    w, b = w[self.out_order], b[self.out_order]
                self._staged = (key, (
                    w.to(self.dt).contiguous(
                        memory_format=torch.channels_last),
                    b.to(self.dt)))
        return self._staged[1]

    def staged(self, x: torch.Tensor) -> torch.Tensor:
        """The conv on the staged route: x in the compute type,
        channels-last with ``stage_channels`` channels (K6's output); out
        channels-last, in ``out_order``."""
        w, b = self.staged_params()
        return F.conv2d(x, w, b, stride=self.stride, padding=self.padding)


def _nonlinearity(name: str, ch: int) -> Optional[nn.Module]:
    """Same grammar as the JAX package: "gdn", "gdn_inverse" with an
    optional "@<clamp>" and "!lp" suffix, "leaky_relu", "relu", "no"."""
    lowp = False
    if name.startswith("gdn") and name.endswith("!lp"):
        name, lowp = name[:-3], True
    clamp = 0.0
    if name.startswith("gdn") and "@" in name:
        name, c = name.split("@", 1)
        clamp = float(c)
    if name in ("gdn", "gdn_inverse"):
        return GDN(ch, inverse=name == "gdn_inverse", clamp=clamp, lowp=lowp)
    if name == "leaky_relu":
        return ties.LeakyReLU(0.01)
    if name == "relu":
        return nn.ReLU()
    if name == "no":
        return None
    raise ValueError(f"unknown non-linearity {name!r}")


def _attach_nl(block: nn.Module, name: str, ch: int) -> None:
    nl = _nonlinearity(name, ch)
    if isinstance(nl, GDN):
        block.GDN_0 = nl
        block.nl = None
    else:
        block.nl = nl


def _apply_nl(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    if hasattr(block, "GDN_0"):
        return block.GDN_0(x)
    return block.nl(x) if block.nl is not None else x


class ConvBlock(nn.Module):
    """Replication pad + conv + nonlinearity (layers.py:ConvBlock)."""

    def __init__(self, cin: int, out_ft: int, k_size: int = 5,
                 stride: int = 1, non_linearity: str = "leaky_relu",
                 dtype: str = "float32"):
        super().__init__()
        self.pad = k_size // 2
        self.rows = None
        self.Conv_0 = Conv(cin, out_ft, k_size, stride, dtype)
        _attach_nl(self, non_linearity, out_ft)

    def takes_stage(self, x: torch.Tensor) -> bool:
        return takes_stage(x, self.Conv_0, self.rows)

    def entry(self, x: torch.Tensor) -> torch.Tensor:
        """A transform's input to this block: x itself where the block
        stages it (K6 casts), else cast to the compute type."""
        return x if self.takes_stage(x) else x.to(self.Conv_0.dt)

    def staged(self, x: torch.Tensor) -> torch.Tensor:
        """The conv of the staged route: K6, then the conv, channels-last
        out."""
        x = x.detach()
        return self.Conv_0.staged(pad_stage_cuda(
            x.contiguous(memory_format=kernels.layout(x)), self.pad,
            self.Conv_0.stage_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.takes_stage(x):
            return _apply_nl(self, self.staged(x))
        if _on_card(x):
            kernels.FALLBACKS["conv_stage"] += 1
        return _apply_nl(self, self.Conv_0(replication_pad(x, self.pad,
                                                           self.rows)))


class UpBlock(nn.Module):
    """Exact x2 upsampling, shuffle mode (layers.py:UpBlock)."""

    def __init__(self, cin: int, out_ft: int, k_size: int = 5,
                 non_linearity: str = "leaky_relu", dtype: str = "float32"):
        super().__init__()
        self.pad = k_size // 2
        self.rows = None
        self.Conv_0 = Conv(cin, 4 * out_ft, k_size, 1, dtype)
        self.Conv_0.out_order = shuffle_order(out_ft)
        _attach_nl(self, non_linearity, out_ft)

    takes_stage = ConvBlock.takes_stage
    entry = ConvBlock.entry
    staged = ConvBlock.staged

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.takes_stage(x):
            return _apply_nl(self, shuffle_staged(self.staged(x)))
        if _on_card(x):
            kernels.FALLBACKS["conv_stage"] += 1
        x = F.pixel_shuffle(self.Conv_0(replication_pad(x, self.pad,
                                                        self.rows)), 2)
        return _apply_nl(self, x)


class ResBlock(nn.Module):
    """pad-conv-relu-pad-conv with relu(x + f(x))."""

    def __init__(self, nb_ft: int, k_size: int = 3, dtype: str = "float32"):
        super().__init__()
        self.ConvBlock_0 = ConvBlock(nb_ft, nb_ft, k_size,
                                     non_linearity="relu", dtype=dtype)
        self.ConvBlock_1 = ConvBlock(nb_ft, nb_ft, k_size,
                                     non_linearity="no", dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(x + self.ConvBlock_1(self.ConvBlock_0(x)))


class SimplifiedAttention(nn.Module):
    """trunk * sigmoid(attention) + x; ResBlocks 0-2 are the trunk, 3-5
    the attention branch (flax creation order).  Its 1x1 conv takes the
    staged route where its blocks do (``rows`` None, set with theirs)."""

    def __init__(self, nb_ft: int, k_size: int = 3, dtype: str = "float32"):
        super().__init__()
        self.rows = None
        for i in range(6):
            setattr(self, f"ResBlock_{i}", ResBlock(nb_ft, k_size, dtype))
        self.Conv_0 = Conv(nb_ft, nb_ft, 1, 1, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        trunk = x
        for i in range(3):
            trunk = getattr(self, f"ResBlock_{i}")(trunk)
        attn = x
        for i in range(3, 6):
            attn = getattr(self, f"ResBlock_{i}")(attn)
        if (takes_stage(attn, self.Conv_0, self.rows)
                and attn.shape[1] == self.Conv_0.stage_channels):
            attn = self.Conv_0.staged(attn.to(self.Conv_0.dt))
        else:
            attn = self.Conv_0(attn)
        return trunk * torch.sigmoid(attn) + x


# ---------------------------------------------------------------------------
# YUV420 <-> 444 boundary layers (NCHW)
# ---------------------------------------------------------------------------

def yuv420_to_444(y: torch.Tensor, u: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """y [B, 1, H, W], u/v [B, 1, ceil(H/2), ceil(W/2)] -> [B, 3, H, W]:
    nearest x2 upsampling of U and V, cropped to the Y size."""
    H, W = y.shape[2], y.shape[3]
    uv = torch.cat([u, v], dim=1)
    uv = uv.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    return torch.cat([y, uv[:, :, :H, :W]], dim=1)


def x444_to_yuv420(x: torch.Tensor):
    """[B, 3, H, W] -> (y [B,1,H,W], u, v [B,1,H/2,W/2]); U and V by 2x2
    mean pooling (bilinear x0.5 with align_corners=False)."""
    y = x[:, 0:1]
    B, _, H, W = x.shape
    uv = x[:, 1:3].reshape(B, 2, H // 2, 2, W // 2, 2).mean(dim=(3, 5))
    return y, uv[:, 0:1], uv[:, 1:2]
