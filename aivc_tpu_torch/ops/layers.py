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
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

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


def split_rows(module: nn.Module, rows) -> None:
    """Run every ConvBlock and UpBlock of ``module`` on the row band
    ``rows`` (a RowBand; None: the whole frame)."""
    for m in module.modules():
        if isinstance(m, (ConvBlock, UpBlock)):
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dt
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                        stride=self.stride, padding=self.padding)


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
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
        _attach_nl(self, non_linearity, out_ft)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
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
    the attention branch (flax creation order)."""

    def __init__(self, nb_ft: int, k_size: int = 3, dtype: str = "float32"):
        super().__init__()
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
        attn = torch.sigmoid(self.Conv_0(attn))
        return trunk * attn + x


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
