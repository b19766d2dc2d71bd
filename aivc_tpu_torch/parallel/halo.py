"""Row bands over a mesh's 'spatial' axis: the halo exchange a conv of a
band needs, and the gather of the bands into the whole frame, both
differentiable (what JAX's GSPMD inserts by itself for
P('data', 'spatial', None, None)).

A ``RowBand`` is this rank's band of every row-split tensor: the bands
are equal and in rank order, so of a tensor whose whole frame has R rows
a band holds rows index * R / S .. (index + 1) * R / S - 1 (S the axis's
size).  ``exchange_rows(x, pad, band)`` returns
[pad rows of the band above | x | pad rows of the band below], the edge
row replicated at the frame's top and bottom, as ``replication_pad`` of
the whole frame has them; its backward sends the gradient of each halo
row back to the band that owns the row and adds it there.
``gather_rows`` concatenates every band; its backward sums the incoming
gradients over the ranks and keeps this band's rows (a reduce-scatter):
where every rank computes the same loss on the gathered tensor, each
rank's loss must be its share (the whole divided by S), so that the
shares sum to the whole loss.

Each call is one all-gather over the rank's 'spatial' group (under gloo
through host copies), so every rank of a line must make the same calls
in the same order.  An exchange is a ``halo.exchange`` span, a gather a
``halo.gather`` span (tracing.py), forward and backward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from aivc_tpu_torch import tracing
from aivc_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather_cat,
    all_reduce,
    row_band,
)


class RowBand:
    """This rank's band of rows of a mesh's 'spatial' axis."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.index = mesh.spatial_index
        self.size = mesh.spatial_size

    def rows(self, x: torch.Tensor, dim: int = 2) -> torch.Tensor:
        """This band's rows of a whole tensor every rank holds, in a
        fresh buffer (no exchange)."""
        return row_band(self.mesh, x, dim).contiguous()

    def row0(self, h: int) -> int:
        """The whole frame's row of this band's first, for bands of h."""
        return self.index * h

    def gather(self, x: torch.Tensor, dim: int = 2) -> torch.Tensor:
        return gather_rows(x, self, dim)

    def pad(self, x: torch.Tensor, pad: int) -> torch.Tensor:
        """Replication padding of a band [B, C, h, W] as the whole
        frame's: the rows through the exchange, the columns here."""
        if pad == 0:
            return x
        return F.pad(exchange_rows(x, pad, self), (pad, pad, 0, 0),
                     mode="replicate")

    def __repr__(self) -> str:
        return f"RowBand({self.index} of {self.size})"


def _gather_parts(band: RowBand, x: torch.Tensor):
    """Every band's ``x`` along the rows (dim 2), split back per rank."""
    whole = all_gather_cat(band.mesh, [x], 2, axis="spatial")[0]
    return whole.split(x.shape[2], dim=2)


class _ExchangeRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, pad: int, band: RowBand):
        h = x.shape[2]
        if pad > h:
            raise ValueError(f"a halo of {pad} rows needs at least {pad} "
                             f"rows a band, got {h}")
        ctx.pad, ctx.band, ctx.h = pad, band, h
        with tracing.span("halo.exchange"):
            parts = _gather_parts(band, torch.cat(
                [x[:, :, :pad], x[:, :, h - pad:]], dim=2))
            i, s = band.index, band.size
            top = (parts[i - 1][:, :, pad:] if i > 0
                   else x[:, :, :1].expand(-1, -1, pad, -1))
            bot = (parts[i + 1][:, :, :pad] if i < s - 1
                   else x[:, :, h - 1:].expand(-1, -1, pad, -1))
            return torch.cat([top, x, bot], dim=2)

    @staticmethod
    def backward(ctx, g):
        pad, band, h = ctx.pad, ctx.band, ctx.h
        with tracing.span("halo.exchange"):
            g_top, g_bot = g[:, :, :pad], g[:, :, pad + h:]
            parts = _gather_parts(band, torch.cat([g_top, g_bot], dim=2))
            i, s = band.index, band.size
            gx = g[:, :, pad:pad + h].clone()
            # This band's first rows were the halo below the band above,
            # its last rows the halo above the band below.
            if i > 0:
                gx[:, :, :pad] += parts[i - 1][:, :, pad:]
            else:
                gx[:, :, :1] += g_top.sum(dim=2, keepdim=True)
            if i < s - 1:
                gx[:, :, h - pad:] += parts[i + 1][:, :, :pad]
            else:
                gx[:, :, h - 1:] += g_bot.sum(dim=2, keepdim=True)
            return gx, None, None


def exchange_rows(x: torch.Tensor, pad: int, band: RowBand) -> torch.Tensor:
    """[pad rows from the band above | x | pad rows from the band below]
    of a band x [B, C, h, W] (h >= pad); the frame's edge row replicated
    at its top and bottom."""
    return _ExchangeRows.apply(x, pad, band)


class _GatherRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, band: RowBand, dim: int):
        ctx.band, ctx.dim, ctx.h = band, dim, x.shape[dim]
        with tracing.span("halo.gather"):
            return all_gather_cat(band.mesh, [x], dim, axis="spatial")[0]

    @staticmethod
    def backward(ctx, g):
        band = ctx.band
        with tracing.span("halo.gather"):
            g = all_reduce(band.mesh, g.contiguous(), "sum", axis="spatial")
            gx = g.narrow(ctx.dim, band.index * ctx.h, ctx.h).contiguous()
        return gx, None, None


def gather_rows(x: torch.Tensor, band: RowBand, dim: int = 2
                ) -> torch.Tensor:
    """Every band of ``x`` concatenated along ``dim``, on every rank;
    its gradient is the sum of the ranks' gradients, this band's rows."""
    return _GatherRows.apply(x, band, dim)


class BandNoise:
    """A noise source (ops/quantizer.py) for a band: it asks ``noise``
    for the whole latent's draw and keeps this band's rows, so that a
    band's noise is what one process draws for those rows."""

    def __init__(self, noise, band: RowBand):
        self.noise, self.band = noise, band

    def uniform(self, like: torch.Tensor) -> torch.Tensor:
        shape = list(like.shape)
        shape[2] *= self.band.size
        full = torch.empty(shape, device=like.device)
        return self.band.rows(self.noise.uniform(full))
