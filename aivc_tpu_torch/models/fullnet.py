"""FullNet: MOFNet + motion compensation + CodecNet, NCHW: the RD
forward ``forward_frame`` (eval and training) and the stage methods of
the coding pipeline (aivc_tpu/models/fullnet.py:45-91,139-199 and the
stage methods).

Maps are channel-major [B, 6, H, W] planes (alpha, beta, u_prev, v_prev,
u_next, v_next), which is what the JAX package's ``maps_cm`` schedule
computes: the port's pixel shuffle already yields that layout.

  P/B:  x_warp = beta * warp(prev, v_prev) + (1 - beta) * warp(next, v_next)
        pred = alpha * x_warp;  skip = (1 - alpha) * x_warp
        (P-frames: beta = 1, v_next = 0)
  I:    pred = skip = 0

Row bands (``split_rows``, a parallel/halo.py:RowBand, set by the codec
and the trainer over a mesh's 'spatial' axis): the tensors every rank
holds whole (the frame, the references, the whole latents and mu) go in
whole and are cut to this rank's band here, with no scatter (the first
conv of a split stage takes its halo rows through the exchange, as every
conv there does: CodecNet's inputs hold pred, which only the band has);
the nets of the split stages run on the band (models/conditional.py),
the warps read the whole references at the band's rows (``row0``), and
what comes out (x_hat, maps, pred, skip) is this band's.
"""

from __future__ import annotations

import torch
from torch import nn

from aivc_tpu_torch.config import FRAME_B, FRAME_I, FRAME_P, ModelConfig
from aivc_tpu_torch.models.conditional import ConditionalNet
from aivc_tpu_torch.ops import ties
from aivc_tpu_torch.ops.warp import (
    mc_warp,
    motion_compensation,
    pack_yuv_u32,
    warp,
)


def _motion_comp(prev, nxt, v_prev, v_next, beta, frame_type: int,
                 row0: int = 0):
    """P-frames warp only the previous reference (beta = 1, v_next = 0);
    B-frames blend both (fullnet.py:45-52).  The flows move the output
    rows from ``row0``."""
    if frame_type == FRAME_P:
        return warp(prev, v_prev, row0)
    return motion_compensation(prev, nxt, v_prev, v_next, beta, row0)


def mofnet_maps(m: torch.Tensor, frame_type: int,
                flow_bound: float = 0.0) -> torch.Tensor:
    """MOFNet synthesis output [B, 6, H, W] -> processed maps.

    flow_bound > 0: sigmoid(4x) masks and the softsign flow bound
    v = raw / (1 + |raw| / bound); otherwise the reference's
    clip(x + 0.5, 0, 1) masks and raw flows.  P-frames force beta = 1 and
    v_next = 0."""
    if flow_bound > 0.0:
        alpha = torch.sigmoid(4.0 * m[:, 0:1])
        beta = torch.sigmoid(4.0 * m[:, 1:2])
        b = torch.tensor(flow_bound, dtype=m.dtype, device=m.device)
        v_prev = m[:, 2:4]
        v_next = m[:, 4:6]
        v_prev = v_prev / (1.0 + torch.abs(v_prev) / b)
        v_next = v_next / (1.0 + torch.abs(v_next) / b)
    else:
        alpha = ties.clip(m[:, 0:1] + 0.5, 0.0, 1.0)
        beta = ties.clip(m[:, 1:2] + 0.5, 0.0, 1.0)
        v_prev = m[:, 2:4]
        v_next = m[:, 4:6]
    if frame_type == FRAME_P:
        beta = torch.ones_like(beta)
        v_next = torch.zeros_like(v_next)
    return torch.cat([alpha, beta, v_prev, v_next], dim=1)


class FullNet(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.mofnet = ConditionalNet(cfg.mofnet, gain_i=False)
        self.codecnet = ConditionalNet(cfg.codecnet)
        self.band = None

    def split_rows(self, band) -> None:
        """Run the full-resolution and y-level stages of both nets on the
        row band ``band`` (a RowBand; None: the whole frame)."""
        self.band = band
        self.mofnet.split_rows(band)
        self.codecnet.split_rows(band)

    def _rows(self, x: torch.Tensor) -> torch.Tensor:
        """This band's rows of a tensor every rank holds whole."""
        return x if self.band is None else self.band.rows(x)

    def _row0(self, h: int) -> int:
        return 0 if self.band is None else self.band.row0(h)

    def forward_frame(self, frame, prev, nxt, idx_rate: float,
                      frame_type: int, training: bool = False, noise=None):
        """Code one padded 4:4:4 frame [B, 3, H, W] given (possibly zero)
        references, float warp included (fullnet.py:139-199).  In
        training the latents carry noise from the noise source ``noise``
        (ops/quantizer.py), MOFNet's drawn before CodecNet's.

        Returns (x_hat, aux) with JAX's aux keys: ``mof`` and ``cod`` (the
        latents of ConditionalNet.encode_latents; ``mof`` is None for an
        I-frame), ``alpha``, ``beta``, ``x_warp`` and, for P/B frames,
        ``v_prev``, ``v_next`` and ``flow_raw`` (the MOFNet output before
        the maps).  Under a row band, this band's x_hat and aux maps;
        ``cod`` and ``mof`` as ConditionalNet.encode_latents gives
        them."""
        whole_prev, whole_next = prev, nxt
        frame, prev, nxt = self._rows(frame), self._rows(prev), self._rows(nxt)
        B, _, H, W = frame.shape
        aux = {}
        if frame_type == FRAME_I:
            alpha = torch.ones((B, 1, H, W), dtype=frame.dtype,
                               device=frame.device)
            x_warp = torch.zeros_like(frame)
            skip = torch.zeros_like(frame)
            pred = torch.zeros_like(frame)
            aux["mof"] = None
        else:
            shortcut = (torch.cat([prev, nxt], dim=1)
                        if frame_type == FRAME_B else None)
            out6, mof_lat = self.mofnet(torch.cat([frame, prev, nxt], dim=1),
                                        shortcut, idx_rate, frame_type,
                                        training, noise)
            maps = mofnet_maps(out6, frame_type, self.cfg.flow_bound)
            alpha, beta = maps[:, 0:1], maps[:, 1:2]
            v_prev, v_next = maps[:, 2:4], maps[:, 4:6]
            x_warp = _motion_comp(whole_prev, whole_next, v_prev, v_next,
                                  beta, frame_type, self._row0(H))
            skip = (1.0 - alpha) * x_warp
            pred = alpha * x_warp
            aux.update(mof=mof_lat, beta=beta, v_prev=v_prev, v_next=v_next,
                       flow_raw=out6)
        cod_out, cod_lat = self.codecnet(
            torch.cat([frame, pred], dim=1),
            pred if frame_type != FRAME_I else None, idx_rate, frame_type,
            training, noise)
        aux.update(cod=cod_lat, alpha=alpha, x_warp=x_warp)
        if frame_type == FRAME_I:
            aux["beta"] = torch.ones_like(alpha)
        return cod_out + skip, aux

    def mof_analyze(self, frame, prev, nxt, idx_rate: float,
                    frame_type: int):
        return self.mofnet.analyze(
            self._rows(torch.cat([frame, prev, nxt], dim=1)), idx_rate,
            frame_type)

    def cod_analyze(self, frame, pred, idx_rate: float, frame_type: int):
        """``pred`` is this band's."""
        return self.codecnet.analyze(torch.cat([self._rows(frame), pred],
                                               dim=1), idx_rate, frame_type)

    def mofnet_hyper(self, z_q):
        return self.mofnet.hyper_decode(z_q)

    def codecnet_hyper(self, z_q):
        return self.codecnet.hyper_decode(z_q)

    def mofnet_synth_maps(self, y_cq, mu, prev, nxt, idx_rate: float,
                          frame_type: int) -> torch.Tensor:
        """MOFNet synthesis -> maps [B, 6, H, W] (no warp); of this band
        from the whole y_cq, mu and references."""
        shortcut = (self._rows(torch.cat([prev, nxt], dim=1))
                    if frame_type == FRAME_B else None)
        out = self.mofnet.synthesize(self._rows(y_cq), self._rows(mu),
                                     shortcut, idx_rate, frame_type)
        return mofnet_maps(out, frame_type, self.cfg.flow_bound)

    def motion_comp_stage(self, prev, nxt, maps6, frame_type: int,
                          warp_engine: str = "packed"):
        """Warp + blend -> pred, skip and the masks alpha, beta (of the
        band of ``maps6``, from the whole references)."""
        alpha = maps6[:, 0:1]
        beta = maps6[:, 1:2]
        row0 = self._row0(maps6.shape[2])
        pw = mc_warp(pack_yuv_u32(prev), maps6[:, 2], maps6[:, 3],
                     warp_engine, row0)
        if frame_type == FRAME_P:
            x_warp = pw
        else:
            nw = mc_warp(pack_yuv_u32(nxt), maps6[:, 4], maps6[:, 5],
                         warp_engine, row0)
            x_warp = beta * pw + (1.0 - beta) * nw
        x_warp = x_warp.to(prev.dtype)
        return {"pred": alpha * x_warp, "skip": (1.0 - alpha) * x_warp,
                "alpha": alpha, "beta": beta}

    def codecnet_synth(self, y_cq, mu, pred, skip, idx_rate: float,
                       frame_type: int):
        """The whole y_cq and mu; this band's pred and skip."""
        shortcut = pred if frame_type != FRAME_I else None
        out = self.codecnet.synthesize(self._rows(y_cq), self._rows(mu),
                                       shortcut, idx_rate, frame_type)
        return out + skip
