"""ElicCodec: ELIC (models/elic.py), an intra-only model, so All-Intra
only.  It holds ELIC's table, steps, stream parts and context loops;
WaveCodec (pipeline/wave.py) the wave plumbing.

  encode_frames_launch: planes to 4:4:4, g_a, h_a, z rounded, h_s, then
      the ten context steps in order (group k's anchors, then its
      non-anchors): each step's nets give mu and sigma over the group's
      map, the step's positions are rounded to round(y - mu), clipped to
      the alphabet, and y_hat = symbol + mu at those positions feeds the
      next step; then g_s, the cast and the DC correction.  Nothing
      reaches the host.
  encode_frames_finish: one K1 launch over the wave: per frame z (its
      channel's factorized-prior row), then the ten steps' symbols (the
      row of their Gaussian sigma bin), each part padded to a multiple of
      K; one dense chunk a frame.
  decode_frames_batch: K2 for z, h_s, then per step the step's nets and
      one K2 launch over the step's symbols, resumed from the previous
      launch's states and word cursor: eleven K2 launches a wave; then
      g_s and the same cast.

The encoder runs every step's nets on the same batch, shapes and inputs
as the decoder (y_hat built from zeros with the same selections), so the
sigma bins and the reconstructions agree bit for bit.  A step's symbols
are its group's channels in order, each over the step's positions in
raster order (``_gather``).

The stream is the dense v1 chunk in the frame's CodecNet-z slot, and
the video header's schedule byte carries ``SCHED_ELIC``: a FrameCodec
refuses an ELIC stream and an ElicCodec an AIVC one.

Spans (tracing.py): WaveCodec's; in ``launch`` also ``launch.upload``,
``launch.planes``, ``launch.nets``, ``launch.ctx`` (a step, with
``group`` and ``pass``); in ``batch`` ``batch.ctx`` (a step, its K2
launch a ``batch.k2`` inside).
"""

from __future__ import annotations

import copy
from typing import Dict, List

import numpy as np
import torch

from aivc_tpu_torch import tracing
from aivc_tpu_torch.coding.cdf import (
    PROB_SCALE,
    build_gaussian_table,
    build_z_table,
    sigma_to_bin,
)
from aivc_tpu_torch.config import FRAME_I, ElicConfig
from aivc_tpu_torch.models.elic import Elic, anchor_mask
from aivc_tpu_torch.pipeline.wave import (
    SCHED_ELIC,
    WaveCodec,
    canonical,
    planes_to_444,
)


class ElicCodec(WaveCodec):
    """Per-resolution All-Intra codec around an Elic model."""

    intra_only = True

    def __init__(self, cfg: ElicConfig, model: Elic, height: int,
                 width: int, device=None, debug: bool = False,
                 entropy_backend: str = "device",
                 rate_priority: bool = False, audit: bool = False,
                 mesh=None):
        if entropy_backend != "device" or debug or audit or mesh is not None:
            raise ValueError("ELIC codes with the device backend alone, "
                             "without debug, audit or a mesh")
        super().__init__(cfg, model, height, width, device, rate_priority)
        prior = copy.deepcopy(model.pdf_z).cpu()
        z = build_z_table(prior, scale=PROB_SCALE, ac_max=self.ac_max)
        gauss = build_gaussian_table(scale=PROB_SCALE, ac_max=self.ac_max)
        self._set_table(np.concatenate([z, gauss], axis=0),
                        {"z": 0, "y": cfg.n})
        # The steps: (group, pass, first channel); per pass the flat
        # indices of its positions on the y grid.
        starts = np.cumsum((0,) + tuple(cfg.groups))[:-1]
        self.steps = [(k, p, int(starts[k])) for k in range(len(cfg.groups))
                      for p in (0, 1)]
        anchors = anchor_mask(self.hy, self.wy, self.device)
        self._mask = (anchors, ~anchors)
        self._pos = tuple(torch.nonzero(m.reshape(-1))[:, 0] for m in
                          self._mask)

    @property
    def sched_bits(self) -> int:
        return SCHED_ELIC | (16 if self.dc_offset else 0)

    # ------------------------------------------------------------------
    # Shared by encoder and decoder
    # ------------------------------------------------------------------
    def _gather(self, x: torch.Tensor, p: int) -> torch.Tensor:
        """[B, C, hy, wy] -> [B, C * n_pos]: channel by channel, the
        positions of pass ``p`` in raster order."""
        B, C = x.shape[:2]
        return x.reshape(B, C, -1).index_select(2, self._pos[p]).reshape(
            B, -1)

    def _scatter(self, v: torch.Tensor, C: int, p: int) -> torch.Tensor:
        """The inverse of ``_gather``: zeros elsewhere."""
        B = v.shape[0]
        n = self._pos[p].numel()
        out = torch.zeros((B, C, self.hy * self.wy), dtype=v.dtype,
                          device=v.device)
        out.index_copy_(2, self._pos[p], v.reshape(B, C, n))
        return out.reshape(B, C, self.hy, self.wy)

    def _step_params(self, k: int, p: int, hyper: torch.Tensor,
                     done: List[torch.Tensor], anchors, cache: Dict):
        """mu and the sigma bins of group k's pass p over its whole map.
        The channel context is computed in the anchor pass and kept in
        ``cache`` for the non-anchor pass; the spatial context is zero in
        the anchor pass."""
        m = self.model
        if p == 0:
            cache["cc"] = m.channel_context(k, done)
            g = self.cfg.groups[k]
            sc = torch.zeros((hyper.shape[0], 2 * g, self.hy, self.wy),
                             dtype=torch.float32, device=hyper.device)
        else:
            sc = m.spatial_context(k, anchors)
        mu, sigma = m.params(k, hyper, cache["cc"], sc)
        return mu, sigma_to_bin(sigma)

    def _n_pad(self, kk: int) -> List[int]:
        """Padded lengths of a frame's parts at K = kk: z, then the ten
        steps."""
        parts = [self.hz * self.wz * self.cfg.n]
        parts += [self.cfg.groups[k] * self._pos[p].numel()
                  for k, p, _ in self.steps]
        return [-(-n // kk) * kk for n in parts]

    def _stream_layout(self, parsed, kk: int, frame_type: int) -> List[int]:
        """A wave's stream at K = kk: its parts' padded lengths."""
        return self._n_pad(kk)

    def _check_intra(self, frame_type: int) -> None:
        if frame_type != FRAME_I:
            raise ValueError(f"{self.cfg.name} is an intra-only model: it "
                             f"codes I-frames (All-Intra) alone")

    # ------------------------------------------------------------------
    # Encode
    # ------------------------------------------------------------------
    def _encode_step(self, k: int, p: int, y: torch.Tensor,
                     hyper: torch.Tensor, done: List[torch.Tensor],
                     cur: torch.Tensor, cache: Dict):
        """One context step of the encode -> (group k's y_hat with this
        pass's positions filled, the pass's symbols and sigma bins
        gathered)."""
        with tracing.span("launch.ctx", group=k, **{"pass": p}):
            mu, bins = self._step_params(k, p, hyper, done, cur, cache)
            q = self._quantize_y(y, mu)
            cur = torch.where(self._mask[p], q + mu, cur)
            return cur, self._gather(q, p), self._gather(bins, p)

    def _encode_transforms(self, frames_u8, prev_refs, next_refs,
                           frame_type: int, idx_rate: float) -> Dict:
        self._check_intra(frame_type)
        m, acv, k = self.model, self.ac_max, len(frames_u8)
        with tracing.span("launch.upload"):
            orig = self._to_device_planes(frames_u8)
        with tracing.span("launch.planes"):
            frame = planes_to_444(**orig)
        with tracing.span("launch.nets"):
            y = m.analyze(frame)
            z = canonical(torch.clamp(torch.round(m.hyper_analyze(y)), -acv,
                                      acv - 1) + 0.0)
            hyper = m.hyper_synthesize(z)
        done: List[torch.Tensor] = []
        steps = []
        cache: Dict = {}
        for kg, p, c0 in self.steps:
            g = self.cfg.groups[kg]
            if p == 0:
                cur = torch.zeros_like(y[:, c0:c0 + g])
            cur, q, bins = self._encode_step(kg, p, y[:, c0:c0 + g], hyper,
                                             done, cur, cache)
            steps.append((q, bins))
            if p == 1:
                done.append(cur)
        with tracing.span("launch.nets"):
            x_hat = m.synthesize(torch.cat(done, dim=1))
        with tracing.span("launch.planes"):
            out, _ = self._cast_planes(x_hat)
            out, dc = self._dc_correct_enc(out, orig)
            decoded = self._split_decoded(out, k)
        return {"k": k, "frame_type": frame_type, "z": z, "steps": steps,
                "dc": dc, "decoded": decoded}

    def _wave_parts(self, w):
        """K from the frame's padded total at K = 8, and the wave's stream
        part by part (z, then the ten steps): (symbols, CDF rows), each
        padded to a multiple of K; all of it codec bytes (column 2), so
        K1 marks no segment inside it."""
        kk = self._pick_k(w["frame_type"], sum(self._n_pad(8)))
        yo = self._row_off["y"]
        parts = [self._z_seg(w["z"], "z", kk)]
        for q, bins in w["steps"]:
            parts.append(self._pad_seg(q.to(torch.int32) + self.ac_max,
                                       bins + yo, kk, self._pad_sym["y"],
                                       yo))
        return kk, parts, [2] * len(parts), None

    # ------------------------------------------------------------------
    # Decode
    # ------------------------------------------------------------------
    def _decode_step(self, k: int, p: int, words, st, g, n: int, kk: int,
                     hyper: torch.Tensor, done: List[torch.Tensor],
                     cur: torch.Tensor, cache: Dict):
        """One context step of the decode: the step's nets, then its K2
        launch -> (group k's y_hat with this pass's positions filled,
        states, word cursor)."""
        with tracing.span("batch.ctx", group=k, **{"pass": p}):
            mu, bins = self._step_params(k, p, hyper, done, cur, cache)
            with tracing.span("batch.k2", K=kk, steps=n // kk):
                yo = self._row_off["y"]
                v, st, g = self._k2_seg(words, st, g,
                                        self._gather(bins, p) + yo, n, kk,
                                        yo)
            q = self._scatter(v, self.cfg.groups[k], p)
            cur = torch.where(self._mask[p], q + mu, cur)
            return cur, st, g

    def _decode_planes(self, chunks, prev_refs, next_refs, frame_type: int,
                       idx_rate: float, backend: str):
        self._check_intra(frame_type)
        if backend != "device":
            raise ValueError("ELIC streams carry device-backend chunks")
        k = len(chunks)
        kk, pads, words, st, g = self._decode_front(chunks, frame_type)
        z, st, g = self._dec_z(words, st, g, pads[0], kk, self.cfg.n, "z")
        with tracing.span("batch.nets"):
            hyper = self.model.hyper_synthesize(z)
        done: List[torch.Tensor] = []
        cache: Dict = {}
        for (kg, p, _), n in zip(self.steps, pads[1:]):
            if p == 0:
                cur = torch.zeros((k, self.cfg.groups[kg], self.hy, self.wy),
                                  dtype=torch.float32, device=self.device)
            cur, st, g = self._decode_step(kg, p, words, st, g, n, kk, hyper,
                                           done, cur, cache)
            if p == 1:
                done.append(cur)
        with tracing.span("batch.nets"):
            x_hat = self.model.synthesize(torch.cat(done, dim=1))
            return self._cast_planes(x_hat)[0]
