"""FrameCodec: AIVC's frame codec (counterpart of
aivc_tpu/pipeline/codec.py), with both entropy backends.  It holds what
is AIVC's: the FullNet's stages, the mesh, the v1 / v2 fused streams,
the host backend, debug and audit; WaveCodec (pipeline/wave.py) the
wave plumbing.  ``make_codec`` picks the codec of a loaded model.

  encode: to444 -> [P/B] mof_analyze -> mof_hyper -> quantize -> mof_synth
          -> warp -> cod_analyze -> cod_hyper -> quantize -> cod_synth
          -> cast + DC correction -> entropy coding:
            device backend: one fused rANS stream per frame (K1);
            host backend:   the latents pulled to the host, four chunks a
                            frame coded by the host range coder
                            (coding/range_coder.py) in a pool of threads
  decode: the entropy decode interleaved with the hyper and synthesis
          stages (K2 on the device backend, the host range coder on the
          host backend), then the same cast.  The video header says which
          backend wrote a stream, so either codec decodes either format.

Options, as in JAX: ``debug`` (per-chunk lossless self-check with [AC]
lines, and the in-band latent md5 trailer, checked at decode),
``audit`` (per-frame analytic bits under the coder's own CDFs),
``rate_priority`` (more rANS steps, fewer streams: the per-frame state
flush stays ~1% of the payload) and ``mesh`` (parallel/mesh.py: each
rank runs the nets on its slice of a wave over 'data' and on its band of
rows over 'spatial', encoder and decoder alike, and entropy-codes the
whole wave, so every rank holds the same bytes and references).

Under 'spatial' > 1 the full-resolution and y-level stages run on this
rank's band of rows, their convs' halos exchanged (parallel/halo.py);
y is gathered over 'spatial' for the hyper stages, which run whole on
every rank (so do the quantization of y and the sigma bins); the warps
read the whole references at the band's rows (K3's row window); the
uint8 planes and the alpha / beta maps are gathered into whole frames,
from which the DC trailer, the mask means and the references are
computed, so they equal one process's.

Spans (tracing.py): WaveCodec's, with ``launch.upload``,
``launch.mofnet``, ``launch.warp``, ``launch.codecnet``,
``launch.planes`` in ``launch``; ``pool``.

Format: v2 fused streams with all-zero y channels elided
(codec.py:665-990,1221-1300), or under AIVC_VRANS_ELIDE=0 the dense v1
fused stream (codec.py:243-248, 357-367, 1184-1200); host-backend chunks
with the same elision (coding/bitstream.py); the per-frame DC trailer
(codec.py:494-541); the schedule byte of the video header, from the
five switches JAX reads at construction (wave.py:SCHED_SWITCHES).  The
DC plane sums are int64 (the JAX sums are int32, which agree below ~8.4M
luma pixels).
"""

from __future__ import annotations

import copy
import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np
import torch

from aivc_tpu_torch import tracing
from aivc_tpu_torch.coding import bitstream as bs
from aivc_tpu_torch.coding import vrans
from aivc_tpu_torch.coding.cdf import (
    PROB_SCALE,
    build_laplace_table,
    build_z_table,
    expected_bits,
    sigma_to_bin,
)
from aivc_tpu_torch.config import FRAME_I, ElicConfig, ModelConfig
from aivc_tpu_torch.models.fullnet import FullNet
from aivc_tpu_torch.ops.warp import warp_engine
from aivc_tpu_torch.parallel.halo import RowBand
from aivc_tpu_torch.parallel.mesh import (
    all_gather_cat,
    batch_slice,
    check_mesh,
    check_rows,
    shard_params,
)
from aivc_tpu_torch.pipeline.elic import ElicCodec
from aivc_tpu_torch.pipeline.wave import (
    WaveCodec,
    canonical,
    planes_to_444,
    switch_on,
)


def head_lane_pack_auto(out_ft: int) -> int:
    """The JAX package's lane-pack group of a synthesis head
    (aivc_tpu/ops/layers.py:head_lane_pack_auto): the largest power of two
    G with G * 4 * out_ft <= 128."""
    g = 1
    while 2 * g * 4 * out_ft <= 128:
        g *= 2
    return g


def scheduled_config(cfg: ModelConfig) -> ModelConfig:
    """``cfg`` with the schedule switches applied as the JAX package's
    FrameCodec applies them: a switch that is on sets its fields, one that
    is off leaves the checkpoint's own values."""
    rp = dataclasses.replace
    m, c = cfg.mofnet, cfg.codecnet
    if switch_on("AIVC_PACKED_HEAD"):
        m = rp(m, head_lane_pack=head_lane_pack_auto(m.out_c))
        c = rp(c, head_lane_pack=head_lane_pack_auto(c.out_c))
    if switch_on("AIVC_GDN_LOWP"):
        m, c = rp(m, gdn_lowp=True), rp(c, gdn_lowp=True)
    if switch_on("AIVC_MAPS_CM"):
        m = rp(m, maps_cm=True)
    if switch_on("AIVC_S2D"):
        m, c = rp(m, s2d_analysis=True), rp(c, s2d_analysis=True)
    return rp(cfg, mofnet=m, codecnet=c)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    """An integer-valued NCHW latent (or sigma bins) -> host int32
    [B, H, W, C], the JAX package's layout of the chunks and digests."""
    return t.to(torch.int32).permute(0, 2, 3, 1).contiguous().cpu().numpy()


def _par_map(fn, items):
    """Map over a wave's chunks in threads (the host range coder releases
    the GIL); sequential for a single item."""
    with tracing.span("pool"):
        if len(items) <= 1:
            return [fn(it) for it in items]
        with ThreadPoolExecutor(max_workers=min(4, len(items))) as ex:
            return list(ex.map(fn, items))


def _part(x: torch.Tensor, sl: slice) -> torch.Tensor:
    """This rank's slice of a wave's tensor, in a fresh buffer as the
    encoder's own slice was (``x`` itself where the slice is all)."""
    return x if sl == slice(None) else canonical(x[sl])


class FrameCodec(WaveCodec):
    """Per-resolution codec around a FullNet."""

    def __init__(self, cfg: ModelConfig, model: FullNet, height: int,
                 width: int, device=None, debug: bool = False,
                 entropy_backend: str = "device",
                 rate_priority: bool = False, audit: bool = False,
                 mesh=None):
        if entropy_backend not in ("device", "host"):
            raise ValueError(f"unknown entropy backend {entropy_backend!r}")
        # The backend used to ENCODE; decoding follows the stream's header.
        self.backend = entropy_backend
        self.debug = debug
        self.audit = audit
        # The schedule switches, read once here, as in JAX.
        cfg = scheduled_config(cfg)
        net = FullNet(cfg)
        net.load_state_dict(model.state_dict())
        super().__init__(cfg, net, height, width, device, rate_priority)
        # The device backend writes the v2 fused stream with all-zero y
        # channels elided, or under AIVC_VRANS_ELIDE=0 the dense v1 one.
        self.elide = (entropy_backend == "device"
                      and switch_on("AIVC_VRANS_ELIDE"))
        # Optional ('data', 'spatial') mesh (parallel/mesh.py): the nets of
        # a wave run on this rank's slice of it where 'data' divides the
        # wave, and on this rank's band of rows over 'spatial'; entropy
        # coding runs on the whole wave on every rank.  The parameters are
        # replicated from the first rank.
        self.mesh = mesh
        self.band = None
        if mesh is not None:
            check_mesh(mesh, "FrameCodec")
            check_rows(mesh, self.hp, max(cfg.mofnet.k_size,
                                          cfg.codecnet.k_size) // 2,
                       "FrameCodec")
            shard_params(self.model, mesh)
            if mesh.spatial_size > 1:
                self.band = RowBand(mesh)
                self.model.split_rows(self.band)

        self.warp_engine = warp_engine(cfg.flow_bound)

        # Fused row space [mofnet-z channels | codecnet-z channels | y
        # sigma bins] (codec.py:311-348).  The z rows are built from the
        # prior on the host, so they do not depend on the device.
        lap = build_laplace_table(scale=vrans.PROB_SCALE, ac_max=self.ac_max)
        z = {}
        for which in ("mofnet", "codecnet"):
            prior = copy.deepcopy(getattr(self.model, which).pdf_z).cpu()
            z[which] = build_z_table(prior, scale=PROB_SCALE,
                                     ac_max=self.ac_max)
        fused = np.concatenate([z["mofnet"], z["codecnet"], lap], axis=0)
        # The host backend codes at the same 2^16 scale: its rows are the
        # fused table's.
        self.z_rows = z
        self.laplace_rows = lap
        czm, czc = cfg.mofnet.nb_ft_z, cfg.codecnet.nb_ft_z
        self._set_table(fused, {"z_m": 0, "z_c": czm, "y": czm + czc})

    # ------------------------------------------------------------------
    # References and the mesh's gathers
    # ------------------------------------------------------------------
    def _zero_ref(self) -> torch.Tensor:
        return torch.zeros((1, 3, self.hp, self.wp), dtype=torch.float32,
                           device=self.device)

    def _stack_refs(self, refs) -> torch.Tensor:
        arrs = [r if r is not None else self._zero_ref() for r in refs]
        return torch.cat(arrs, dim=0).contiguous()

    def _whole_rows(self, ts: List[torch.Tensor]) -> List[torch.Tensor]:
        """Of a row band, every rank's bands in one collective."""
        if self.band is None:
            return ts
        return all_gather_cat(self.mesh, ts, 2, axis="spatial")

    # ------------------------------------------------------------------
    # Fused stream segments
    # ------------------------------------------------------------------
    def _fused_n(self, frame_type: int, k: int):
        """(total padded symbols, per-segment padded lengths) of a frame's
        dense (v1) fused stream at stream count k: every y channel kept."""
        return self._fused_n2(frame_type, k, self.cfg.mofnet.nb_ft_y,
                              self.cfg.codecnet.nb_ft_y)

    def _fused_n2(self, frame_type: int, k: int, bm: int, bc: int):
        """(total padded symbols, per-segment padded lengths) of a frame's
        elided fused stream at stream count k."""
        nz, hw = self.hz * self.wz, self.hy * self.wy
        n = [self.cfg.codecnet.nb_ft_z * nz, bc * hw]
        if frame_type != FRAME_I:
            n = [self.cfg.mofnet.nb_ft_z * nz, bm * hw] + n
        segs = tuple(-(-s // k) * k for s in n if s)
        return sum(segs), segs

    def _y_slots(self, idx: torch.Tensor, nkeep: torch.Tensor, hw: int):
        """[B, bucket * hw] mask of the slots of kept channels."""
        bucket = idx.shape[1]
        pos_ch = torch.arange(bucket * hw, device=self.device) // hw
        return pos_ch[None, :] < nkeep[:, None]

    def _gather_ch(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """x [B, C, H, W] -> kept channels, channel-major [B, bucket*H*W]."""
        B, C, H, W = x.shape
        g = torch.gather(x.reshape(B, C, H * W), 1,
                         idx.long()[:, :, None].expand(-1, -1, H * W))
        return g.reshape(B, -1)

    def _y_seg(self, q, bins, k: int):
        """Dense (v1) y segment: every symbol in the JAX (H, W, C) order,
        its row from the sigma bin."""
        B = q.shape[0]
        sym = (q.permute(0, 2, 3, 1).reshape(B, -1).to(torch.int32)
               + self.ac_max)
        rows = (bins.permute(0, 2, 3, 1).reshape(B, -1).to(torch.int32)
                + self._row_off["y"])
        return self._pad_seg(sym, rows, k, self._pad_sym["y"],
                             self._row_off["y"])

    def _y_seg_el(self, q, bins, idx, nkeep, k: int):
        """Elided y segment: channel-major symbols of the kept channels;
        slots beyond a frame's nkeep carry the pad symbol."""
        hw = q.shape[2] * q.shape[3]
        valid = self._y_slots(idx, nkeep, hw)
        sym = self._gather_ch(q, idx).to(torch.int32) + self.ac_max
        rows = self._gather_ch(bins, idx).to(torch.int32) + self._row_off["y"]
        sym = torch.where(valid, sym, self._pad_sym["y"])
        rows = torch.where(valid, rows, self._row_off["y"])
        return self._pad_seg(sym, rows, k, self._pad_sym["y"],
                             self._row_off["y"])

    def _pack_idx(self, chans: List[np.ndarray], bucket: int):
        k = len(chans)
        idx = np.zeros((k, max(bucket, 1)), np.int32)
        nk = np.zeros((k,), np.int32)
        for i, ch in enumerate(chans):
            nk[i] = ch.size
            idx[i, :ch.size] = ch
        return (torch.from_numpy(idx).to(self.device),
                torch.from_numpy(nk).to(self.device))

    # ------------------------------------------------------------------
    # Encode
    # ------------------------------------------------------------------
    def _hyper(self, which: str, z_q):
        mu, sigma = getattr(self.model, f"{which}_hyper")(z_q)
        return mu, sigma_to_bin(sigma)

    # The tensors a wave's nets hand to entropy coding and to the
    # reconstruction, gathered in this order under a mesh.
    WAVE_KEYS = ("z_m", "q_m", "bins_m", "alpha_mean", "beta_mean", "z_c",
                 "q_c", "bins_c", "dc", "y", "u", "v")

    def _encode_nets(self, frames_u8, prev_refs, next_refs, frame_type: int,
                     idx_rate: float) -> Dict:
        """The nets of an encode on a batch of frames: the quantized
        latents (NCHW float, integer values), their sigma bins, the motion
        stats and the DC-corrected uint8 planes (``WAVE_KEYS``; None
        where a frame type or the schedule has none)."""
        m = self.model
        acv = self.ac_max
        with tracing.span("launch.upload"):
            orig = self._to_device_planes(frames_u8)
        with tracing.span("launch.planes"):
            frame = planes_to_444(**orig)
        with tracing.span("launch.upload"):
            prev = self._stack_refs(prev_refs)
            nxt = self._stack_refs(next_refs)

        t = dict.fromkeys(self.WAVE_KEYS)
        maps = ()
        if frame_type == FRAME_I:
            pred = skip = torch.zeros_like(m._rows(frame))
        else:
            with tracing.span("launch.mofnet"):
                y_m, z_qm = m.mof_analyze(frame, prev, nxt, idx_rate,
                                          frame_type)
                z_qm = canonical(torch.clamp(z_qm, -acv, acv - 1))
                mu_m, bins_m = self._hyper("mofnet", z_qm)
                q_m = canonical(self._quantize_y(y_m, mu_m))
                maps6 = m.mofnet_synth_maps(q_m, mu_m, prev, nxt, idx_rate,
                                            frame_type)
            with tracing.span("launch.warp"):
                mof = m.motion_comp_stage(prev, nxt, maps6, frame_type,
                                          self.warp_engine)
            pred, skip = mof["pred"], mof["skip"]
            maps = (mof["alpha"], mof["beta"])
            t.update(z_m=z_qm, q_m=q_m, bins_m=bins_m)

        with tracing.span("launch.codecnet"):
            y_c, z_qc = m.cod_analyze(frame, pred, idx_rate, frame_type)
            z_qc = canonical(torch.clamp(z_qc, -acv, acv - 1))
            mu_c, bins_c = self._hyper("codecnet", z_qc)
            q_c = canonical(self._quantize_y(y_c, mu_c))
            x_hat = m.codecnet_synth(q_c, mu_c, pred, skip, idx_rate,
                                     frame_type)
        with tracing.span("launch.planes"):
            out, maps = self._cast_planes(x_hat, maps)
            if maps:
                # On contiguous whole-frame masks, gathered or not, so a
                # mesh takes the means one process takes.
                t["alpha_mean"], t["beta_mean"] = (
                    a.contiguous().mean(dim=(1, 2, 3)) for a in maps)
            out, t["dc"] = self._dc_correct_enc(out, orig)
        t.update(z_c=z_qc, q_c=q_c, bins_c=bins_c, **out)
        return t

    def _encode_transforms(self, frames_u8, prev_refs, next_refs,
                           frame_type: int, idx_rate: float) -> Dict:
        """The device half of a wave's encode: ``_encode_nets`` on the
        whole wave, or under a mesh on this rank's slice of it with the
        slices gathered from every rank; then the references from the
        planes of the whole wave."""
        k = len(frames_u8)
        sl = batch_slice(self.mesh, k)
        t = self._encode_nets(frames_u8[sl], prev_refs[sl], next_refs[sl],
                              frame_type, idx_rate)
        if sl != slice(None):
            t = dict(zip(self.WAVE_KEYS, all_gather_cat(
                self.mesh, [t[key] for key in self.WAVE_KEYS])))
        out = {c: t.pop(c) for c in ("y", "u", "v")}
        with tracing.span("launch.planes"):
            t["decoded"] = self._split_decoded(out, k)
        t.update(k=k, frame_type=frame_type)
        return t

    def _code_wave(self, w):
        """Entropy coding on the backend this codec encodes with, and
        under ``audit`` each frame's analytic bits."""
        if self.backend == "device":
            frame_bytes, stats = self._entropy_device(w)
        else:
            frame_bytes, stats = self._entropy_host(w)
        if self.audit:
            for s, bits in zip(stats, self._analytic_bits(w).tolist()):
                s["analytic_bits"] = bits
        return frame_bytes, stats

    def _base_stats(self, w) -> List[Dict]:
        """Each frame's alpha / beta mask means (P / B frames)."""
        if w["alpha_mean"] is None:
            return super()._base_stats(w)
        with tracing.span("finish.pull"):
            a = w["alpha_mean"].cpu().numpy()
        with tracing.span("finish.pull"):
            b = w["beta_mean"].cpu().numpy()
        return [{"alpha_mean": float(a[i]), "beta_mean": float(b[i])}
                for i in range(w["k"])]

    def _fused_parts_v2(self, w):
        """(K, segments, their (z_m, y_m, z_c, y_c) columns, per-frame
        channel bitmaps) of a wave's elided stream."""
        k, frame_type = w["k"], w["frame_type"]
        q_m, q_c = w["q_m"], w["q_c"]
        cm, cc = self.cfg.mofnet.nb_ft_y, self.cfg.codecnet.nb_ft_y
        with tracing.span("finish.pull"):
            mask_c = (q_c != 0).any(dim=3).any(dim=2).cpu().numpy()
        mask_m = None
        if frame_type != FRAME_I:
            with tracing.span("finish.pull"):
                mask_m = (q_m != 0).any(dim=3).any(dim=2).cpu().numpy()
        bc = vrans.elide_bucket(int(mask_c.sum(axis=1).max()), cc)
        bm = (0 if mask_m is None else
              vrans.elide_bucket(int(mask_m.sum(axis=1).max()), cm))
        ch_c = [np.nonzero(mask_c[i])[0] for i in range(k)]
        idxc, nkc = self._pack_idx(ch_c, bc)
        bitmaps = []
        for i in range(k):
            per = []
            if mask_m is not None:
                per.append(vrans.chan_bitmap(mask_m[i]))
            per.append(vrans.chan_bitmap(mask_c[i]))
            bitmaps.append(per)

        n8, _ = self._fused_n2(frame_type, 8, bm, bc)
        kk = self._pick_k(frame_type, n8)
        parts, cols = [], []
        if frame_type != FRAME_I:
            parts.append(self._z_seg(w["z_m"], "z_m", kk))
            cols.append(0)
            if bm:
                ch_m = [np.nonzero(mask_m[i])[0] for i in range(k)]
                idxm, nkm = self._pack_idx(ch_m, bm)
                parts.append(self._y_seg_el(q_m, w["bins_m"], idxm, nkm,
                                            kk))
                cols.append(1)
        parts.append(self._z_seg(w["z_c"], "z_c", kk))
        cols.append(2)
        if bc:
            parts.append(self._y_seg_el(q_c, w["bins_c"], idxc, nkc, kk))
            cols.append(3)
        return kk, parts, cols, bitmaps

    def _wave_parts(self, w):
        """The v2 stream's parts or, without elision, the dense stream's:
        K from the dense total (codec.py:1190-1192), every segment
        present, no bitmaps."""
        if self.elide:
            return self._fused_parts_v2(w)
        frame_type = w["frame_type"]
        kk = self._pick_k(frame_type, self._fused_n(frame_type, 8)[0])
        parts = []
        if frame_type != FRAME_I:
            parts += [self._z_seg(w["z_m"], "z_m", kk),
                      self._y_seg(w["q_m"], w["bins_m"], kk)]
        parts += [self._z_seg(w["z_c"], "z_c", kk),
                  self._y_seg(w["q_c"], w["bins_c"], kk)]
        cols = [2, 3] if frame_type == FRAME_I else [0, 1, 2, 3]
        return kk, parts, cols, None

    def _frame_chunks(self, w, kk: int, states, words, bitmaps, sym, rows):
        """v2 chunks with each frame's channel bitmaps, or v1 chunks; under
        ``debug`` each chunk decoded again against its symbols, and the
        latents' digests -> (chunks, digests | None)."""
        if bitmaps is None:
            chunks, _ = super()._frame_chunks(w, kk, states, words, None,
                                              sym, rows)
        else:
            chunks = [vrans.serialize_chunk_v2(kk, st, wd, bm)
                      for st, wd, bm in zip(states, words, bitmaps)]
        if not self.debug:
            return chunks, None
        digs = self._wave_digests(w)
        for i in range(w["k"]):
            self._debug_vr_frame(chunks[i], sym[i], rows[i], i)
        return chunks, digs

    def _entropy_host(self, w):
        """Host backend: latents pulled to the host, each chunk coded by
        the host range coder, a wave's chunks in a pool of at most four
        threads (one at a time under debug, so the [AC] lines keep their
        order)."""
        k = w["k"]
        jobs = []
        for fam in ("mofnet", "codecnet"):
            z = w["z_m" if fam == "mofnet" else "z_c"]
            if z is None:
                continue
            with tracing.span("finish.pull"):
                z_np = _nhwc(z)
            with tracing.span("finish.pull"):
                y_np = _nhwc(w["q_m" if fam == "mofnet" else "q_c"])
            with tracing.span("finish.pull"):
                b_np = _nhwc(w["bins_m" if fam == "mofnet" else "bins_c"])
            for i in range(k):
                jobs.append((i, f"{fam}_z", functools.partial(
                    self._encode_z, fam, z_np[i], f"{fam}_z[{i}]")))
                jobs.append((i, f"{fam}_y", functools.partial(
                    self._encode_y, y_np[i], b_np[i], f"{fam}_y[{i}]")))
        outs = ([fn() for _, _, fn in jobs] if self.debug
                else _par_map(lambda job: job[2](), jobs))
        chunks = [dict() for _ in range(k)]
        for (i, name, _), out in zip(jobs, outs):
            chunks[i][name] = out
        with tracing.span("finish.pack"):
            digs = self._wave_digests(w) if self.debug else None
            dcs = self._dc_trailers(w)
            frame_bytes, stats = [], self._base_stats(w)
            for i in range(k):
                c = chunks[i]
                fb = bs.pack_frame(c, digs[i] if digs else None, dc=dcs[i])
                frame_bytes.append(fb)
                stats[i].update({
                    "bytes": len(fb),
                    "mode_bytes": (len(c.get("mofnet_z", b""))
                                   + len(c.get("mofnet_y", b""))),
                    "codec_bytes": (len(c["codecnet_z"])
                                    + len(c["codecnet_y"])),
                })
        return frame_bytes, stats

    # ------------------------------------------------------------------
    # Chunk coding (host backend) with the debug self-check
    # ------------------------------------------------------------------
    def _encode_z(self, which: str, z_np: np.ndarray, label: str) -> bytes:
        chunk = bs.encode_z_chunk(z_np, self.z_rows[which])
        if self.debug:
            H, W, C = z_np.shape
            rows = np.broadcast_to(np.arange(C, dtype=np.int32), (H, W, C))
            est = expected_bits((z_np + self.ac_max).astype(np.int64),
                                rows, self.z_rows[which]) / 8.0
            back = bs.decode_z_chunk(chunk, z_np.shape, self.z_rows[which])
            lossless = np.array_equal(back, z_np)
            print(f"[AC] {label}: {len(chunk)}B real, {est:.1f}B analytic, "
                  f"overhead {100 * (len(chunk) / max(est, 1e-9) - 1):.2f}%, "
                  f"{'lossless Ok!' if lossless else 'NOT LOSSLESS Ko!'}")
            if not lossless:
                raise AssertionError(f"entropy coding not lossless: {label}")
        return chunk

    def _encode_y(self, y_np: np.ndarray, bins_np: np.ndarray,
                  label: str) -> bytes:
        chunk = bs.encode_y_chunk(y_np, bins_np, self.laplace_rows)
        if self.debug:
            nz = np.where(np.abs(y_np).sum(axis=(0, 1)) != 0)[0]
            est = (expected_bits(
                (y_np[:, :, nz] + self.ac_max).astype(np.int64),
                bins_np[:, :, nz], self.laplace_rows) / 8.0
                if len(nz) else 0.0)
            back = bs.decode_y_chunk(chunk, y_np.shape, bins_np,
                                     self.laplace_rows)
            lossless = np.array_equal(back, y_np)
            print(f"[AC] {label}: {len(chunk)}B real, {est:.1f}B analytic, "
                  f"{len(nz)}/{y_np.shape[2]} ft maps, "
                  f"{'lossless Ok!' if lossless else 'NOT LOSSLESS Ko!'}")
            if not lossless:
                raise AssertionError(f"entropy coding not lossless: {label}")
        return chunk

    def _debug_vr_frame(self, payload: bytes, sym: torch.Tensor,
                        rows: torch.Tensor, i: int) -> None:
        """Fused-chunk lossless self-check + analytic-vs-real rate for the
        device backend (reference: bitstream.py:307-350): the chunk's
        bytes are parsed and decoded again (K2 on the card, its plain
        version on the host) against the rows its encode used."""
        words, states, kk, _ = vrans.parse_chunk_v2(payload)
        back, _, _ = vrans.decode_batch(
            torch.from_numpy(words.astype(np.uint16))[None].to(self.device),
            torch.from_numpy(states)[None].to(self.device),
            rows[None].contiguous(), self.table, kk)
        lossless = torch.equal(back[0], sym)
        est = expected_bits(sym.cpu().numpy(), rows.cpu().numpy(),
                            self.fused_rows) / 8.0
        print(f"[AC-dev] fused[{i}]: {len(payload)}B real, "
              f"{est:.1f}B analytic, "
              f"{'lossless Ok!' if lossless else 'NOT LOSSLESS Ko!'}")
        if not lossless:
            raise AssertionError(
                f"device entropy coding not lossless: frame {i}")

    def _wave_digests(self, w) -> List[Dict[str, bytes]]:
        """Per-frame in-band latent digests (debug mode): md5 of each
        latent in (H, W, C) int32 order, keyed by chunk name, carried in
        the frame container so the decoder names the latent that differs
        (reference: src/real_life/bitstream.py:229-234,419-421,488-499)."""
        digs = [dict() for _ in range(w["k"])]
        for fam, z, q in (("codecnet", w["z_c"], w["q_c"]),
                          ("mofnet", w["z_m"], w["q_m"])):
            if z is None:
                continue
            zs, ys = _nhwc(z), _nhwc(q)
            for i, d in enumerate(digs):
                d[f"{fam}_z"] = bs.latent_md5(zs[i])
                d[f"{fam}_y"] = bs.latent_md5(ys[i])
        return digs

    @staticmethod
    def _verify_latents(digests, fam: str, z: torch.Tensor,
                        q: torch.Tensor) -> None:
        """Decoder-side check of a wave's in-band digests of one net's
        latents (no-op when the stream carries none)."""
        if not any(digests):
            return
        zs, ys = _nhwc(z), _nhwc(q)
        for i, d in enumerate(digests):
            for name, arr in ((f"{fam}_z", zs[i]), (f"{fam}_y", ys[i])):
                if d and name in d and bs.latent_md5(arr) != d[name]:
                    raise ValueError(
                        f"bitstream debug: latent md5 mismatch at frame {i} "
                        f"chunk {name} — decoded latent differs from the "
                        f"encoder's (corrupt or mismatched stream)")

    @torch.no_grad()
    def _analytic_bits(self, w) -> torch.Tensor:
        """Per-frame bits of the wave's latents under the coder's own
        quantized CDFs (the JAX package's audit_i / audit_pb): -log2 of
        each symbol's probability in float32 (at least 2^-16), summed in
        float64 and rounded to float32 (JAX sums in float32); all-zero y
        channels cost nothing, as in both streams.  Isolates the
        container overhead from the model's estimate."""
        cdf = self.table.cdf64
        acv = self.ac_max

        def abits(sym, rows):
            p = (cdf[rows, sym + 1] - cdf[rows, sym]).float() / PROB_SCALE
            return -torch.log2(torch.clamp_min(p, 2.0 ** -16))

        def z_bits(z, fam):
            B, C = z.shape[:2]
            sym = z.permute(0, 2, 3, 1).reshape(B, -1).long() + acv
            rows = self._z_rows(B, C, self._row_off[fam]).long()
            return abits(sym, rows).double().sum(dim=1)

        def y_bits(q, bins):
            B, C, H, W = q.shape
            keep = (q.abs().sum(dim=(2, 3)) != 0).double()
            sym = q.permute(0, 2, 3, 1).reshape(B, -1).long() + acv
            rows = (bins.permute(0, 2, 3, 1).reshape(B, -1).long()
                    + self._row_off["y"])
            per = abits(sym, rows).double().view(B, H * W, C)
            return (per * keep[:, None, :]).sum(dim=(1, 2))

        bits = z_bits(w["z_c"], "z_c") + y_bits(w["q_c"], w["bins_c"])
        if w["z_m"] is not None:
            bits = bits + z_bits(w["z_m"], "z_m") + y_bits(w["q_m"],
                                                           w["bins_m"])
        bits = bits.float()
        with tracing.span("finish.pull"):
            return bits.cpu()

    # ------------------------------------------------------------------
    # Decode
    # ------------------------------------------------------------------
    def _dec_y(self, words, st, g, bins, n: int, k: int, C: int):
        """Decode one dense (v1) y segment -> float32 [B, C, Hy, Wy]."""
        with tracing.span("batch.k2", K=k, steps=n // k):
            B = words.shape[0]
            off = self._row_off["y"]
            rows = (bins.permute(0, 2, 3, 1).reshape(B, -1).to(torch.int32)
                    + off)
            y, st, g = self._k2_seg(words, st, g, rows, n, k, off)
            y = y.reshape(B, self.hy, self.wy, C).permute(0, 3, 1, 2)
            return canonical(y), st, g

    def _dec_y_el(self, words, st, g, bins, idx, nkeep, n: int, k: int,
                  C: int):
        """Decode one elided y segment and scatter it back to a dense
        float32 [B, C, Hy, Wy]."""
        with tracing.span("batch.k2", K=k, steps=n // k):
            B = words.shape[0]
            hw = self.hy * self.wy
            bucket = idx.shape[1]
            off = self._row_off["y"]
            valid = self._y_slots(idx, nkeep, hw)
            rows = self._gather_ch(bins, idx).to(torch.int32) + off
            rows = torch.where(valid, rows, off)
            yk, st, g = self._k2_seg(words, st, g, rows, n, k, off)
            yk = torch.where(valid, yk, 0.0).reshape(B, bucket, hw)
            dense = torch.zeros((B, C, hw), dtype=torch.float32,
                                device=self.device)
            # Padded slots hold 0 and a padded idx 0: adding zeros is a
            # no-op.
            dense.scatter_add_(1, idx.long()[:, :, None].expand(-1, -1, hw),
                               yk)
            return canonical(dense.reshape(B, C, self.hy, self.wy)), st, g

    def _decode_planes(self, chunks, prev_refs, next_refs, frame_type: int,
                       idx_rate: float, backend: str):
        """Under a mesh the entropy decode runs on the whole wave on every
        rank and the nets on this rank's slice, the encoder's split; the
        planes of every slice are gathered."""
        digests = [c.get("__digests__") for c in chunks]
        sl = batch_slice(self.mesh, len(chunks))
        with tracing.span("batch.upload"):
            prev = self._stack_refs(prev_refs[sl])
            nxt = self._stack_refs(next_refs[sl])
        latents = (self._decode_latents_device if backend == "device"
                   else self._decode_latents_host)
        q_c, mu_c, pred, skip = latents(chunks, digests, prev, nxt,
                                        frame_type, idx_rate, sl)
        with tracing.span("batch.nets"):
            x_hat = self.model.codecnet_synth(_part(q_c, sl), mu_c, pred,
                                              skip, idx_rate, frame_type)
            out, _ = self._cast_planes(x_hat)
        if sl == slice(None):
            return out
        return dict(zip(("y", "u", "v"), all_gather_cat(
            self.mesh, [out[c] for c in ("y", "u", "v")])))

    def _hyper_wave(self, which: str, z_q, sl: slice):
        """The hyper stage of a decode on this rank's slice of the wave's
        z (all of it without a mesh), as the encoder ran it -> (mu of the
        slice, the sigma bins of the whole wave, which the entropy decode
        of y needs on every rank)."""
        mu, bins = self._hyper(which, _part(z_q, sl))
        if sl != slice(None):
            bins = all_gather_cat(self.mesh, [bins])[0]
        return mu, bins

    def _motion(self, q_m, mu_m, prev, nxt, frame_type: int,
                idx_rate: float):
        """pred and skip of this rank's slice (and band) from its whole
        q_m, mu_m and references."""
        maps = self.model.mofnet_synth_maps(q_m, mu_m, prev, nxt, idx_rate,
                                            frame_type)
        mof = self.model.motion_comp_stage(prev, nxt, maps, frame_type,
                                           self.warp_engine)
        return mof["pred"], mof["skip"]

    def _zero_pred(self, k: int):
        rows = self.hp // (1 if self.band is None else self.band.size)
        pred = torch.zeros((k, 3, rows, self.wp), dtype=torch.float32,
                           device=self.device)
        return pred, torch.zeros_like(pred)

    def _stream_layout(self, parsed, kk: int, frame_type: int):
        """A wave's fused stream, from its parsed chunks: (v2 or not, the
        segments' padded lengths, of a v2 stream each frame's kept MOFNet
        channels and their bucket, CodecNet's packed indices and their
        bucket)."""
        v2 = parsed[0][3] is not None
        if any((p[3] is not None) != v2 for p in parsed):
            raise ValueError("mixed v1/v2 vrans chunks in a wave")
        if not v2:
            return False, self._fused_n(frame_type, kk)[1], None, 0, None, 0
        cm, cc = self.cfg.mofnet.nb_ft_y, self.cfg.codecnet.nb_ft_y
        ch_m, ch_c = [], []
        for _, _, _, bms in parsed:
            if frame_type != FRAME_I:
                ch_m.append(vrans.bitmap_channels(bms[0], cm))
                ch_c.append(vrans.bitmap_channels(bms[1], cc))
            else:
                ch_c.append(vrans.bitmap_channels(bms[0], cc))
        bc = vrans.elide_bucket(max(c.size for c in ch_c), cc)
        bm = (vrans.elide_bucket(max(c.size for c in ch_m), cm)
              if ch_m else 0)
        idx_c = self._pack_idx(ch_c, bc)
        return (True, self._fused_n2(frame_type, kk, bm, bc)[1], ch_m, bm,
                idx_c, bc)

    def _decode_latents_device(self, chunks, digests, prev, nxt,
                               frame_type: int, idx_rate: float, sl: slice):
        """Staged rANS decode of the fused stream (K2) interleaved with
        the hyper and synthesis stages -> (q_c of the whole wave; mu_c,
        pred, skip of this rank's slice ``sl``)."""
        k = len(chunks)
        kk, layout, words, st, g = self._decode_front(chunks, frame_type)
        v2, segs, ch_m, bm, idx_c, bc = layout
        seg_it = iter(segs)
        cm, cc = self.cfg.mofnet.nb_ft_y, self.cfg.codecnet.nb_ft_y
        if frame_type == FRAME_I:
            with tracing.span("batch.nets"):
                pred, skip = self._zero_pred(len(range(k)[sl]))
        else:
            z_qm, st, g = self._dec_z(words, st, g, next(seg_it), kk,
                                      self.cfg.mofnet.nb_ft_z, "z_m")
            with tracing.span("batch.nets"):
                mu_m, bins_m = self._hyper_wave("mofnet", z_qm, sl)
            if not v2:
                q_m, st, g = self._dec_y(words, st, g, bins_m, next(seg_it),
                                         kk, cm)
            elif bm:
                with tracing.span("batch.parse"):
                    idxm, nkm = self._pack_idx(ch_m, bm)
                q_m, st, g = self._dec_y_el(words, st, g, bins_m, idxm, nkm,
                                            next(seg_it), kk, cm)
            else:
                q_m = torch.zeros((k, cm, self.hy, self.wy),
                                  dtype=torch.float32, device=self.device)
            self._verify_latents(digests, "mofnet", z_qm, q_m)
            with tracing.span("batch.nets"):
                pred, skip = self._motion(_part(q_m, sl), mu_m, prev, nxt,
                                          frame_type, idx_rate)

        z_qc, st, g = self._dec_z(words, st, g, next(seg_it), kk,
                                  self.cfg.codecnet.nb_ft_z, "z_c")
        with tracing.span("batch.nets"):
            mu_c, bins_c = self._hyper_wave("codecnet", z_qc, sl)
        if not v2:
            q_c, st, g = self._dec_y(words, st, g, bins_c, next(seg_it), kk,
                                     cc)
        elif bc:
            q_c, st, g = self._dec_y_el(words, st, g, bins_c, *idx_c,
                                        next(seg_it), kk, cc)
        else:
            q_c = torch.zeros((k, cc, self.hy, self.wy), dtype=torch.float32,
                              device=self.device)
        self._verify_latents(digests, "codecnet", z_qc, q_c)
        return q_c, mu_c, pred, skip

    def _decode_latents_host(self, chunks, digests, prev, nxt,
                             frame_type: int, idx_rate: float, sl: slice):
        """Host-backend chunks: each net's z decoded on the host, its
        hyper stage on the device, the sigma bins back to the host for
        the y decode -> (q_c of the whole wave; mu_c, pred, skip of this
        rank's slice ``sl``)."""
        k = len(chunks)

        def latents(fam: str):
            ncfg = getattr(self.cfg, fam)
            z_np = np.stack(_par_map(lambda c: bs.decode_z_chunk(
                c[f"{fam}_z"], (self.hz, self.wz, ncfg.nb_ft_z),
                self.z_rows[fam]), chunks))
            with tracing.span("batch.upload"):
                z_q = self._from_nhwc(z_np)
            with tracing.span("batch.nets"):
                mu, bins = self._hyper_wave(fam, z_q, sl)
            bins_np = _nhwc(bins)
            y_np = np.stack(_par_map(lambda ic: bs.decode_y_chunk(
                ic[1][f"{fam}_y"], (self.hy, self.wy, ncfg.nb_ft_y),
                bins_np[ic[0]], self.laplace_rows), list(enumerate(chunks))))
            with tracing.span("batch.upload"):
                q = self._from_nhwc(y_np)
            self._verify_latents(digests, fam, z_q, q)
            return q, mu

        if frame_type == FRAME_I:
            with tracing.span("batch.nets"):
                pred, skip = self._zero_pred(len(range(k)[sl]))
        else:
            q_m, mu_m = latents("mofnet")
            with tracing.span("batch.nets"):
                pred, skip = self._motion(_part(q_m, sl), mu_m, prev, nxt,
                                          frame_type, idx_rate)
        q_c, mu_c = latents("codecnet")
        return q_c, mu_c, pred, skip

    def _from_nhwc(self, a: np.ndarray) -> torch.Tensor:
        """Host int latents [B, H, W, C] -> float32 NCHW on the device,
        with the encoder's strides."""
        t = torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        return canonical(t.permute(0, 3, 1, 2).to(torch.float32))

    @property
    def sched_bits(self) -> int:
        """Compute-schedule byte of the video header, as JAX computes it
        (codec.py:1865-1875): bit0 lane-packed heads, bit1 low-precision
        GDN, bit2 channel-major MOFNet maps, bit3 space-to-depth analysis
        convs, bit4 closed-loop DC-offset correction."""
        return ((1 if self.cfg.codecnet.head_lane_pack > 1 else 0)
                | (2 if self.cfg.codecnet.gdn_lowp else 0)
                | (4 if self.cfg.mofnet.maps_cm else 0)
                | (8 if self.cfg.codecnet.s2d_analysis else 0)
                | (16 if self.dc_offset else 0))


def make_codec(cfg, model, height: int, width: int, **kw) -> WaveCodec:
    """The codec of a loaded model: FrameCodec for AIVC's FullNet,
    ElicCodec (pipeline/elic.py) for ELIC."""
    if isinstance(cfg, ElicConfig):
        return ElicCodec(cfg, model, height, width, **kw)
    return FrameCodec(cfg, model, height, width, **kw)
