"""WaveCodec: the wave plumbing of every model's frame codec.  A wave is
k frames of one type coded as one device batch.

  WaveCodec (here): the constructor, the K policy, cast, DC correction
      and references, the encode and decode shells, the one K1 finish,
      the decode front (the wave's word buffer) and tail (DC trailers,
      references), the video header.
  FrameCodec (codec.py): AIVC's FullNet, the mesh, the v1 / v2 fused
      streams, the host backend, debug and audit.
  ElicCodec (elic.py): ELIC's nets, table and ten context steps.

A subclass provides ``_encode_transforms`` (the device half of an encode
-> the wave's handles), ``_wave_parts`` (K and the stream's parts for
K1), ``_decode_planes`` (a wave's decoded planes), ``_stream_layout``
(its segments of a parsed wave) and ``sched_bits``, and calls
``_set_table``.

Encoder and decoder run the same module code on batches of the same
composition, with cuDNN deterministic and its benchmark search off, so
the float inputs of entropy coding (sigma bins) and of the reference loop
are bit-identical on both sides of one card.  pipeline/video.py:
encode_gop keeps up to AIVC_PIPELINE_LOOKAHEAD waves launched
(``encode_frames_launch``, the device half) ahead of the one it finishes
(``encode_frames_finish``: the K policy, entropy coding, packing); the
finish sees the waves in coding order, so every lookahead writes the
same bytes.

Spans (tracing.py): ``launch`` (the subclass's), ``finish``
(``finish.k1``, ``finish.pull`` a pull, ``finish.pack``) and ``batch``
(``batch.parse``, ``batch.upload``, ``batch.k2``, ``batch.nets``) of a
wave, ``planes.pull``.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from aivc_tpu_torch import tracing
from aivc_tpu_torch.coding import bitstream as bs
from aivc_tpu_torch.coding import vrans
from aivc_tpu_torch.config import PAD_MULTIPLE, Y_DOWNSCALE, Z_DOWNSCALE
from aivc_tpu_torch.device import resolve_device
from aivc_tpu_torch.ops.layers import x444_to_yuv420, yuv420_to_444

# The compute-schedule switches of the JAX package's FrameCodec
# (aivc_tpu/pipeline/codec.py:169-218), bit i of the video header's
# schedule byte each, all on unless set to "0".  Bit 1 (GDN parameters in
# the compute dtype of a bf16 model) and bit 4 (the closed-loop DC
# correction and its trailer) change the port's values.  Bits 0, 2 and 3
# are recorded only: the port has no lane-packed head, channel-major
# maps or space-to-depth convs to switch, so they leave its values
# unchanged; a stream is still decoded only by a codec with all five
# bits equal.
SCHED_SWITCHES = ("AIVC_PACKED_HEAD", "AIVC_GDN_LOWP", "AIVC_MAPS_CM",
                  "AIVC_S2D", "AIVC_DC_OFFSET")

# Bit 7 of the schedule byte: the stream was coded by ELIC
# (pipeline/elic.py), not by AIVC's FullNet.
SCHED_ELIC = 0x80


def switch_on(name: str) -> bool:
    """A switch of the JAX package's environment: on unless "0"."""
    return os.environ.get(name, "1") != "0"


def configure_determinism(cfg) -> None:
    """cuDNN deterministic with no benchmark search (same algorithms for
    the same shapes on encoder and decoder).  TF32 is turned off where
    ``cfg.full_float32``, so the convs and matmuls run in full float32;
    bf16 models compute in bf16 and are unaffected."""
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    if cfg.full_float32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def canonical(x: torch.Tensor) -> torch.Tensor:
    """A copy with default row-major strides.  A tensor with a size-1 dim
    (the 1x1 z grid of a 64x64 frame) can carry other strides and still
    count as contiguous; cuDNN and oneDNN may then run it in another
    memory format and round differently.  Encoder and decoder normalise
    the latents they feed the nets, so both run the same algorithms."""
    return x.clone(memory_format=torch.contiguous_format)


def _pad_edge(x: torch.Tensor, mult: int) -> torch.Tensor:
    """Edge-pad H, W of [B, C, H, W] up to a multiple of ``mult``."""
    ph = (-x.shape[2]) % mult
    pw = (-x.shape[3]) % mult
    if ph or pw:
        x = F.pad(x, (0, pw, 0, ph), mode="replicate")
    return x


def planes_to_444(y: torch.Tensor, u: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """uint8 true-size planes [B, H, W] -> edge-padded float 444 [B, 3, Hp,
    Wp]; shared by encoder, decoder and the RD forward."""
    y = _pad_edge(y[:, None].float() / 255.0, PAD_MULTIPLE)
    u = _pad_edge(u[:, None].float() / 255.0, PAD_MULTIPLE // 2)
    v = _pad_edge(v[:, None].float() / 255.0, PAD_MULTIPLE // 2)
    return yuv420_to_444(y, u, v).contiguous()


class _BatchPlanes:
    """uint8 planes of one coded wave on the device, pulled to the host
    once, on first access."""

    __slots__ = ("_dev", "_host")

    def __init__(self, planes_dev: Dict[str, torch.Tensor]):
        self._dev = planes_dev
        self._host = None

    def host(self) -> Dict[str, np.ndarray]:
        if self._host is None:
            with tracing.span("planes.pull"):
                self._host = {k: v.cpu().numpy()
                              for k, v in self._dev.items()}
            self._dev = None
        return self._host


class DecodedFrame:
    """A decoded frame: the padded 444 reference on the device [1, 3, Hp,
    Wp] and its wave's uint8 planes (host copy made lazily)."""

    __slots__ = ("_batch", "_i", "ref")

    def __init__(self, batch: _BatchPlanes, i: int, ref: torch.Tensor):
        self._batch = batch
        self._i = i
        self.ref = ref

    @property
    def planes(self) -> Dict[str, np.ndarray]:
        h = self._batch.host()
        return {k: h[k][self._i] for k in ("y", "u", "v")}

    def __getitem__(self, k: str) -> np.ndarray:
        return self.planes[k]


class WaveCodec:
    """Per-resolution codec of one model, a wave at a time."""

    # Codes every frame type (ElicCodec codes I only).
    intra_only = False
    # The stream format a resumable encode records: device-backend chunks
    # (FrameCodec may take the host backend), dense v1 ones (FrameCodec
    # may elide all-zero y channels).
    backend = "device"
    elide = False

    def __init__(self, cfg, model: torch.nn.Module, height: int, width: int,
                 device=None, rate_priority: bool = False):
        self.rate_priority = rate_priority
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            configure_determinism(cfg)
        self.dc_offset = switch_on("AIVC_DC_OFFSET")
        self.cfg = cfg
        self.model = model.to(self.device).eval()
        # The frame's true, padded, y and z sizes.
        self.h, self.w = height, width
        self.hp = math.ceil(height / PAD_MULTIPLE) * PAD_MULTIPLE
        self.wp = math.ceil(width / PAD_MULTIPLE) * PAD_MULTIPLE
        self.h_uv, self.w_uv = math.ceil(height / 2), math.ceil(width / 2)
        self.hy, self.wy = self.hp // Y_DOWNSCALE, self.wp // Y_DOWNSCALE
        self.hz, self.wz = self.hp // Z_DOWNSCALE, self.wp // Z_DOWNSCALE
        self.ac_max = int(cfg.ac_max_val or 256)
        if self.ac_max & (self.ac_max - 1) or not 16 <= self.ac_max <= 256:
            raise ValueError(f"ac_max_val must be a power of two in "
                             f"[16, 256], got {self.ac_max}")

    def _set_table(self, fused: np.ndarray, row_off: Dict[str, int]) -> None:
        """The fused CDF rows on the device, the first row of each family
        and each family's pad symbol (its first row's most probable);
        the K policy starts afresh."""
        self.fused_rows = fused
        self.table = vrans.make_table(fused, self.device)
        self._row_off = row_off
        freq = np.diff(fused.astype(np.int64), axis=1)
        self._pad_sym = {f: int(np.argmax(freq[off]))
                         for f, off in row_off.items()}
        self._k_hint: Dict[int, int] = {}

    # ------------------------------------------------------------------
    # K policy (codec.py:357-424)
    # ------------------------------------------------------------------
    def _pick_k(self, frame_type: int, n_total: int) -> int:
        """Stream count for the next frame of this type: the 4K-byte state
        flush stays ~<5% of the previous frame's payload, floored so the
        scan stays <= 2048 steps.  Rate priority floors the scan at 65536
        steps instead and sizes K for ~1% flush overhead (K doubles while
        K * 2 * bytes_per_stream <= payload; the flush is 4 bytes a
        stream, so its share is at most 2 / bytes_per_stream).
        AIVC_VRANS_K, read on each call, overrides the policy (JAX's
        override for tests and tuning, unchecked as there): it pins K, and
        with it the bytes, where the policy's history differs, as in a
        GOP round-robin encode (parallel/multihost.py)."""
        env_k = os.environ.get("AIVC_VRANS_K")
        if env_k:
            return int(env_k)
        max_steps = 65536 if self.rate_priority else 2048
        bytes_per_stream = 200 if self.rate_priority else 40
        k_lo = 8
        while n_total // k_lo > max_steps:
            k_lo *= 2
        hint = self._k_hint.get(frame_type)
        if hint is None:
            k = 8 if self.rate_priority else vrans.pick_k(n_total)
        else:
            k = 8
            while k < vrans.K_MAX and k * 2 * bytes_per_stream <= hint:
                k *= 2
        return max(k_lo, min(k, vrans.K_MAX))

    def note_coded_wave(self, frame_type: int, frame_bytes) -> None:
        """Replay the K policy's update for a wave coded earlier (its
        frames' bytes, as stored): a resumed encode that decodes finished
        GOPs instead of encoding them keeps the same stream counts, and
        so the same bytes, as an encode in one go.  The JAX package
        skips this, so its resumed device-backend streams may differ."""
        if self.backend == "device":
            payload = int(np.mean([len(b) for b in frame_bytes]))
            prev = self._k_hint.get(frame_type)
            self._k_hint[frame_type] = (payload if prev is None
                                        else (prev + payload) // 2)

    # ------------------------------------------------------------------
    # Planes, references, cast and DC correction (codec.py:451-541)
    # ------------------------------------------------------------------
    def _to_device_planes(self, frames_u8) -> Dict[str, torch.Tensor]:
        return {c: torch.from_numpy(np.stack([np.asarray(f[c]) for f in
                                              frames_u8])).to(self.device)
                for c in ("y", "u", "v")}

    def ref_to_444(self, frame_u8) -> torch.Tensor:
        """uint8 YUV420 planes (true size) -> padded float 444 on device."""
        return planes_to_444(**self._to_device_planes([frame_u8]))

    def _cast_planes(self, x444: torch.Tensor, maps=()):
        """444 -> 420, quantize to 256 levels, crop: uint8 [B, h, w] each;
        the float ``maps`` [B, 1, rows, W] go along through
        ``_whole_rows``.  -> (planes, the maps of the whole frame)."""
        ts = self._whole_rows(
            [torch.clamp(torch.round(torch.clamp(p, 0.0, 1.0) * 255.0),
                         0, 255).to(torch.uint8)
             for p in x444_to_yuv420(x444)] + list(maps))
        y, u, v = (t[:, 0] for t in ts[:3])
        planes = {"y": y[:, :self.h, :self.w].contiguous(),
                  "u": u[:, :self.h_uv, :self.w_uv].contiguous(),
                  "v": v[:, :self.h_uv, :self.w_uv].contiguous()}
        return planes, ts[3:]

    def _whole_rows(self, ts: List[torch.Tensor]) -> List[torch.Tensor]:
        """[B, C, rows, W] of this process's rows -> of the whole frame."""
        return ts

    @staticmethod
    def _apply_dc(out, dc: torch.Tensor):
        """Per-plane signed offsets dc [B, 3] on uint8 planes, saturating."""
        return {k: torch.clamp(out[k].to(torch.int32)
                               + dc[:, i, None, None], 0, 255
                               ).to(torch.uint8)
                for i, k in enumerate(("y", "u", "v"))}

    @staticmethod
    def _measure_dc(out, orig) -> torch.Tensor:
        """Per-plane offsets from exact int64 plane sums: round((sum(orig)
        - sum(decoded)) / n) in float32, as the JAX f32 mean."""
        ds = []
        for k in ("y", "u", "v"):
            so = orig[k].to(torch.int64).sum(dim=(1, 2))
            sd = out[k].to(torch.int64).sum(dim=(1, 2))
            n = float(out[k].shape[1] * out[k].shape[2])
            ds.append(torch.round((so - sd).to(torch.float32) / n)
                      .to(torch.int32))
        return torch.stack(ds, dim=1)

    def _dc_correct_enc(self, out, orig):
        """Measure, apply, re-measure; the total offset is applied once to
        the raw planes, as the decoder does with the trailer value.  ->
        (planes, offsets), or the planes and None with the switch off."""
        if not self.dc_offset:
            return out, None
        dc1 = self._measure_dc(out, orig)
        out1 = self._apply_dc(out, torch.clamp(dc1, -127, 127))
        dc = torch.clamp(dc1 + self._measure_dc(out1, orig), -127, 127)
        return self._apply_dc(out, dc), dc

    def _split_decoded(self, planes, k: int) -> List[DecodedFrame]:
        """A wave's uint8 planes -> its k frames, each with its 444
        reference on the device."""
        ref444 = planes_to_444(planes["y"], planes["u"], planes["v"])
        batch = _BatchPlanes(planes)
        return [DecodedFrame(batch, i, ref444[i:i + 1]) for i in range(k)]

    # ------------------------------------------------------------------
    # Stream segments
    # ------------------------------------------------------------------
    @staticmethod
    def _pad_seg(sym, rows, k: int, pad_sym: int, pad_row: int):
        pad = (-sym.shape[1]) % k
        if pad:
            sym = F.pad(sym, (0, pad), value=pad_sym)
            rows = F.pad(rows, (0, pad), value=pad_row)
        return sym, rows

    def _z_rows(self, B: int, C: int, off: int) -> torch.Tensor:
        """Row index of each z symbol in (H, W, C) order."""
        ch = torch.arange(C, dtype=torch.int32, device=self.device) + off
        return ch.repeat(self.hz * self.wz).expand(B, -1)

    def _z_seg(self, zq: torch.Tensor, fam: str, k: int):
        """z [B, C, Hz, Wz] -> symbols/rows in the JAX (H, W, C) order."""
        B, C = zq.shape[:2]
        sym = (zq.permute(0, 2, 3, 1).reshape(B, -1).to(torch.int32)
               + self.ac_max)
        off = self._row_off[fam]
        return self._pad_seg(sym, self._z_rows(B, C, off), k,
                             self._pad_sym[fam], off)

    def _quantize_y(self, y, mu):
        # "+ 0.0" turns -0.0 into +0.0, the value the decoder rebuilds
        # from the integer symbols.
        return torch.clamp(torch.round(y - mu), -self.ac_max,
                           self.ac_max - 1) + 0.0

    def _k2_seg(self, words, st, g, rows, n: int, k: int, pad_row: int):
        """One K2 launch over a segment, ``rows`` padded to n with
        ``pad_row`` -> (its values, float32 without the pad; the carry)."""
        nraw = rows.shape[1]
        rows = F.pad(rows, (0, n - nraw), value=pad_row)
        syms, st, g = vrans.decode_batch(words, st, rows.contiguous(),
                                         self.table, k, g)
        return (syms[:, :nraw] - self.ac_max).to(torch.float32), st, g

    def _dec_z(self, words, st, g, n: int, k: int, C: int, fam: str):
        """Decode one z segment -> float32 [B, C, Hz, Wz] and the carry."""
        with tracing.span("batch.k2", K=k, steps=n // k):
            B = words.shape[0]
            off = self._row_off[fam]
            z, st, g = self._k2_seg(words, st, g, self._z_rows(B, C, off),
                                    n, k, off)
            z = z.reshape(B, self.hz, self.wz, C).permute(0, 3, 1, 2)
            return canonical(z), st, g

    # ------------------------------------------------------------------
    # Encode
    # ------------------------------------------------------------------
    @torch.no_grad()
    def encode_frames_launch(self, frames_u8, prev_refs, next_refs,
                             frame_type: int, idx_rate: float) -> Dict:
        """The device half of k same-type frames' encode, queued: the
        nets, the cast, the DC correction and the references (the host
        waits for the frames' upload and, under a mesh, the gathers, not
        for the nets).  Returns the wave's handles;
        their ``decoded`` (DecodedFrame list) are device references that
        later waves may take before ``encode_frames_finish``, their
        ``wave`` the wave's id in the recorded spans (tracing.py; None
        where nothing records)."""
        wave = tracing.new_wave()
        with tracing.span("launch", wave=wave, k=len(frames_u8),
                          frame_type=frame_type):
            handles = self._encode_transforms(frames_u8, prev_refs,
                                              next_refs, frame_type,
                                              idx_rate)
        handles["wave"] = wave
        return handles

    @torch.no_grad()
    def encode_frames_finish(self, handles: Dict):
        """The host half of a launched wave: the K policy, entropy coding
        and packing.  Waves must be finished in the order they were
        launched.  Returns (frame bytes list, DecodedFrame list, per-frame
        stats)."""
        with tracing.span("finish", wave=handles.get("wave"),
                          k=handles["k"], frame_type=handles["frame_type"]):
            frame_bytes, stats = self._code_wave(handles)
        return frame_bytes, handles["decoded"], stats

    def encode_frames_batch(self, frames_u8, prev_refs, next_refs,
                            frame_type: int, idx_rate: float):
        """Code k same-type frames as one device batch: launch, then
        finish.  Returns (frame bytes list, DecodedFrame list, per-frame
        stats)."""
        return self.encode_frames_finish(self.encode_frames_launch(
            frames_u8, prev_refs, next_refs, frame_type, idx_rate))

    def _code_wave(self, w):
        """A launched wave's frame bytes and stats."""
        return self._entropy_device(w)

    def _base_stats(self, w) -> List[Dict]:
        """Each frame's motion stats: no motion here (FrameCodec's P / B
        frames take their masks' means)."""
        return [{"alpha_mean": 1.0, "beta_mean": 1.0} for _ in range(w["k"])]

    def _dc_trailers(self, w) -> List[Optional[tuple]]:
        """Each frame's DC trailer, or None without the correction."""
        if w["dc"] is None:
            return [None] * w["k"]
        with tracing.span("finish.pull"):
            dc = w["dc"].cpu().numpy()
        return [tuple(int(v) for v in row) for row in dc]

    def _frame_chunks(self, w, kk: int, states, words, bitmaps, sym, rows):
        """Each frame's chunk from its states and words: the dense v1
        chunk -> (chunks, None: no latent digests)."""
        return [vrans.serialize_chunk(kk, st, wd)
                for st, wd in zip(states, words)], None

    def _entropy_device(self, w):
        """One K1 launch over a wave's parts (``_wave_parts``: K, each
        part's symbols and rows padded to a multiple of K, its stats
        column: 0 / 1 MOFNet's z / y, mode bytes, 2 / 3 the frame's own,
        codec bytes; bitmaps), K1 marking where each column's words start;
        three pulls; each frame's chunk, container and stats."""
        k, frame_type = w["k"], w["frame_type"]
        with tracing.span("finish.k1") as sp:
            kk, parts, cols, bitmaps = self._wave_parts(w)
            sym = torch.cat([p[0] for p in parts], dim=1).contiguous()
            rows = torch.cat([p[1] for p in parts], dim=1).contiguous()
            used = sorted(set(cols))
            segs = tuple(sum(p[0].shape[1] for p, c in zip(parts, cols)
                             if c == u) // kk for u in used)
            buf, states, seg_g = vrans.encode_batch(sym, rows, self.table,
                                                    kk, segs)
            n_pad = sym.shape[1]
            sp.note(K=kk, steps=n_pad // kk)
        with tracing.span("finish.pull"):
            seg_np = seg_g.cpu().numpy().astype(np.int64)
        with tracing.span("finish.pull"):
            states_np = states.cpu().numpy()
        totals = n_pad - seg_np[:, 0]
        mmax = int(totals.max())
        with tracing.span("finish.pull"):
            tail = buf[:, n_pad - mmax:].cpu().numpy() if mmax else None
        with tracing.span("finish.pack"):
            bounds = np.concatenate([seg_np, np.full((k, 1), n_pad)], axis=1)
            segw = np.zeros((k, 4), np.int64)
            segw[:, used] = np.diff(bounds, axis=1)
            words = [tail[i, mmax - t:] if t else np.empty(0, np.uint16)
                     for i, t in enumerate(totals.tolist())]
            chunks, digs = self._frame_chunks(w, kk, states_np, words,
                                              bitmaps, sym, rows)
            dcs = self._dc_trailers(w)
            frame_bytes, stats = [], self._base_stats(w)
            for i in range(k):
                fb = bs.pack_frame({"codecnet_z": chunks[i]},
                                   digs[i] if digs else None, dc=dcs[i])
                frame_bytes.append(fb)
                stats[i].update({
                    "bytes": len(fb),
                    "mode_bytes": 2 * int(segw[i, :2].sum()),
                    "codec_bytes": 2 * int(segw[i, 2:].sum()),
                    "k": kk,
                })
            self.note_coded_wave(frame_type, frame_bytes)
        return frame_bytes, stats

    # ------------------------------------------------------------------
    # Decode
    # ------------------------------------------------------------------
    @torch.no_grad()
    def decode_frames_batch(self, frame_bytes_list, prev_refs, next_refs,
                            frame_type: int, idx_rate: float,
                            backend: Optional[str] = None):
        """Decode k same-type frames as one batch.  Must be called with
        the grouping the encoder used (the wave composition is part of
        the bit-exactness contract).  ``backend`` names the chunk format
        the stream carries ("device" | "host"; decode_video passes the
        video header's flag) and defaults to this codec's own.  The
        subclass's ``_decode_planes`` gives the wave's uint8 planes."""
        with tracing.span("batch", wave=tracing.new_wave(),
                          k=len(frame_bytes_list), frame_type=frame_type):
            with tracing.span("batch.parse"):
                chunks = [bs.unpack_frame(fb) for fb in frame_bytes_list]
            out = self._decode_planes(chunks, prev_refs, next_refs,
                                      frame_type, idx_rate,
                                      backend or self.backend)
            if self.dc_offset:
                dcs = [c.get("__dc__") for c in chunks]
                if None in dcs:
                    raise ValueError("dc_offset enabled but a frame carries "
                                     "no DC trailer (stream from an "
                                     "AIVC_DC_OFFSET=0 encoder?)")
                with tracing.span("batch.upload"):
                    dc = torch.tensor(dcs, dtype=torch.int32,
                                      device=self.device)
                with tracing.span("batch.nets"):
                    out = self._apply_dc(out, dc)
            with tracing.span("batch.nets"):
                return self._split_decoded(out, len(chunks))

    def _decode_front(self, chunks, frame_type: int):
        """A wave's fused chunks parsed (one K for all), laid out by the
        subclass (``_stream_layout``), their words in one zero-padded
        buffer of a bucketed width (K2 reads each frame's own words alone),
        uploaded with the states and a zero word cursor -> (K, layout,
        words, states, cursor)."""
        k = len(chunks)
        with tracing.span("batch.parse"):
            parsed = [vrans.parse_chunk_v2(c["codecnet_z"]) for c in chunks]
            kk = parsed[0][2]
            if any(p[2] != kk for p in parsed):
                raise ValueError("inconsistent vrans stream counts in a wave")
            layout = self._stream_layout(parsed, kk, frame_type)
            mw = vrans.bucket(max(max(p[0].size for p in parsed), 1),
                              1 << 30)
            wb = np.zeros((k, mw), np.uint16)
            for i, p in enumerate(parsed):
                wb[i, :p[0].size] = p[0]
        with tracing.span("batch.upload"):
            words = torch.from_numpy(wb).to(self.device)
            st = torch.from_numpy(np.stack([p[1] for p in parsed])).to(
                self.device)
            g = torch.zeros(k, dtype=torch.int32, device=self.device)
        return kk, layout, words, st, g

    def check_model(self, header: bs.VideoHeader) -> None:
        """Raise if the stream was coded by the other model (AIVC or
        ELIC: bit 7 of the schedule byte)."""
        if (header.sched ^ self.sched_bits) & SCHED_ELIC:
            names = ("AIVC", "ELIC")
            raise ValueError(
                f"bitstream was coded by an "
                f"{names[bool(header.sched & SCHED_ELIC)]} model; this "
                f"codec holds {names[bool(self.sched_bits & SCHED_ELIC)]}")

    def check_sched(self, header: bs.VideoHeader) -> None:
        """Raise if the stream's compute-schedule byte is not this
        codec's (a mismatched decoder would drift through the GOP), with
        JAX's message naming the switches that rebuild the right codec."""
        if header.sched != self.sched_bits:
            sets = " ".join(f"{name}={1 if header.sched >> i & 1 else 0}"
                            for i, name in enumerate(SCHED_SWITCHES))
            raise ValueError(
                f"bitstream compute schedule {header.sched:#04x} != this "
                f"codec's {self.sched_bits:#04x}; set {sets} and rebuild the "
                f"codec to decode this stream bit-exactly")

    def video_header(self, nb_gop: int, idx_first: int, idx_last: int,
                     wave_batch: int = 1) -> bs.VideoHeader:
        return bs.VideoHeader(
            h_x=self.h, w_x=self.w, h_y=self.hy, w_y=self.wy,
            h_z=self.hz, w_z=self.wz, nb_gop=nb_gop,
            idx_first_frame=idx_first, idx_last_frame=idx_last,
            backend=(bs.BACKEND_DEVICE if self.backend == "device"
                     else bs.BACKEND_HOST),
            wave_batch=max(1, wave_batch),
            ac_log2=self.ac_max.bit_length() - 1, sched=self.sched_bits)
