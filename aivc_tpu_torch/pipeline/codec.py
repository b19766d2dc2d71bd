"""FrameCodec: the frame coding engine (counterpart of
aivc_tpu/pipeline/codec.py), with both entropy backends.

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

Encoder and decoder run the same module code on batches of the same
composition (a wave of the GOP), with cuDNN deterministic and its
benchmark search off, so the float inputs of entropy coding (sigma bins)
and of the reference loop are bit-identical on both sides of one card.

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

An encode is two calls per wave: ``encode_frames_launch`` queues the
device half (the nets, the cast, the DC correction, the references) and
returns handles whose ``decoded`` are device references;
``encode_frames_finish`` does the rest (the K policy, entropy coding,
packing).  pipeline/video.py:encode_gop keeps up to
AIVC_PIPELINE_LOOKAHEAD waves launched ahead of the one it finishes;
the K policy runs in ``encode_frames_finish``, which sees the waves in
coding order, so every lookahead writes the same bytes.

Spans (tracing.py) mark each wave's parts while something records:
``launch`` (upload, nets, warp, planes) and ``finish`` (K1, each pull to
the host, packing) of an encode, sharing the wave's id; ``batch``
(parse, upload, K2, nets) of a decode; ``planes.pull``; ``pool``.

Format: v2 fused streams with all-zero y channels elided
(codec.py:665-990,1221-1300), or under AIVC_VRANS_ELIDE=0 the dense v1
fused stream (codec.py:243-248, 357-367, 1184-1200); host-backend chunks
with the same elision (coding/bitstream.py); the per-frame DC trailer
(codec.py:494-541); the schedule byte of the video header, from the
five switches JAX reads at construction (``SCHED_SWITCHES``).  The DC
plane sums are int64 (the JAX sums are int32, which agree below ~8.4M
luma pixels).
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

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
from aivc_tpu_torch.config import (
    FRAME_I,
    PAD_MULTIPLE,
    Y_DOWNSCALE,
    Z_DOWNSCALE,
    ModelConfig,
)
from aivc_tpu_torch.device import full_float32, resolve_device
from aivc_tpu_torch.models.fullnet import FullNet
from aivc_tpu_torch.ops.layers import x444_to_yuv420, yuv420_to_444
from aivc_tpu_torch.ops.warp import warp_engine
from aivc_tpu_torch.parallel.halo import RowBand
from aivc_tpu_torch.parallel.mesh import (
    all_gather_cat,
    batch_slice,
    check_mesh,
    check_rows,
    shard_params,
)

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


def configure_determinism(cfg: ModelConfig) -> None:
    """cuDNN deterministic with no benchmark search (same algorithms for
    the same shapes on encoder and decoder).  TF32 is turned off for
    float32 models so their convs and matmuls run in full float32; bf16
    models compute in bf16 and are unaffected."""
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    if full_float32(cfg):
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


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


def canonical(x: torch.Tensor) -> torch.Tensor:
    """A copy with default row-major strides.  A tensor with a size-1 dim
    (the 1x1 z grid of a 64x64 frame) can carry other strides and still
    count as contiguous; cuDNN and oneDNN may then run it in another
    memory format and round differently.  Encoder and decoder normalise
    the latents they feed the nets, so both run the same algorithms."""
    return x.clone(memory_format=torch.contiguous_format)


def _part(x: torch.Tensor, sl: slice) -> torch.Tensor:
    """This rank's slice of a wave's tensor, in a fresh buffer as the
    encoder's own slice was (``x`` itself where the slice is all)."""
    return x if sl == slice(None) else canonical(x[sl])


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


class FrameCodec:
    """Per-resolution codec around a FullNet."""

    # Codes every frame type (pipeline/elic.py's ElicCodec codes I only).
    intra_only = False

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
        self.rate_priority = rate_priority
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            configure_determinism(cfg)
        # The schedule switches, read once here, as in JAX.
        cfg = scheduled_config(cfg)
        self.dc_offset = switch_on("AIVC_DC_OFFSET")
        # The device backend writes the v2 fused stream with all-zero y
        # channels elided, or under AIVC_VRANS_ELIDE=0 the dense v1 one.
        self.elide = (entropy_backend == "device"
                      and switch_on("AIVC_VRANS_ELIDE"))
        self.cfg = cfg
        self.model = FullNet(cfg)
        self.model.load_state_dict(model.state_dict())
        self.model = self.model.to(self.device).eval()
        self._set_geometry(height, width)
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

        self._n_z = {
            "mofnet": self.hz * self.wz * cfg.mofnet.nb_ft_z,
            "codecnet": self.hz * self.wz * cfg.codecnet.nb_ft_z,
        }
        self._n_y = {
            "mofnet": self.hy * self.wy * cfg.mofnet.nb_ft_y,
            "codecnet": self.hy * self.wy * cfg.codecnet.nb_ft_y,
        }
        self.warp_engine = warp_engine(cfg.flow_bound)
        self._set_alphabet(cfg.ac_max_val)

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

    def _set_geometry(self, height: int, width: int) -> None:
        """The frame's true, padded, y and z sizes."""
        self.h, self.w = height, width
        self.hp = math.ceil(height / PAD_MULTIPLE) * PAD_MULTIPLE
        self.wp = math.ceil(width / PAD_MULTIPLE) * PAD_MULTIPLE
        self.h_uv, self.w_uv = math.ceil(height / 2), math.ceil(width / 2)
        self.hy, self.wy = self.hp // Y_DOWNSCALE, self.wp // Y_DOWNSCALE
        self.hz, self.wz = self.hp // Z_DOWNSCALE, self.wp // Z_DOWNSCALE

    def _set_alphabet(self, ac_max_val: int) -> None:
        self.ac_max = int(ac_max_val or 256)
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
    def _fused_n(self, frame_type: int, k: int):
        """(total padded symbols, per-segment padded lengths) of a frame's
        dense (v1) fused stream at stream count k."""
        segs = []
        if frame_type != FRAME_I:
            segs.append(-(-self._n_z["mofnet"] // k) * k)
            segs.append(-(-self._n_y["mofnet"] // k) * k)
        segs.append(-(-self._n_z["codecnet"] // k) * k)
        segs.append(-(-self._n_y["codecnet"] // k) * k)
        return sum(segs), tuple(segs)

    def _fused_n2(self, frame_type: int, k: int, bm: int, bc: int):
        """(total padded symbols, per-segment padded lengths) of a frame's
        elided fused stream at stream count k."""
        hw = self.hy * self.wy
        segs = []
        if frame_type != FRAME_I:
            segs.append(-(-self._n_z["mofnet"] // k) * k)
            if bm:
                segs.append(-(-(bm * hw) // k) * k)
        segs.append(-(-self._n_z["codecnet"] // k) * k)
        if bc:
            segs.append(-(-(bc * hw) // k) * k)
        return sum(segs), tuple(segs)

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

    def _update_k_hint(self, frame_type: int, payload_bytes: int) -> None:
        prev = self._k_hint.get(frame_type)
        self._k_hint[frame_type] = (payload_bytes if prev is None
                                    else (prev + payload_bytes) // 2)

    def note_coded_wave(self, frame_type: int, frame_bytes) -> None:
        """Replay the K policy's update for a wave coded earlier (its
        frames' bytes, as stored): a resumed encode that decodes finished
        GOPs instead of encoding them keeps the same stream counts, and
        so the same bytes, as an encode in one go.  The JAX package
        skips this, so its resumed device-backend streams may differ."""
        if self.backend == "device":
            self._update_k_hint(frame_type,
                                int(np.mean([len(b) for b in frame_bytes])))

    # ------------------------------------------------------------------
    # Planes, references, cast and DC correction (codec.py:451-541)
    # ------------------------------------------------------------------
    def _to_device_planes(self, frames_u8):
        return [torch.from_numpy(np.stack([np.asarray(f[c]) for f in
                                           frames_u8])).to(self.device)
                for c in ("y", "u", "v")]

    def ref_to_444(self, frame_u8) -> torch.Tensor:
        """uint8 YUV420 planes (true size) -> padded float 444 on device."""
        return planes_to_444(*self._to_device_planes([frame_u8]))

    def _zero_ref(self) -> torch.Tensor:
        return torch.zeros((1, 3, self.hp, self.wp), dtype=torch.float32,
                           device=self.device)

    def _stack_refs(self, refs) -> torch.Tensor:
        arrs = [r if r is not None else self._zero_ref() for r in refs]
        return torch.cat(arrs, dim=0).contiguous()

    def _cast_planes(self, x444: torch.Tensor, maps=()):
        """444 -> 420, quantize to 256 levels, crop: uint8 [B, h, w] each;
        of a row band, the bands of every rank gathered first, with the
        float ``maps`` [B, 1, rows, W] (the alpha / beta masks) in the
        same collective.  -> (planes, the maps of the whole frame)."""
        ts = [torch.clamp(torch.round(torch.clamp(p, 0.0, 1.0) * 255.0),
                          0, 255).to(torch.uint8)
              for p in x444_to_yuv420(x444)] + list(maps)
        if self.band is not None:
            ts = all_gather_cat(self.mesh, ts, 2, axis="spatial")
        y, u, v = (t[:, 0] for t in ts[:3])
        planes = {"y": y[:, :self.h, :self.w].contiguous(),
                  "u": u[:, :self.h_uv, :self.w_uv].contiguous(),
                  "v": v[:, :self.h_uv, :self.w_uv].contiguous()}
        return planes, ts[3:]

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
        the raw planes, as the decoder does with the trailer value."""
        dc1 = self._measure_dc(out, orig)
        out1 = self._apply_dc(out, torch.clamp(dc1, -127, 127))
        dc = torch.clamp(dc1 + self._measure_dc(out1, orig), -127, 127)
        return self._apply_dc(out, dc), dc

    def _split_decoded(self, planes, ref444, k: int) -> List[DecodedFrame]:
        batch = _BatchPlanes(planes)
        return [DecodedFrame(batch, i, ref444[i:i + 1]) for i in range(k)]

    # ------------------------------------------------------------------
    # Fused stream segments
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
    def _quantize_y(self, y, mu):
        # "+ 0.0" turns -0.0 into +0.0, the value the decoder rebuilds
        # from the integer symbols.
        return torch.clamp(torch.round(y - mu), -self.ac_max,
                           self.ac_max - 1) + 0.0

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
            orig_dev = self._to_device_planes(frames_u8)
        orig = dict(zip(("y", "u", "v"), orig_dev))
        with tracing.span("launch.planes"):
            frame = planes_to_444(*orig_dev)
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
            if self.dc_offset:
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
        out = {c: t[c] for c in ("y", "u", "v")}
        with tracing.span("launch.planes"):
            ref444 = planes_to_444(out["y"], out["u"], out["v"])
        mof = (None if t["alpha_mean"] is None else
               {"alpha_mean": t["alpha_mean"], "beta_mean": t["beta_mean"]})
        return {"k": k, "frame_type": frame_type, "z_m": t["z_m"],
                "q_m": t["q_m"], "bins_m": t["bins_m"], "mof": mof,
                "z_c": t["z_c"], "q_c": t["q_c"], "bins_c": t["bins_c"],
                "dc": t["dc"], "decoded": self._split_decoded(out, ref444, k)}

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
        and packing (and the rate audit).  Waves must be finished in the
        order they were launched.  Returns (frame bytes list,
        DecodedFrame list, per-frame stats)."""
        with tracing.span("finish", wave=handles.get("wave"),
                          k=handles["k"], frame_type=handles["frame_type"]):
            if self.backend == "device":
                frame_bytes, stats = self._entropy_device(handles)
            else:
                frame_bytes, stats = self._entropy_host(handles)
            if self.audit:
                for s, bits in zip(stats,
                                   self._analytic_bits(handles).tolist()):
                    s["analytic_bits"] = bits
        return frame_bytes, handles["decoded"], stats

    def encode_frames_batch(self, frames_u8, prev_refs, next_refs,
                            frame_type: int, idx_rate: float):
        """Code k same-type frames as one device batch: launch, then
        finish.  Returns (frame bytes list, DecodedFrame list, per-frame
        stats)."""
        return self.encode_frames_finish(self.encode_frames_launch(
            frames_u8, prev_refs, next_refs, frame_type, idx_rate))

    def _base_stats(self, w) -> List[Dict]:
        k = w["k"]
        if w["mof"] is None:
            return [{"alpha_mean": 1.0, "beta_mean": 1.0} for _ in range(k)]
        with tracing.span("finish.pull"):
            a = w["mof"]["alpha_mean"].cpu().numpy()
        with tracing.span("finish.pull"):
            b = w["mof"]["beta_mean"].cpu().numpy()
        return [{"alpha_mean": float(a[i]), "beta_mean": float(b[i])}
                for i in range(k)]

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

    def _fused_parts_v1(self, w):
        """The same for the dense stream (no bitmaps): K from the dense
        total (codec.py:1190-1192), every segment present."""
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

    def _dc_trailers(self, w) -> List[Optional[tuple]]:
        """Each frame's DC trailer, or None without the correction."""
        if w["dc"] is None:
            return [None] * w["k"]
        with tracing.span("finish.pull"):
            dc = w["dc"].cpu().numpy()
        return [tuple(int(v) for v in row) for row in dc]

    def _entropy_device(self, w):
        """Fused entropy coding of a wave, one K1 launch: the v2 stream
        (channel masks to the host, wave-shared buckets) or, without
        elision, the dense v1 stream of every y symbol."""
        k, frame_type = w["k"], w["frame_type"]
        with tracing.span("finish.k1") as sp:
            if self.elide:
                kk, parts, cols, bitmaps = self._fused_parts_v2(w)
            else:
                kk, parts, cols, bitmaps = self._fused_parts_v1(w)
            sym = torch.cat([p[0] for p in parts], dim=1).contiguous()
            rows = torch.cat([p[1] for p in parts], dim=1).contiguous()
            segs = tuple(p[0].shape[1] // kk for p in parts)
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
            segw[:, cols] = np.diff(bounds, axis=1)
            chunks = []
            for i in range(k):
                t = int(totals[i])
                words = (tail[i, mmax - t:] if t else np.empty(0, np.uint16))
                chunks.append(
                    vrans.serialize_chunk(kk, states_np[i], words)
                    if bitmaps is None else
                    vrans.serialize_chunk_v2(kk, states_np[i], words,
                                             bitmaps[i]))
            digs = None
            if self.debug:
                digs = self._wave_digests(w)
                for i in range(k):
                    self._debug_vr_frame(chunks[i], sym[i], rows[i], i)
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
            torch.from_numpy(words)[None].to(self.device),
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
    def _dec_z(self, words, st, g, n: int, k: int, C: int, fam: str):
        """Decode one z segment -> float32 [B, C, Hz, Wz] and the carry."""
        with tracing.span("batch.k2", K=k, steps=n // k):
            B = words.shape[0]
            off = self._row_off[fam]
            nraw = self.hz * self.wz * C
            rows = F.pad(self._z_rows(B, C, off), (0, n - nraw), value=off)
            syms, st, g = vrans.decode_batch(words, st, rows.contiguous(),
                                             self.table, k, g)
            z = (syms[:, :nraw] - self.ac_max).to(torch.float32)
            z = z.reshape(B, self.hz, self.wz, C).permute(0, 3, 1, 2)
            return canonical(z), st, g

    def _dec_y(self, words, st, g, bins, n: int, k: int, C: int):
        """Decode one dense (v1) y segment -> float32 [B, C, Hy, Wy]."""
        with tracing.span("batch.k2", K=k, steps=n // k):
            B = words.shape[0]
            nraw = self.hy * self.wy * C
            rows = (bins.permute(0, 2, 3, 1).reshape(B, -1).to(torch.int32)
                    + self._row_off["y"])
            rows = F.pad(rows, (0, n - nraw), value=self._row_off["y"])
            syms, st, g = vrans.decode_batch(words, st, rows.contiguous(),
                                             self.table, k, g)
            y = (syms[:, :nraw] - self.ac_max).to(torch.float32)
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
            valid = self._y_slots(idx, nkeep, hw)
            rows = (self._gather_ch(bins, idx).to(torch.int32)
                    + self._row_off["y"])
            rows = torch.where(valid, rows, self._row_off["y"])
            rows = F.pad(rows, (0, n - bucket * hw), value=self._row_off["y"])
            syms, st, g = vrans.decode_batch(words, st, rows.contiguous(),
                                             self.table, k, g)
            yk = (syms[:, :bucket * hw] - self.ac_max).to(torch.float32)
            yk = torch.where(valid, yk, 0.0).reshape(B, bucket, hw)
            dense = torch.zeros((B, C, hw), dtype=torch.float32,
                                device=self.device)
            # Padded slots hold 0 and a padded idx 0: adding zeros is a
            # no-op.
            dense.scatter_add_(1, idx.long()[:, :, None].expand(-1, -1, hw),
                               yk)
            return canonical(dense.reshape(B, C, self.hy, self.wy)), st, g

    @torch.no_grad()
    def decode_frames_batch(self, frame_bytes_list, prev_refs, next_refs,
                            frame_type: int, idx_rate: float,
                            backend: Optional[str] = None):
        """Decode k same-type frames as one batch.  Must be called with
        the grouping the encoder used (the wave composition is part of
        the bit-exactness contract).  ``backend`` names the chunk format
        the stream carries ("device" | "host"; decode_video passes the
        video header's flag) and defaults to this codec's own."""
        with tracing.span("batch", wave=tracing.new_wave(),
                          k=len(frame_bytes_list), frame_type=frame_type):
            with tracing.span("batch.parse"):
                chunks = [bs.unpack_frame(fb) for fb in frame_bytes_list]
            digests = [c.get("__digests__") for c in chunks]
            # Under a mesh the entropy decode runs on the whole wave on
            # every rank and the nets on this rank's slice, the encoder's
            # split.
            sl = batch_slice(self.mesh, len(chunks))
            with tracing.span("batch.upload"):
                prev = self._stack_refs(prev_refs[sl])
                nxt = self._stack_refs(next_refs[sl])
            if (backend or self.backend) == "device":
                q_c, mu_c, pred, skip = self._decode_latents_device(
                    chunks, digests, prev, nxt, frame_type, idx_rate, sl)
            else:
                q_c, mu_c, pred, skip = self._decode_latents_host(
                    chunks, digests, prev, nxt, frame_type, idx_rate, sl)
            with tracing.span("batch.nets"):
                x_hat = self.model.codecnet_synth(_part(q_c, sl), mu_c, pred,
                                                  skip, idx_rate, frame_type)
                out, _ = self._cast_planes(x_hat)
            if self.dc_offset:
                dcs = []
                for c in chunks:
                    if c.get("__dc__") is None:
                        raise ValueError(
                            "dc_offset enabled but a frame carries no DC "
                            "trailer (stream from an AIVC_DC_OFFSET=0 "
                            "encoder?)")
                    dcs.append(c["__dc__"])
                with tracing.span("batch.upload"):
                    dc = torch.tensor(dcs[sl], dtype=torch.int32,
                                      device=self.device)
                with tracing.span("batch.nets"):
                    out = self._apply_dc(out, dc)
            if sl != slice(None):
                out = dict(zip(("y", "u", "v"), all_gather_cat(
                    self.mesh, [out[c] for c in ("y", "u", "v")])))
            with tracing.span("batch.nets"):
                ref444 = planes_to_444(out["y"], out["u"], out["v"])
            return self._split_decoded(out, ref444, len(chunks))

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

    def _decode_latents_device(self, chunks, digests, prev, nxt,
                               frame_type: int, idx_rate: float, sl: slice):
        """Staged rANS decode of the fused stream (K2) interleaved with
        the hyper and synthesis stages -> (q_c of the whole wave; mu_c,
        pred, skip of this rank's slice ``sl``)."""
        k = len(chunks)
        with tracing.span("batch.parse"):
            parsed = [vrans.parse_chunk_v2(c["codecnet_z"]) for c in chunks]
            kk = parsed[0][2]
            if any(p[2] != kk for p in parsed):
                raise ValueError("inconsistent vrans stream counts in a wave")
            v2 = parsed[0][3] is not None
            if any((p[3] is not None) != v2 for p in parsed):
                raise ValueError("mixed v1/v2 vrans chunks in a wave")
            cm, cc = self.cfg.mofnet.nb_ft_y, self.cfg.codecnet.nb_ft_y
            if v2:
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
                idxc, nkc = self._pack_idx(ch_c, bc)
                _, segs = self._fused_n2(frame_type, kk, bm, bc)
            else:
                _, segs = self._fused_n(frame_type, kk)
            seg_it = iter(segs)

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
            q_c, st, g = self._dec_y_el(words, st, g, bins_c, idxc, nkc,
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

    # ------------------------------------------------------------------
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


def make_codec(cfg, model, height: int, width: int, **kw) -> FrameCodec:
    """The codec of a loaded model: FrameCodec for AIVC's FullNet, its
    All-Intra subclass ElicCodec (pipeline/elic.py) for ELIC."""
    from aivc_tpu_torch.config import ElicConfig

    if isinstance(cfg, ElicConfig):
        from aivc_tpu_torch.pipeline.elic import ElicCodec
        return ElicCodec(cfg, model, height, width, **kw)
    return FrameCodec(cfg, model, height, width, **kw)
