"""Sequence-level encode / decode / evaluate (counterpart of
aivc_tpu/pipeline/video.py): consecutive GOPs, the last one padded by
repeating the final frame, frames coded wave by wave with references
taken from the codec's own decoded output, and a self-describing muxed
bitstream.  Resumable encodes and batched All-Intra wait for a later
slice."""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from aivc_tpu_torch.coding import bitstream as bs
from aivc_tpu_torch.config import CodingConfig
from aivc_tpu_torch.device import resolve_device
from aivc_tpu_torch.gop import GopStruct, generate_gop_struct
from aivc_tpu_torch.ops.metrics import msssim
from aivc_tpu_torch.pipeline.codec import (
    DecodedFrame,
    FrameCodec,
    planes_to_444,
)


@dataclass
class FrameResult:
    idx: int
    frame_type: int
    bytes: int
    mode_bytes: int
    codec_bytes: int
    alpha_mean: float
    beta_mean: float
    bpp: float


@dataclass
class EncodeResult:
    bitstream: bytes
    frame_results: List[FrameResult]
    decoded_frames: Dict[int, DecodedFrame]
    fps: float

    @property
    def total_bytes(self) -> int:
        return len(self.bitstream)


def _ref(decoded: Dict[int, DecodedFrame], idx: Optional[int]):
    return None if idx is None else decoded[idx].ref


def wave_groups(gop: GopStruct, max_batch: int):
    """wave -> split by frame type -> chunks of at most max_batch, coding
    order kept.  Encoder and decoder derive it from the GOP alone: it is
    part of the bit-exactness contract."""
    groups = []
    for wave in gop.waves():
        by_type: Dict[int, list] = {}
        for f in sorted(wave, key=lambda f: f.coding_order):
            by_type.setdefault(f.frame_type, []).append(f)
        for ftype in sorted(by_type):
            specs = by_type[ftype]
            for i in range(0, len(specs), max_batch):
                groups.append((ftype, specs[i:i + max_batch]))
    return groups


def encode_gop(codec: FrameCodec, gop: GopStruct,
               frames_u8: Sequence[Dict[str, np.ndarray]], idx_rate: float,
               first_idx: int, results: List[FrameResult],
               wave_batch: int = 1):
    """Encode one GOP (frames in display order).  Returns (packed GOP
    bytes, decoded frames by absolute index)."""
    decoded: Dict[int, DecodedFrame] = {}
    by_order: Dict[int, bytes] = {}
    n_pix = codec.h * codec.w
    for ftype, specs in wave_groups(gop, max(1, wave_batch)):
        fbs, decs, stats = codec.encode_frames_batch(
            [frames_u8[s.idx] for s in specs],
            [_ref(decoded, s.prev_ref) for s in specs],
            [_ref(decoded, s.next_ref) for s in specs], ftype, idx_rate)
        for spec, fb, dec, st in zip(specs, fbs, decs, stats):
            decoded[spec.idx] = dec
            by_order[spec.coding_order] = fb
            results.append(FrameResult(
                idx=first_idx + spec.idx, frame_type=spec.frame_type,
                bytes=st["bytes"], mode_bytes=st["mode_bytes"],
                codec_bytes=st["codec_bytes"], alpha_mean=st["alpha_mean"],
                beta_mean=st["beta_mean"], bpp=st["bytes"] * 8.0 / n_pix))
    header = bs.GopHeader(gop_struct_name=gop.name, idx_rate=idx_rate)
    frames = [by_order[o] for o in sorted(by_order)]
    return bs.pack_gop(header, frames), {first_idx + k: v
                                         for k, v in decoded.items()}


def encode_video(codec: FrameCodec, frames: Sequence[Dict[str, np.ndarray]],
                 coding: CodingConfig, wave_batch: int = 1) -> EncodeResult:
    """Encode a sequence of uint8 YUV420 frames into one bitstream.
    wave_batch is recorded in the video header."""
    gop = generate_gop_struct(coding.gop_struct_name())
    gop_len = len(gop)
    n_frames = len(frames)
    if n_frames > 65536:
        raise ValueError(f"{n_frames} frames exceed the 2-byte frame-index "
                         "header range; encode in segments")
    if gop_len == 1 and wave_batch > 1:
        raise NotImplementedError(
            "batched All-Intra coding waits for a later slice")
    nb_gop = -(-n_frames // gop_len)
    t0 = time.time()
    results: List[FrameResult] = []
    chunks: List[bytes] = []
    decoded_all: Dict[int, DecodedFrame] = {}
    for g in range(nb_gop):
        start = g * gop_len
        gop_frames = [frames[min(start + i, n_frames - 1)]
                      for i in range(gop_len)]
        gop_bytes, decoded = encode_gop(codec, gop, gop_frames,
                                        coding.idx_rate, start, results,
                                        wave_batch=wave_batch)
        chunks.append(gop_bytes)
        decoded_all.update({k: v for k, v in decoded.items()
                            if k < n_frames})
    header = codec.video_header(nb_gop, 0, n_frames - 1,
                                wave_batch=wave_batch)
    video = bs.pack_video(header, chunks)
    elapsed = max(time.time() - t0, 1e-9)
    return EncodeResult(bitstream=video,
                        frame_results=[r for r in results
                                       if r.idx < n_frames],
                        decoded_frames=decoded_all, fps=n_frames / elapsed)


def decode_video(codec: FrameCodec, data: bytes) -> Dict[int, DecodedFrame]:
    """Decode a muxed bitstream with the model alone: the wave grouping,
    alphabet and schedule come from the video header."""
    header, gop_chunks = bs.unpack_video(data)
    if (1 << header.ac_log2) != codec.ac_max:
        raise ValueError(
            f"bitstream alphabet +-{1 << header.ac_log2} != the model's "
            f"ac_max_val {codec.ac_max}")
    codec.check_sched(header)
    if header.backend != bs.BACKEND_DEVICE:
        raise NotImplementedError("host-backend streams wait for a later "
                                  "slice")
    wave_batch = header.wave_batch
    decoded_all: Dict[int, DecodedFrame] = {}
    first_idx = header.idx_first_frame
    for gop_bytes in gop_chunks:
        gop_header, frame_chunks = bs.unpack_gop(gop_bytes)
        gop = generate_gop_struct(gop_header.gop_struct_name)
        by_order = {spec.coding_order: fb
                    for spec, fb in zip(gop.coding_order, frame_chunks)}
        decoded: Dict[int, DecodedFrame] = {}
        for ftype, specs in wave_groups(gop, max(1, wave_batch)):
            decs = codec.decode_frames_batch(
                [by_order[s.coding_order] for s in specs],
                [_ref(decoded, s.prev_ref) for s in specs],
                [_ref(decoded, s.next_ref) for s in specs], ftype,
                gop_header.idx_rate)
            for spec, dec in zip(specs, decs):
                decoded[spec.idx] = dec
        decoded_all.update({first_idx + k: v for k, v in decoded.items()})
        first_idx += len(decoded)
    return {k: v for k, v in decoded_all.items()
            if k <= header.idx_last_frame}


def evaluate_frames(orig: Sequence[Dict[str, np.ndarray]],
                    decoded: Dict[int, DecodedFrame],
                    device=None) -> Dict[str, float]:
    """PSNR / MS-SSIM between original and decoded uint8 YUV420 frames,
    pixel-count weighted over the planes (aivc_tpu/pipeline/video.py:
    401-448).  MS-SSIM is taken per frame and per plane, averaged over the
    frames, then weighted by the plane's pixel count; it runs in float32
    on the card unless ``device`` names another."""
    dev = resolve_device(device)
    tot_se = 0.0
    tot_n = 0
    ms_num = 0.0
    ms_den = 0
    for k in ("y", "u", "v"):
        a = np.stack([f[k] for f in orig]).astype(np.float64) / 255.0
        b = np.stack([decoded[i][k] for i in range(len(orig))]
                     ).astype(np.float64) / 255.0
        tot_se += ((a - b) ** 2).sum()
        tot_n += a.size
        ta = torch.from_numpy(a.astype(np.float32)).to(dev)
        tb = torch.from_numpy(b.astype(np.float32)).to(dev)
        ms_k = [float(msssim(ta[i][None, None], tb[i][None, None]))
                for i in range(len(orig))]
        ms_num += float(np.mean(ms_k)) * a[0].size
        ms_den += a[0].size
    mse = tot_se / tot_n
    ms_mean = ms_num / ms_den
    return {
        "psnr": 10.0 * np.log10(1.0 / max(mse, 1e-12)),
        "ms_ssim": ms_mean,
        "ms_ssim_db": -10.0 * np.log10(max(1.0 - ms_mean, 1e-12)),
    }


def frames_444(frames: Sequence[Dict[str, np.ndarray]],
                device) -> List[torch.Tensor]:
    """uint8 YUV420 frames -> edge-padded float 444 [1, 3, Hp, Wp] each
    on ``device``: the input of FullNet.forward_frame and gop_rd_loss."""
    return [planes_to_444(*[torch.from_numpy(np.ascontiguousarray(
        f[c][None])).to(device) for c in ("y", "u", "v")]) for f in frames]


def synthetic_frames(n: int, h: int, w: int, seed: int = 0):
    """Smooth, slowly moving synthetic YUV420 clip (a copy of bench.py's
    synthetic_frames)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    phase = rng.uniform(0, 6.28, size=3)
    for t in range(n):
        y = (128 + 60 * np.sin(xx / 37.0 + 0.12 * t + phase[0])
             + 50 * np.cos(yy / 23.0 - 0.07 * t + phase[1]))
        u = 128 + 30 * np.sin((xx + yy) / 51.0 + 0.05 * t + phase[2])
        hc, wc = (h + 1) // 2, (w + 1) // 2
        frames.append({
            "y": np.clip(y, 0, 255).astype(np.uint8),
            "u": np.clip(u[::2, ::2], 0, 255).astype(np.uint8)[:hc, :wc],
            "v": np.clip(255 - u[::2, ::2], 0, 255).astype(np.uint8)[:hc, :wc],
        })
    return frames
