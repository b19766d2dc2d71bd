"""Sequence-level encode / decode / evaluate (counterpart of
aivc_tpu/pipeline/video.py): consecutive GOPs, the last one padded by
repeating the final frame, frames coded wave by wave with references
taken from the codec's own decoded output, and a self-describing muxed
bitstream.  All-Intra with wave_batch > 1 batches consecutive frames
across GOP boundaries; ``stream_dir`` makes an encode resumable
(``GopStreamStore``); either entropy backend's stream decodes, from the
video header's flag."""

from __future__ import annotations

import dataclasses
import json
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from aivc_tpu_torch.coding import bitstream as bs
from aivc_tpu_torch.config import FRAME_I, CodingConfig
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
    # Analytic bits under the coder's own quantized CDFs (0.0 unless the
    # codec runs with audit=True); real-vs-analytic overhead mirrors the
    # reference's sequence report (src/real_life/encode.py:153-170).
    analytic_bits: float = 0.0


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


def _frame_result(idx: int, frame_type: int, st: Dict,
                  n_pix: int) -> FrameResult:
    return FrameResult(
        idx=idx, frame_type=frame_type, bytes=st["bytes"],
        mode_bytes=st["mode_bytes"], codec_bytes=st["codec_bytes"],
        alpha_mean=st["alpha_mean"], beta_mean=st["beta_mean"],
        bpp=st["bytes"] * 8.0 / n_pix,
        analytic_bits=st.get("analytic_bits", 0.0))


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
            results.append(_frame_result(first_idx + spec.idx,
                                         spec.frame_type, st, n_pix))
    header = bs.GopHeader(gop_struct_name=gop.name, idx_rate=idx_rate)
    frames = [by_order[o] for o in sorted(by_order)]
    return bs.pack_gop(header, frames), {first_idx + k: v
                                         for k, v in decoded.items()}


class GopStreamStore:
    """Crash-salvageable per-GOP encode state (aivc_tpu/pipeline/video.py:
    GopStreamStore; the same files and manifest keys).

    Each finished GOP (or All-Intra frame) is written atomically to
    <dir>/gop_NNNNN.bin with its per-frame stats beside it in
    gop_NNNNN.json; manifest.json pins every setting the bytes depend on,
    so a resume with other settings is refused instead of mixing
    incompatible chunks."""

    def __init__(self, directory: str, meta: Dict):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        mf = self.dir / "manifest.json"
        if mf.exists():
            old = json.loads(mf.read_text())
            if old != meta:
                diff = {k: (old.get(k), meta.get(k))
                        for k in set(old) | set(meta)
                        if old.get(k) != meta.get(k)}
                raise ValueError(
                    f"stream_dir {directory} belongs to a different encode "
                    f"(mismatched: {diff}); use a fresh directory")
        else:
            tmp = mf.with_suffix(".tmp")
            tmp.write_text(json.dumps(meta, indent=2))
            tmp.rename(mf)

    def _chunk(self, g: int) -> Path:
        return self.dir / f"gop_{g:05d}.bin"

    def has(self, g: int) -> bool:
        return self._chunk(g).exists()

    def load(self, g: int) -> bytes:
        return self._chunk(g).read_bytes()

    def save(self, g: int, data: bytes, frame_results: List[FrameResult]):
        tmp = self._chunk(g).with_suffix(".tmp")
        tmp.write_bytes(data)
        tmp.rename(self._chunk(g))
        rows = [dataclasses.asdict(r) for r in frame_results]
        rf = self.dir / f"gop_{g:05d}.json"
        tmp = rf.with_suffix(".tmp")
        tmp.write_text(json.dumps(rows))
        tmp.rename(rf)

    def load_results(self, g: int) -> List[FrameResult]:
        rows = json.loads((self.dir / f"gop_{g:05d}.json").read_text())
        return [FrameResult(**r) for r in rows]


def _decode_gop_chunk(codec: FrameCodec, gop_bytes: bytes, wave_batch: int,
                      backend: str, resumed: bool = False
                      ) -> Dict[int, DecodedFrame]:
    """Decode one packed GOP chunk (indices local to the GOP).  For a
    ``resumed`` encode, each wave's bytes also replay the encoder's K
    policy (FrameCodec.note_coded_wave)."""
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
            gop_header.idx_rate, backend=backend)
        for spec, dec in zip(specs, decs):
            decoded[spec.idx] = dec
        if resumed:
            codec.note_coded_wave(ftype, [by_order[s.coding_order]
                                          for s in specs])
    return decoded


def _ai_groups(n: int, wave_batch: int):
    """All-Intra batches: consecutive frames in groups of wave_batch,
    across GOP boundaries (derived from the frame count alone, so the
    decoder regroups identically)."""
    return [list(range(s, min(s + wave_batch, n)))
            for s in range(0, n, wave_batch)]


def _encode_all_intra(codec: FrameCodec, frames, idx_rate: float,
                      name: str, wave_batch: int, store, results,
                      decoded_all) -> List[bytes]:
    """All-Intra fast path: frames are independent, so they batch across
    GOP boundaries; one single-frame GOP chunk per frame."""
    n_pix = codec.h * codec.w
    header0 = bs.GopHeader(gop_struct_name=name, idx_rate=idx_rate)
    chunks_out: List[bytes] = []
    for group in _ai_groups(len(frames), wave_batch):
        if store is not None and all(store.has(i) for i in group):
            # Resume: reload the whole batch and re-decode it at the
            # grouping the encoder used.
            chunks = [store.load(i) for i in group]
            chunks_out.extend(chunks)
            for i in group:
                results.extend(store.load_results(i))
            fbs = [bs.unpack_gop(c)[1][0] for c in chunks]
            decs = codec.decode_frames_batch(
                fbs, [None] * len(group), [None] * len(group), FRAME_I,
                idx_rate, backend=codec.backend)
            codec.note_coded_wave(FRAME_I, fbs)
            decoded_all.update(zip(group, decs))
            continue
        fbs, decs, stats = codec.encode_frames_batch(
            [frames[i] for i in group], [None] * len(group),
            [None] * len(group), FRAME_I, idx_rate)
        for i, fb, dec, st in zip(group, fbs, decs, stats):
            chunk = bs.pack_gop(header0, [fb])
            chunks_out.append(chunk)
            decoded_all[i] = dec
            fr = _frame_result(i, FRAME_I, st, n_pix)
            results.append(fr)
            if store is not None:
                store.save(i, chunk, [fr])
    return chunks_out


def encode_video(codec: FrameCodec, frames: Sequence[Dict[str, np.ndarray]],
                 coding: CodingConfig, wave_batch: int = 1,
                 stream_dir: Optional[str] = None) -> EncodeResult:
    """Encode a sequence of uint8 YUV420 frames into one bitstream.
    wave_batch is recorded in the video header.  With ``stream_dir``
    every finished GOP is kept there, and a rerun with the same directory
    encodes only the missing ones (the finished ones are re-decoded to
    rebuild the references)."""
    name = coding.gop_struct_name()
    gop = generate_gop_struct(name)
    gop_len = len(gop)
    n_frames = len(frames)
    if n_frames > 65536:
        raise ValueError(f"{n_frames} frames exceed the 2-byte frame-index "
                         "header range; encode in segments")
    nb_gop = -(-n_frames // gop_len)
    t0 = time.time()
    results: List[FrameResult] = []
    chunks: List[bytes] = []
    decoded_all: Dict[int, DecodedFrame] = {}
    store = None
    if stream_dir is not None:
        store = GopStreamStore(stream_dir, {
            "n_frames": n_frames, "gop": name, "h": codec.h, "w": codec.w,
            "idx_rate": coding.idx_rate, "wave_batch": wave_batch,
            "backend": codec.backend, "model": codec.cfg.name,
            # v2 (elided) or dense v1 fused stream
            "elide": codec.elide,
        })

    if gop_len == 1 and wave_batch > 1:
        chunks = _encode_all_intra(codec, frames, coding.idx_rate, name,
                                   wave_batch, store, results, decoded_all)
    else:
        for g in range(nb_gop):
            start = g * gop_len
            if store is not None and store.has(g):
                gop_bytes = store.load(g)
                results.extend(store.load_results(g))
                decoded = {start + k: v for k, v in _decode_gop_chunk(
                    codec, gop_bytes, wave_batch, codec.backend,
                    resumed=True).items()}
            else:
                # The tail is padded by repeating the last frame.
                gop_frames = [frames[min(start + i, n_frames - 1)]
                              for i in range(gop_len)]
                n_before = len(results)
                gop_bytes, decoded = encode_gop(
                    codec, gop, gop_frames, coding.idx_rate, start, results,
                    wave_batch=wave_batch)
                if store is not None:
                    store.save(g, gop_bytes, results[n_before:])
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


def decode_video(codec: FrameCodec, data: bytes,
                 wave_batch: Optional[int] = None
                 ) -> Dict[int, DecodedFrame]:
    """Decode a muxed bitstream with the model alone: the wave grouping,
    alphabet, schedule and entropy backend come from the video header.
    Passing wave_batch is only a cross-check: a value other than the
    header's raises, since another grouping is not bit-exact."""
    header, gop_chunks = bs.unpack_video(data)
    if (1 << header.ac_log2) != codec.ac_max:
        raise ValueError(
            f"bitstream alphabet +-{1 << header.ac_log2} != the model's "
            f"ac_max_val {codec.ac_max}")
    codec.check_sched(header)
    if wave_batch is None:
        wave_batch = header.wave_batch
    elif wave_batch != header.wave_batch:
        raise ValueError(
            f"wave_batch {wave_batch} does not match the bitstream header's "
            f"{header.wave_batch}; decoding with a different wave grouping "
            "is not bit-exact (omit the argument to use the header)")
    backend = "device" if header.backend == bs.BACKEND_DEVICE else "host"
    decoded_all: Dict[int, DecodedFrame] = {}
    first_idx = header.idx_first_frame

    if wave_batch > 1 and gop_chunks:
        probe_header, probe_frames = bs.unpack_gop(gop_chunks[0])
        if (probe_header.gop_struct_name == "1_GOP_0"
                and len(probe_frames) == 1):
            # All-Intra: regroup the single-frame GOPs as the encoder did.
            frame_bytes = [bs.unpack_gop(g)[1][0] for g in gop_chunks]
            for group in _ai_groups(len(frame_bytes), wave_batch):
                decs = codec.decode_frames_batch(
                    [frame_bytes[i] for i in group], [None] * len(group),
                    [None] * len(group), FRAME_I, probe_header.idx_rate,
                    backend=backend)
                for i, dec in zip(group, decs):
                    decoded_all[first_idx + i] = dec
            return {k: v for k, v in decoded_all.items()
                    if k <= header.idx_last_frame}

    for gop_bytes in gop_chunks:
        decoded = _decode_gop_chunk(codec, gop_bytes, wave_batch, backend)
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
