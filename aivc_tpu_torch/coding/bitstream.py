"""Bitstream layout: latent chunks, frame/GOP/video framing, headers (a
copy of aivc_tpu/coding/bitstream.py).

Byte layout mirrors the reference formats so capability parity is easy to
audit (format compatibility with reference bitstreams is a non-goal; our
decoder decodes our encoder bit-exactly):

Frame = 4 chunks in fixed order mofnet_z, mofnet_y, codecnet_z, codecnet_y,
each [4-byte BE length][payload]; I-frames carry two zero-length MOFNet
placeholders so the layout is invariant
(reference: src/real_life/bitstream.py:22-56,292-296,395-408).

y-chunk payload = [1 byte n_nonzero_channels][channel indices, 1 byte each]
[rANS bytes] — the zero-feature-map elision (bitstream.py:237-255).
z-chunk payload = [rANS bytes].

GOP chunk  = 6-byte GOP header + per-frame [4-byte length][frame bytes]
             (reference: src/real_life/header.py:22-28,
              src/real_life/cat_binary_files.py:19-41).
Video file = 19-byte video header + per-GOP [4-byte length][GOP bytes]
             (reference: header.py:30-41, cat_binary_files.py:104-127).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from aivc_tpu_torch.coding import range_coder

CHUNK_ORDER = ("mofnet_z", "mofnet_y", "codecnet_z", "codecnet_y")


# ---------------------------------------------------------------------------
# Latent chunk payloads
# ---------------------------------------------------------------------------

def encode_z_chunk(z: np.ndarray, cdf_rows: np.ndarray) -> bytes:
    """Encode a hyper-latent [H, W, C] int array with per-channel CDF rows.

    The alphabet (symbol shift and width) derives from the CDF row width:
    rows are [R, 2*ac_max + 1] and symbols live in [-ac_max, ac_max-1]."""
    H, W, C = z.shape
    n_sym = cdf_rows.shape[1] - 1
    sym = (z.astype(np.int64) + n_sym // 2)
    if sym.min() < 0 or sym.max() >= n_sym:
        raise ValueError("z symbol out of range")
    row_idx = np.broadcast_to(np.arange(C, dtype=np.int32), (H, W, C))
    return range_coder.encode(
        sym.reshape(-1).astype(np.uint16),
        cdf_rows,
        row_idx.reshape(-1),
    )


def decode_z_chunk(data: bytes, shape: Tuple[int, int, int],
                   cdf_rows: np.ndarray) -> np.ndarray:
    H, W, C = shape
    row_idx = np.broadcast_to(np.arange(C, dtype=np.int32), (H, W, C))
    sym = range_coder.decode(data, H * W * C, cdf_rows, row_idx.reshape(-1))
    return (sym.reshape(H, W, C).astype(np.int32)
            - (cdf_rows.shape[1] - 1) // 2)


def encode_y_chunk(y: np.ndarray, bin_idx: np.ndarray,
                   laplace_rows: np.ndarray) -> bytes:
    """Encode a main latent [H, W, C] with per-element scale-bin indices.

    Applies zero-feature-map elision: channels that are entirely zero are
    skipped and only their indices' absence signals them
    (reference: bitstream.py:237-255).
    """
    H, W, C = y.shape
    if C > 255:
        raise ValueError("zero-map elision header supports at most 255 channels")
    nonzero = np.where(np.abs(y).sum(axis=(0, 1)) != 0)[0]
    out = bytearray()
    out.append(len(nonzero))
    out.extend(int(c) for c in nonzero)
    if len(nonzero):
        n_sym = laplace_rows.shape[1] - 1
        y_nz = y[:, :, nonzero]
        sym = y_nz.astype(np.int64) + n_sym // 2
        if sym.min() < 0 or sym.max() >= n_sym:
            raise ValueError("y symbol out of range")
        idx_nz = bin_idx[:, :, nonzero]
        out.extend(range_coder.encode(
            sym.reshape(-1).astype(np.uint16),
            laplace_rows,
            idx_nz.reshape(-1).astype(np.int32),
        ))
    return bytes(out)


def decode_y_chunk(data: bytes, shape: Tuple[int, int, int],
                   bin_idx: np.ndarray, laplace_rows: np.ndarray) -> np.ndarray:
    H, W, C = shape
    n_nz = data[0]
    nonzero = list(data[1:1 + n_nz])
    payload = data[1 + n_nz:]
    y = np.zeros((H, W, C), dtype=np.int32)
    if n_nz:
        idx_nz = bin_idx[:, :, nonzero]
        sym = range_coder.decode(
            payload, H * W * n_nz, laplace_rows,
            idx_nz.reshape(-1).astype(np.int32),
        )
        y[:, :, nonzero] = (sym.reshape(H, W, n_nz).astype(np.int32)
                            - (laplace_rows.shape[1] - 1) // 2)
    return y


# ---------------------------------------------------------------------------
# Frame framing
# ---------------------------------------------------------------------------

# In-band debug trailer magic: under --bitstream_debug each frame carries
# md5 digests of its DECODED latent tensors after the 4 chunks, so drift
# detection travels with the stream and the decoder can name the exact
# latent that rotted (reference: src/real_life/bitstream.py:229-234,
# 419-421,488-499 embeds per-latent md5s the same way).  Layout:
#   [0xD5][count][count x (1-byte CHUNK_ORDER index, 16-byte md5)]
DEBUG_TRAILER_MAGIC = 0xD5

# Closed-loop DC-offset trailer (sched bit 16, AIVC_DC_OFFSET): three
# signed bytes — the per-plane (Y, U, V) luminance offsets the encoder
# measured between the source frame and its own reconstruction, applied
# to the decoded planes INSIDE the reference loop on both sides.  The
# MS-SSIM-trained models carry a systematic DC bias (MS-SSIM is nearly
# blind to it: only the coarsest pyramid scale has a luminance term) —
# measured +43 luma levels on the first P-frame, ~86% of its MSE, and
# the LDP P-chain compounds it to +61 (12 dB PSNR at 0.90 MS-SSIM,
# docs/STATUS.md round 5).  Classic codecs spend header bytes on exactly
# this class of closed-loop correction (HEVC SAO band offsets); 3
# bytes/frame here buys back most of that MSE.
DC_TRAILER_MAGIC = 0xDC


def latent_md5(arr: np.ndarray) -> bytes:
    """16-byte md5 of a latent tensor in canonical int32 bytes (both
    backends' int16/int32 views hash identically)."""
    import hashlib

    return hashlib.md5(
        np.ascontiguousarray(np.asarray(arr).astype(np.int32))
        .tobytes()).digest()


def pack_frame(chunks: Dict[str, bytes],
               digests: Dict[str, bytes] | None = None,
               dc: tuple | None = None) -> bytes:
    """Concatenate the 4 length-prefixed chunks in canonical order.
    Missing MOFNet chunks (I-frames) become zero-length placeholders.
    ``digests`` (chunk name -> 16-byte md5 of the decoded latent) appends
    the in-band debug trailer; ``dc`` (3 ints in [-127, 127]) appends the
    closed-loop DC-offset trailer."""
    out = bytearray()
    for name in CHUNK_ORDER:
        payload = chunks.get(name, b"")
        out.extend(len(payload).to_bytes(4, "big"))
        out.extend(payload)
    if dc is not None:
        if len(dc) != 3 or not all(-127 <= int(v) <= 127 for v in dc):
            raise ValueError(f"dc trailer needs 3 ints in [-127, 127]: {dc}")
        out.append(DC_TRAILER_MAGIC)
        out.extend((int(v) & 0xFF) for v in dc)
    if digests:
        out.append(DEBUG_TRAILER_MAGIC)
        out.append(len(digests))
        for name in CHUNK_ORDER:
            if name in digests:
                dg = digests[name]
                if len(dg) != 16:
                    raise ValueError(f"digest for {name} must be 16 bytes")
                out.append(CHUNK_ORDER.index(name))
                out.extend(dg)
    return bytes(out)


def unpack_frame(data: bytes) -> Dict[str, bytes]:
    """Split a frame container; optional trailers surface as
    '__dc__' (3-int tuple) and '__digests__' (chunk name -> md5)."""
    chunks = {}
    pos = 0
    for name in CHUNK_ORDER:
        n = int.from_bytes(data[pos:pos + 4], "big")
        pos += 4
        chunks[name] = data[pos:pos + n]
        pos += n
    while pos < len(data) and data[pos] in (DC_TRAILER_MAGIC,
                                            DEBUG_TRAILER_MAGIC):
        if data[pos] == DC_TRAILER_MAGIC:
            if len(data) - pos < 4:
                raise ValueError("truncated DC trailer")
            chunks["__dc__"] = tuple(
                v - 256 if v > 127 else v for v in data[pos + 1:pos + 4])
            pos += 4
            continue
        left = len(data) - pos
        if left < 2 or left < 2 + 17 * data[pos + 1]:
            raise ValueError("truncated debug trailer")
        count = data[pos + 1]
        pos += 2
        digests = {}
        for _ in range(count):
            digests[CHUNK_ORDER[data[pos]]] = data[pos + 1:pos + 17]
            pos += 17
        chunks["__digests__"] = digests
    if pos != len(data):
        raise ValueError(f"trailing bytes in frame bitstream ({len(data) - pos})")
    return chunks


# ---------------------------------------------------------------------------
# Headers
# ---------------------------------------------------------------------------

# Latent-chunk coding backends (signalled in the video header so the
# decoder self-selects; the reference has a single implicit backend).
BACKEND_HOST = 0     # host rANS over int16 latents (coding/range_coder.py)
BACKEND_DEVICE = 1   # on-device vectorized rANS (coding/vrans.py)


@dataclass(frozen=True)
class VideoHeader:
    """20-byte video header: the reference's 18-byte layout
    (reference: header.py:30-41,74-83) plus one flags byte recording the
    entropy-coding backend of the latent chunks and one byte recording
    the encoder's wave_batch.  wave_batch is part of the determinism
    contract (XLA may round floats differently per batch size, see
    pipeline/video.py:wave_groups), so it must ride in the bitstream for
    `decode_video(bytes)` to need nothing out-of-band — the reference
    decoder's closed-loop property (src/real_life/decode.py:44-155)."""

    h_x: int
    w_x: int
    h_y: int
    w_y: int
    h_z: int
    w_z: int
    nb_gop: int
    idx_first_frame: int
    idx_last_frame: int
    backend: int = BACKEND_HOST
    wave_batch: int = 1
    # log2 of the model's entropy-coding alphabet half-width
    # (ModelConfig.ac_max_val; 8 = the reference's +-256).  Recorded so a
    # decoder holding a model with a different alphabet fails loudly
    # instead of producing garbage latents.
    ac_log2: int = 8
    # Compute-schedule bits (bit0 = lane-packed synthesis heads, bit1 =
    # low-precision GDN params, bit2 = channel-major MOFNet maps, bit3 =
    # space-to-depth analysis convs, bit4 = closed-loop DC-offset
    # correction).  The schedule changes floating-point
    # sum order, so the decoder must run the SAME schedule to reproduce
    # the encoder's reconstructions bit-exactly; recording it makes the
    # stream self-describing and lets a mismatched decoder fail loudly
    # instead of drifting through the GOP reference chain.
    sched: int = 0

    SIZE = 22

    def pack(self) -> bytes:
        if not (1 <= self.wave_batch <= 255):
            raise ValueError(f"wave_batch {self.wave_batch} outside [1, 255]")
        vals = (self.h_x, self.w_x, self.h_y, self.w_y, self.h_z, self.w_z,
                self.nb_gop, self.idx_first_frame, self.idx_last_frame)
        return b"".join(v.to_bytes(2, "big") for v in vals) + bytes(
            [self.backend, self.wave_batch, self.ac_log2, self.sched])

    @classmethod
    def unpack(cls, data: bytes) -> "VideoHeader":
        vals = [int.from_bytes(data[2 * i:2 * i + 2], "big") for i in range(9)]
        return cls(*vals, backend=data[18], wave_batch=max(1, data[19]),
                   ac_log2=data[20] or 8, sched=data[21])

    @property
    def data_dim(self) -> Dict[str, Tuple[int, int]]:
        """Shapes for x/y/z planes; UV is ceil(x/2)
        (reference: header.py:116-126)."""
        return {
            "x": (self.h_x, self.w_x),
            "y": (self.h_y, self.w_y),
            "z": (self.h_z, self.w_z),
            "x_uv": (math.ceil(self.h_x / 2), math.ceil(self.w_x / 2)),
        }


@dataclass(frozen=True)
class GopHeader:
    """6-byte GOP header (reference: header.py:22-28,156-170).

    idx_rate is stored as round(idx_rate * 16) in one byte, so the
    continuously-variable rate index has 1/16 granularity in [0, 15.9375].
    """

    gop_struct_name: str
    idx_rate: float

    SIZE = 6

    def pack(self) -> bytes:
        if not (0.0 <= self.idx_rate <= 255 / 16):
            raise ValueError(
                f"idx_rate {self.idx_rate} outside the 1-byte header range "
                f"[0, {255 / 16}]")
        parts = self.gop_struct_name.split("_")
        flag_ldp = "LDP" in parts
        gop_size = int(parts[-1])
        nb_chained = 0 if flag_ldp else int(parts[0])
        out = bytearray()
        out.append(1 if flag_ldp else 0)
        out.extend(nb_chained.to_bytes(2, "big"))
        out.extend(gop_size.to_bytes(2, "big"))
        out.append(int(round(self.idx_rate * 16)))
        return bytes(out)

    @classmethod
    def unpack(cls, data: bytes) -> "GopHeader":
        flag_ldp = bool(data[0])
        nb_chained = int.from_bytes(data[1:3], "big")
        gop_size = int.from_bytes(data[3:5], "big")
        idx_rate = data[5] / 16.0
        name = f"LDP_{gop_size}" if flag_ldp else f"{nb_chained}_GOP_{gop_size}"
        return cls(gop_struct_name=name, idx_rate=idx_rate)


# ---------------------------------------------------------------------------
# GOP / video mux-demux
# ---------------------------------------------------------------------------

def pack_gop(header: GopHeader, frames_in_coding_order: List[bytes]) -> bytes:
    out = bytearray(header.pack())
    for fb in frames_in_coding_order:
        out.extend(len(fb).to_bytes(4, "big"))
        out.extend(fb)
    return bytes(out)


def unpack_gop(data: bytes) -> Tuple[GopHeader, List[bytes]]:
    """-> (header, the frames): views of ``data``, not copies (a stream of
    tens of MB is sliced at each level of its framing)."""
    data = memoryview(data)
    header = GopHeader.unpack(data[:GopHeader.SIZE])
    frames = []
    pos = GopHeader.SIZE
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        pos += 4
        frames.append(data[pos:pos + n])
        pos += n
    return header, frames


def pack_video(header: VideoHeader, gops: List[bytes]) -> bytes:
    out = bytearray(header.pack())
    for gb in gops:
        out.extend(len(gb).to_bytes(4, "big"))
        out.extend(gb)
    return bytes(out)


def unpack_video(data: bytes) -> Tuple[VideoHeader, List[bytes]]:
    """-> (header, the GOPs): views of ``data``, not copies."""
    data = memoryview(data)
    header = VideoHeader.unpack(data[:VideoHeader.SIZE])
    gops = []
    pos = VideoHeader.SIZE
    for _ in range(header.nb_gop):
        n = int.from_bytes(data[pos:pos + 4], "big")
        pos += 4
        gops.append(data[pos:pos + n])
        pos += n
    if pos != len(data):
        raise ValueError(f"trailing bytes in video bitstream ({len(data) - pos})")
    return header, gops
