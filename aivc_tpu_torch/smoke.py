"""Phases of the port's smoke run (``chip_smoke.py`` at the repo root).

Every phase is a function of the device and the frame size, so a CPU test
can rehearse the whole sequence at a tiny size (there the kernel wrappers
take their plain versions).  On the card:

  device   name, count and power limit of the card
  build    nvcc time and the ptxas register / shared-memory report
  load     the checkpoint through the port's loader, the codec
  kernels  K1, K2, K3 once at main-path shapes against their plain
           versions on the same inputs, each timed beside its bound (K1
           and K2 also per dependent step)
  main     a 9-frame RA clip (GOP 8) encoded then decoded through the
           entry points, bit-exact, with every kernel's launch count and
           the steps K1 walked in the encode and K2 in the decode; then
           a second encode of the clip captures the inputs of one K3
           launch (a B-frame wave), on which K3 is checked and timed
  small    the same clip at 64x64 on the card and on the host, which
           must agree within the stated tolerance
  forward  the RD forward (gop_rd_loss, eval) of a 9-frame GOP with the
           float warp under AIVC_WARP=pallas (kernel K5), with the inputs
           of six CodecNet GDN layers captured on the way; the warm-up
           forward before it captures the inputs of one B-frame K5 launch
  forward-small
           the forward at 128x128 on the card and on the host, which
           must agree within the stated tolerance
  kernels  K5 at the forward path's shapes on random flows and on the
           captured B-frame flows, and K4 (the exported gdn_fused, which
           no model calls) on the six captured GDN inputs, against their
           plain versions on the same inputs (K4's bf16 path within
           GDN_PLAIN_ULPS), each timed beside its bound (K5 also with L2
           cold); then the GDN layers' kernel (K4 at gdn_apply's
           rounding points) at the codec's largest shapes, a wave of 8,
           every image against its plain version, NCHW and
           channels-last (``check_gdn_layer``); then the conv stage K6 at
           the codec's shapes, bit for bit against its plain version
           (``check_conv_stage``)
  (the CLI and training phases: ``cli_runs``, ``train_small``,
  ``train_recipe``)
  golden   the golden suite's pins (eval/golden.py) within the card's
           limits, each decode bit-exact, each MS-SSIM against the numpy
           oracle on the host, K1-K3 launched (``golden_runs``)
  formats  the clip as the default v2 stream, the dense v1 stream
           (AIVC_VRANS_ELIDE=0: K1 and K2 on new segment plans, held
           against their plain versions) and schedule 0x0D
           (AIVC_GDN_LOWP=0 AIVC_DC_OFFSET=0), each bit-exact, and a
           stream refused by a codec of another schedule
           (``formats_runs``)
  multidevice
           two ranks, one process each, on the card over gloo: the GOP
           round-robin, the mesh codec over 'data', train-small over
           'data' and over 'spatial', and the mesh codec over 'spatial'
           (each rank on its band of rows, halos exchanged; one K3 band
           launch checked and timed here) (``multidevice_runs``)
  lookahead
           the clip encoded warm at AIVC_PIPELINE_LOOKAHEAD 0 and 4 in
           turns: the same bytes, the encode fps of each
           (``lookahead_runs``)
  scripts  the operational tools (aivc_tpu_torch/scripts/) at full width:
           rd_sweep of the clip (K free and pinned, in this process and
           over worker processes; the in-process streams decoded
           bit-exactly), eval_ckpt of the checkpoint and of the low-rate
           specialist make_lowrate derives from it, with bd_from_eval of
           the two, latent_range, probe_motion, and scripts.aivc's three
           processes on the clip's YUV (``scripts_runs``)
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, List

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from aivc_tpu_torch import kernels, profile_kernels, tracing
from aivc_tpu_torch.coding import bitstream as bs
from aivc_tpu_torch.coding import range_coder, vrans
from aivc_tpu_torch.config import FRAME_B, FRAME_P, CodingConfig
from aivc_tpu_torch.gop import generate_gop_struct
from aivc_tpu_torch.io.yuv import YuvReader, YuvWriter, parse_geometry
from aivc_tpu_torch.ops import conv1x1 as c1_ops
from aivc_tpu_torch.ops import gdn as gdn_ops
from aivc_tpu_torch.ops import layers as layer_ops
from aivc_tpu_torch.ops import warp as warp_ops
from aivc_tpu_torch.parallel.launch import run_ranks
from aivc_tpu_torch.pipeline import video as video_mod
from aivc_tpu_torch.pipeline.codec import FrameCodec
from aivc_tpu_torch.pipeline.video import (
    decode_video,
    encode_video,
    evaluate_frames,
    frames_444,
    synthetic_frames,
)
from aivc_tpu_torch.train.loss import gop_rd_loss
from aivc_tpu_torch.utils.checkpoint import load_checkpoint
from aivc_tpu_torch.utils.debug import write_md5_manifest

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_TC_OPS_PER_S = 989e12
# Cycles of torch.cuda._sleep per second of host time: the H100's top SM
# clock, so the sleep lasts at least as long as asked.
SLEEP_CYCLES_PER_S = 1.98e9
# Host-vs-card agreement of the small clip (bf16 convolutions round
# differently on the two devices, so symbols may differ slightly).
SMALL_BYTES_RTOL = 0.10
SMALL_PSNR_ATOL_DB = 0.5
# K4 against the layer's own gdn_apply, elementwise |a - b| <= RTOL *
# (|b| + ATOL).  bf16 rounds to within 2^-8 relative.  K4 rounds its
# normaliser and its output to bf16 (gdn_pallas's types); gdn_apply rounds
# the channel sum to bf16 before beta and the square root (half of 2^-8
# after the root) and keeps the rest in f32: 2.5 * 2^-8 at most.
GDN_APPLY_RTOL = 2.0 ** -6
GDN_APPLY_ATOL = 1e-3
# K4's bf16 path against gdn_fused_plain, in bf16 ulps of the larger
# binade of the two values (``bf16_ulps``: ulp(b) = 2^(floor(log2 |b|) -
# 7), b the larger of |out| and |plain|).  The tensor cores sum in their
# own order and gamma enters as hi + lo (~16 bits), so the normaliser is
# within ~2^-16 relative of the plain ordered f32 sum; where the two
# round to neighbouring bf16 values (one normaliser ulp, up to 2^-7
# relative) the quotients differ by up to one such step and each is
# rounded again: 2 ulps of the output at most, which is 2^-7 of the
# binade's upper power of two (up to 2^-6 of |b| just above a power of
# two).  Where the two outputs straddle a power of two, that step reads
# up to 3 ulps of the lower binade (measured on the H100 on the 720p
# forward's captured g_s input), hence the larger binade.  K4's f32 path
# stays bit-identical.
GDN_PLAIN_ULPS = 2.0
# ... and the share of K4's bf16 outputs that may differ from the plain
# version at all: a sum of ~16-bit products lands on the other side of a
# bf16 rounding boundary rarely (2.6e-5 of the outputs on the six captured
# inputs, 1.5e-5 to 9.5e-5 in the card tests, H100); a kernel that kept
# fewer bits of gamma or of the sum would differ far more often, still
# within 2 ulps.
GDN_DIFFERING_SHARE = 1e-3
# The GDN layers' route to K4 (ops/gdn.py:gdn_layer_cuda, its plain
# version gdn_layer_plain) against gdn_apply, elementwise |a - b| <=
# RTOL * |b| by output type.  The two round at the same points; only the
# channel sum differs (its order, and without lowp gamma's ~16 bits), so
# where the sum lands on the other side of a bf16 rounding boundary the
# normaliser moves one bf16 step (up to 2^-7 relative).  f32 output
# (without lowp): the root halves that, 2^-8 at most (measured 3.8e-3 on
# the host, 3.9e-3 on the H100 on the codec's 1080p GDN inputs).  bf16
# output (lowp): beta's sum, the root and the quotient are each rounded
# to bf16 again, so two bf16 steps of the output, 2^-6 at most (measured
# 1.5e-2 on the H100).  Each limit is twice its bound.
GDN_LAYER_RTOL = {torch.float32: 2.0 ** -7, torch.bfloat16: 2.0 ** -5}
# ... and the share of outputs that may differ at all: gamma's hi + lo is
# within 2^-16 relative, so a normaliser moves where its sum lies that
# close to a bf16 boundary, under 2^-8 of them with the error at its
# bound (measured at most 6.6e-4 on the host and 5.6e-4 on the H100
# against gdn_apply, 1.1e-4 on the H100 against gdn_layer_plain).
GDN_LAYER_DIFFERING_SHARE = 2e-3
# forward-small: bf16-r5 at 128x128 on the card and on the host, whose
# bf16 convolutions round differently: (kind, limit) per log, about ten
# times the difference measured on the H100 (chip_smoke.py: rate_bpp
# 2.9e-4 relative, PSNR 0.013 dB, dist_pure 2.9e-4).
FORWARD_SMALL_TOL = {"rate_bpp": ("rel", 0.003), "psnr": ("abs", 0.1),
                     "dist_pure": ("abs", 0.003)}

KERNEL_SOURCES = {
    "rans_encode": ("aivc_tpu_torch/csrc/kernels.cu",
                    "aivc_tpu/coding/vrans.py:889"),
    "rans_decode": ("aivc_tpu_torch/csrc/kernels.cu",
                    "aivc_tpu/coding/vrans.py:630"),
    "warp_packed": ("aivc_tpu_torch/csrc/kernels.cu",
                    "aivc_tpu/ops/warp_pallas.py:303"),
    # K3 launched on a row window (a band of a frame split over a mesh's
    # 'spatial' axis)
    "warp_packed_band": ("aivc_tpu_torch/csrc/kernels.cu",
                         "aivc_tpu/ops/warp_pallas.py:303"),
    "gdn_fused": ("aivc_tpu_torch/csrc/kernels.cu",
                  "aivc_tpu/ops/gdn.py:133"),
    # K4 in the GDN layers, at gdn_apply's rounding points
    "gdn_layer": ("aivc_tpu_torch/csrc/kernels.cu",
                  "aivc_tpu/ops/gdn.py:57"),
    "warp_vclamped": ("aivc_tpu_torch/csrc/kernels.cu",
                      "aivc_tpu/ops/warp_pallas.py:113"),
    # K6, the input of each replicate-padded bf16 conv of the nets
    "conv_stage": ("aivc_tpu_torch/csrc/kernels.cu", "none"),
    # K7, ELIC's 1x1 convs with their bias and epilogue
    "conv1x1": ("aivc_tpu_torch/csrc/kernels.cu", "none"),
}
FORWARD_GOP = "1_GOP_8"


class Phases:
    """Runs the phases in order, printing each one's elapsed seconds."""

    def __init__(self, log: Callable[[str], None] = print):
        self.log = log
        self.t0 = time.time()

    def say(self, msg: str) -> None:
        self.log(f"[{time.time() - self.t0:8.2f}s] {msg}")


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def time_ms(fn, device: torch.device, reps: int, warmup: int = 1,
            hide_host: bool = False) -> float:
    """Mean milliseconds of fn(): CUDA events on the card, the host clock
    (after a synchronize) elsewhere.  With ``hide_host`` the card first
    sleeps for about twice the host's time to enqueue the reps, so that
    the events bracket the card's own time even where the host takes
    longer per call than the card (K1's wrapper does)."""
    for _ in range(warmup):
        fn()
    sync(device)
    if device.type == "cuda":
        if hide_host:
            t = time.perf_counter()
            fn()
            host_s = time.perf_counter() - t
            sync(device)
            torch.cuda._sleep(int(2 * host_s * reps * SLEEP_CYCLES_PER_S))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t) * 1000.0 / reps


def time_cold_ms(fn, device: torch.device, reps: int) -> float:
    """Mean milliseconds of one fn() with L2 cold: on the card its kernels'
    device time under torch.profiler, each call after a write of
    profile_kernels.FLUSH_BYTES that is read back (profile_kernels.l2_flush,
    outside the time); the host clock elsewhere (time_ms)."""
    if device.type != "cuda":
        return time_ms(fn, device, reps)
    us = profile_kernels.device_us(fn, reps, before=profile_kernels.l2_flush())
    if "error" in us:
        raise RuntimeError(f"cold timing: {us['error']}")
    return us["total"] / 1e3


# ---------------------------------------------------------------------------
# device / build
# ---------------------------------------------------------------------------

def device_info() -> Dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    return {"kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "smi": smi.stdout.strip().splitlines()[0]}


def build_report() -> Dict:
    """Builds the kernel library (one nvcc) and the host range coder (one
    g++) at the same time, each compiler in its own process."""
    t0 = time.time()
    with ThreadPoolExecutor(max_workers=1) as ex:
        coder = ex.submit(range_coder.build)
        kernels.lib()
        coder.result()
    lines = [ln.strip() for ln in kernels.BUILD_INFO.get("ptxas", "")
             .splitlines()
             if "registers" in ln or "Compiling entry" in ln
             or "bytes stack" in ln]
    return {"seconds": kernels.BUILD_INFO.get("seconds", 0.0),
            "cached": kernels.BUILD_INFO.get("cached", False),
            "both_seconds": time.time() - t0, "ptxas": lines}


# ---------------------------------------------------------------------------
# kernels at main-path shapes
# ---------------------------------------------------------------------------

def _sample_symbols(cdf: np.ndarray, rows: np.ndarray,
                    rng: np.random.Generator) -> np.ndarray:
    """Draw one symbol per element from its row's distribution."""
    sym = np.empty(rows.shape, np.int32)
    slots = rng.integers(0, vrans.PROB_SCALE, size=rows.shape)
    for r in np.unique(rows):
        sel = rows == r
        sym[sel] = np.searchsorted(cdf[r], slots[sel], side="right") - 1
    return sym


def fused_inputs(codec: FrameCodec, batch: int, seed: int = 0):
    """Symbols and rows of a dense (no channel elided) B-frame wave at the
    codec's size: segments z_m, y_m, z_c, y_c in the fused row space, each
    padded to a multiple of K, symbols drawn from their rows."""
    rng = np.random.default_rng(seed)
    hw_z = codec.hz * codec.wz
    hw_y = codec.hy * codec.wy
    cfg = codec.cfg
    sizes = [hw_z * cfg.mofnet.nb_ft_z, hw_y * cfg.mofnet.nb_ft_y,
             hw_z * cfg.codecnet.nb_ft_z, hw_y * cfg.codecnet.nb_ft_y]
    k = codec._pick_k(FRAME_B, sum(sizes))
    off = codec._row_off
    syms, rows, segs = [], [], []
    for i, n in enumerate(sizes):
        if i in (0, 2):
            fam = "z_m" if i == 0 else "z_c"
            c = cfg.mofnet.nb_ft_z if i == 0 else cfg.codecnet.nb_ft_z
            r = np.tile(np.arange(c) + off[fam], (batch, n // c))
        else:
            r = off["y"] + rng.integers(0, 48, size=(batch, n))
        n_pad = -(-n // k) * k
        r = np.pad(r, ((0, 0), (0, n_pad - n)), mode="edge")
        syms.append(_sample_symbols(codec.fused_rows, r, rng))
        rows.append(r.astype(np.int32))
        segs.append(n_pad // k)
    sym = torch.from_numpy(np.concatenate(syms, axis=1)).to(codec.device)
    row = torch.from_numpy(np.concatenate(rows, axis=1)).to(codec.device)
    return sym.contiguous(), row.contiguous(), k, tuple(segs)


def _words_for_decode(buf: torch.Tensor, seg_g: torch.Tensor):
    """Kernel-layout encode buffer -> [B, W] words from offset 0."""
    B, n_pad = buf.shape
    starts = seg_g[:, 0].cpu().tolist()
    w = torch.zeros((B, vrans.bucket(max(n_pad - min(starts), 1), 1 << 30)),
                    dtype=torch.uint16, device=buf.device)
    for i, s in enumerate(starts):
        w[i, :n_pad - s] = buf[i, s:]
    return w


def _record(name: str, err, ms, plain_ms, bound_bytes, bound_ops,
            library_ms=None, ops_per_s: float = F32_OPS_PER_S) -> Dict:
    """A kernel's record; its bound is the larger of the bytes over the
    memory rate and the operations over ``ops_per_s`` (the FP32 rate
    unless the operations run on the tensor cores)."""
    t_bytes = bound_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = bound_ops / ops_per_s * 1e3
    src, rep = KERNEL_SOURCES[name]
    return {"name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": 0, "max_abs_err": float(err), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


def gdn_layer_errors(out: torch.Tensor, ref: torch.Tensor):
    """(largest |out - ref| / |ref|, share of outputs that differ) of the
    GDN layers' route against a reference of the same type; a NaN makes
    both NaN, so that no limit passes it."""
    if out.dtype != ref.dtype or out.shape != ref.shape:
        raise AssertionError(f"{out.dtype} {tuple(out.shape)} against "
                             f"{ref.dtype} {tuple(ref.shape)}")
    d = (out.float() - ref.float()).abs()
    if bool(torch.isnan(d).any()):
        return math.nan, math.nan
    rel = float((d / ref.float().abs().clamp_min(1e-30)).max())
    return rel, float((d != 0).double().mean())


def bf16_ulps(a: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """|a - ref| in bf16 ulps of the larger binade of a and ref: ulp(b) =
    2^(floor(log2 |b|) - 7) for b = max(|a|, |ref|) (the spacing of bf16
    values in b's binade), so that one step of a value across a power of
    two counts once at the coarser spacing, not as two or three of the
    finer."""
    a, b = a.float(), ref.float()
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
    ulp = torch.ldexp(torch.ones_like(b), e - 8).clamp_min(2.0 ** -133)
    return (a - b).abs() / ulp


def encode_equal(out, ref) -> bool:
    """Two encodes (buf, states, seg_g) agree: states, segment cursors and
    each chunk's words, buf[b, seg_g[b, 0]:]."""
    buf, st, seg_g = out
    pbuf, pst, pseg = ref
    if not (torch.equal(seg_g, pseg) and torch.equal(st, pst)):
        return False
    return all(torch.equal(buf[i, int(s):], pbuf[i, int(s):])
               for i, s in enumerate(seg_g[:, 0].tolist()))


def check_rans(codec: FrameCodec, batch: int, reps: int = 5,
               seed: int = 0) -> List[Dict]:
    """K1 and K2 against their plain versions on one dense wave."""
    dev = codec.device
    sym, rows, k, segs = fused_inputs(codec, batch, seed)
    t = codec.table
    enc = lambda: vrans.encode_batch(sym, rows, t, k, segs)  # noqa: E731
    buf, st, seg_g = enc()
    if not encode_equal((buf, st, seg_g),
                        vrans.encode_plain(sym, rows, t, k, segs)):
        raise AssertionError("K1 differs from the plain encode")
    n_pad = sym.shape[1]
    steps = n_pad // k
    total_words = int((n_pad - seg_g[:, 0].long()).sum())
    ms_enc = time_ms(enc, dev, reps, hide_host=True)
    plain_enc = time_ms(lambda: vrans.encode_plain(sym, rows, t, k, segs),
                        dev, 1, warmup=0)

    words = _words_for_decode(buf, seg_g)
    dec = lambda: vrans.decode_batch(words, st, rows, t, k)  # noqa: E731
    syms, dst, dg = dec()
    psyms, pdst, pdg = vrans.decode_plain(words, st, rows, t, k)
    if not (torch.equal(syms, psyms) and torch.equal(dst, pdst)
            and torch.equal(dg, pdg)):
        raise AssertionError("K2 differs from the plain decode")
    if not torch.equal(syms, sym):
        raise AssertionError("decode(encode(x)) != x")
    ms_dec = time_ms(dec, dev, reps, hide_host=True)
    plain_dec = time_ms(lambda: vrans.decode_plain(words, st, rows, t, k),
                        dev, 1, warmup=0)
    n = batch * n_pad
    table_b = t.cdf16.numel() * 2
    state_b = batch * k * 4
    # ~20 32-bit integer operations per symbol (lookup, compare, shift,
    # divide, scan share), counted at the card's f32 non-tensor rate.
    int_ops = 20 * n
    recs = [
        _record("rans_encode", 0, ms_enc, plain_enc,
                8 * n + table_b + 2 * total_words + state_b
                + seg_g.numel() * 4, int_ops),
        _record("rans_decode", 0, ms_dec, plain_dec,
                2 * total_words + state_b + 4 * n + batch * 4 + table_b
                + 4 * n + state_b + batch * 4, int_ops),
    ]
    for r in recs:
        r["steps"] = steps
        r["us_per_step"] = r["ms"] * 1e3 / steps
    return recs


def warp_inputs(device: torch.device, batch: int, h: int, w: int, fb: int,
                g: torch.Generator = None):
    """Random packed frames and flows uniform in (-fb, fb): K3's timed
    input (incoherent flows, the worst case for its corner gathers)."""
    if g is None:
        g = torch.Generator(device="cpu").manual_seed(0)
    packed = torch.randint(0, 1 << 24, (batch, h, w), generator=g,
                           dtype=torch.int32).to(device)
    u = ((torch.rand((batch, h, w), generator=g) * 2 - 1) * fb).to(device)
    v = ((torch.rand((batch, h, w), generator=g) * 2 - 1) * fb).to(device)
    return packed, u, v


def check_warp(device: torch.device, batch: int, h: int, w: int, fb: int,
               reps: int = 20, seed: int = 0) -> List[Dict]:
    """K3 against the plain warp on a packed frame and bounded flows."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    packed, u, v = warp_inputs(device, batch, h, w, fb, g)
    run = lambda: warp_ops.mc_warp(packed, u, v, "bounded")  # noqa: E731
    out = run()
    ref = warp_ops.warp_packed(packed, u, v)
    mism = int((out.view(torch.int32) != ref.view(torch.int32)).sum())
    if mism:
        raise AssertionError(f"K3: {mism} values differ in bits from the "
                             "plain warp")
    err = float((out - ref).abs().max())
    ms = time_ms(run, device, reps, hide_host=True)
    plain = time_ms(lambda: warp_ops.warp_packed(packed, u, v), device, 3)
    # Yardstick: one library call of the same function, a float-frame
    # bilinear border-clamped grid_sample (never called by the port).
    frame = torch.rand((batch, 3, h, w), generator=g).to(device)
    xs = torch.arange(w, device=device).view(1, 1, w) + u
    ys = torch.arange(h, device=device).view(1, h, 1) + v
    grid = torch.stack([xs / (w - 1) * 2 - 1, ys / (h - 1) * 2 - 1], dim=-1)
    lib_ms = time_ms(lambda: F.grid_sample(
        frame, grid, mode="bilinear", padding_mode="border",
        align_corners=True), device, reps, hide_host=True)
    px = batch * h * w
    return [_record("warp_packed", err, ms, plain, 24 * px, 45 * px,
                    library_ms=lib_ms)]


class WarpWatch:
    """Wraps ops/warp.py:warp_packed_cuda, which mc_warp calls through
    its module, and keeps a copy of the (packed, u, v, row0) of the first
    launch with the largest batch while open: in an RA clip's encode, a
    B-frame wave's.  With ``band`` only launches on a band of rows below
    the first (row0 > 0: a mesh's 'spatial' rank past the first) count."""

    def __init__(self, band: bool = False):
        self.inputs = None
        self.band = band
        self._kernel = warp_ops.warp_packed_cuda
        warp_ops.warp_packed_cuda = self._call

    def _call(self, packed, u, v, row0=0):
        if (not self.band or row0 > 0) and (
                self.inputs is None
                or packed.shape[0] > self.inputs[0].shape[0]):
            self.inputs = tuple(t.detach().clone()
                                for t in (packed, u, v)) + (row0,)
        return self._kernel(packed, u, v, row0)

    def close(self) -> None:
        if warp_ops.warp_packed_cuda == self._call:
            warp_ops.warp_packed_cuda = self._kernel


def check_warp_on(inputs, reps: int = 20) -> Dict:
    """K3 on captured (packed, u, v, row0) against the plain warp, bit for
    bit, and timed (the plain version itself on the host), with the
    plain version's time and a library call's (a border-clamped bilinear
    grid_sample of a float frame at the same rows)."""
    packed, u, v, row0 = inputs
    dev = packed.device
    kern = (warp_ops.warp_packed_cuda if dev.type == "cuda"
            else warp_ops.warp_packed)
    out = kern(packed, u, v, row0)
    ref = warp_ops.warp_packed(packed, u, v, row0)
    mism = int((out.view(torch.int32) != ref.view(torch.int32)).sum())
    if mism:
        raise AssertionError(f"K3 on captured flows: {mism} values differ "
                             "in bits from the plain warp")
    ms = time_ms(lambda: kern(packed, u, v, row0), dev, reps, hide_host=True)
    plain = time_ms(lambda: warp_ops.warp_packed(packed, u, v, row0), dev, 3)
    b, H, w = packed.shape
    h = u.shape[1]
    frame = torch.rand((b, 3, H, w), device=dev)
    xs = torch.arange(w, device=dev).view(1, 1, w) + u
    ys = torch.arange(row0, row0 + h, device=dev).view(1, h, 1) + v
    grid = torch.stack([xs / (w - 1) * 2 - 1, ys / (H - 1) * 2 - 1], dim=-1)
    lib_ms = time_ms(lambda: F.grid_sample(
        frame, grid, mode="bilinear", padding_mode="border",
        align_corners=True), dev, reps, hide_host=True)
    px = u.numel()
    return {"shape": list(packed.shape), "rows": [row0, row0 + h],
            "ms": ms, "plain_ms": plain, "library_ms": lib_ms,
            "max_flow": float(torch.maximum(u.abs().max(), v.abs().max())),
            "bound_ms": 24 * px / HBM_BYTES_PER_S * 1e3,
            "bound_bytes": 24 * px, "bound_ops": 45 * px}


def band_warp_record(rec: Dict) -> Dict:
    """The kernels line's record of K3 on a captured band launch
    (check_warp_on's result)."""
    return _record("warp_packed_band", 0.0, rec["ms"], rec["plain_ms"],
                   rec["bound_bytes"], rec["bound_ops"],
                   library_ms=rec["library_ms"])


def capture_encode_warp(codec: FrameCodec, frames, wave_batch: int = 8,
                        gop: int = 8):
    """The (packed, u, v) of one K3 launch of an RA clip's encode (a
    B-frame wave's, WarpWatch), from an encode of its own, so that the
    copy adds nothing to the main path's time and memory."""
    watch = WarpWatch()
    try:
        encode_video(codec, frames, ra_coding(gop), wave_batch=wave_batch)
    finally:
        watch.close()
    if watch.inputs is None:
        raise AssertionError("no warp_packed launch in the encode")
    return watch.inputs


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------

def ra_coding(gop: int) -> CodingConfig:
    return CodingConfig(coding_config="RA", gop_size=gop, intra_period=gop)


def code_clip(codec: FrameCodec, frames, wave_batch: int = 8,
              gop: int = 8) -> Dict:
    """Encode then decode an RA clip through the entry points; the decode
    must reproduce the encoder's reconstructions bit for bit.  Counts
    the steps K1 walks in the encode and K2 in the decode."""
    dev = codec.device
    coding = ra_coding(gop)
    sync(dev)
    enc_steps0 = kernels.STEPS["rans_encode"]
    t0 = time.time()
    enc = encode_video(codec, frames, coding, wave_batch=wave_batch)
    sync(dev)
    t1 = time.time()
    encode_steps = kernels.STEPS["rans_encode"] - enc_steps0
    steps0 = kernels.STEPS["rans_decode"]
    dec = decode_video(codec, enc.bitstream)
    for i in range(len(frames)):
        dec[i]["y"]  # pulls the wave's planes to the host
    sync(dev)
    t2 = time.time()
    decode_steps = kernels.STEPS["rans_decode"] - steps0
    for i in range(len(frames)):
        for c in ("y", "u", "v"):
            if not np.array_equal(dec[i][c], enc.decoded_frames[i][c]):
                raise AssertionError(
                    f"decoded frame {i} plane {c} differs from the "
                    "encoder's reconstruction")
    quality = evaluate_frames(frames, dec, device=dev)
    psnr, ms_ssim = quality["psnr"], quality["ms_ssim"]
    if not (np.isfinite(psnr) and np.isfinite(ms_ssim)):
        raise AssertionError(f"PSNR / MS-SSIM not finite: {quality}")
    n_pix = codec.h * codec.w * len(frames)
    return {"bytes": len(enc.bitstream),
            "bitstream": enc.bitstream,
            "bpp": len(enc.bitstream) * 8.0 / n_pix,
            "psnr": float(psnr),
            "ms_ssim": float(ms_ssim),
            "encode_fps": len(frames) / (t1 - t0),
            "decode_fps": len(frames) / (t2 - t1),
            "encode_s": t1 - t0,
            "decode_s": t2 - t1,
            "encode_steps": encode_steps,
            "decode_steps": decode_steps,
            "frame_bytes": [r.bytes for r in enc.frame_results]}


def small_agreement(ckpt: str, device: torch.device, size: int = 64,
                    n_frames: int = 9) -> Dict:
    """The same small clip coded on ``device`` and on the host."""
    frames = synthetic_frames(n_frames, size, size, seed=1)
    out = {}
    for name, dev in (("device", device), ("host", torch.device("cpu"))):
        cfg, model = load_checkpoint(ckpt, device=dev)
        codec = FrameCodec(cfg, model, size, size, device=dev)
        out[name] = code_clip(codec, frames)
    a, b = out["device"], out["host"]
    if not abs(a["bytes"] - b["bytes"]) <= SMALL_BYTES_RTOL * b["bytes"]:
        raise AssertionError(f"small clip: {a['bytes']} B on the device vs "
                             f"{b['bytes']} B on the host")
    if not abs(a["psnr"] - b["psnr"]) <= SMALL_PSNR_ATOL_DB:
        raise AssertionError(f"small clip: PSNR {a['psnr']:.3f} on the "
                             f"device vs {b['psnr']:.3f} on the host")
    return out


# ---------------------------------------------------------------------------
# RD forward path
# ---------------------------------------------------------------------------

# The six CodecNet GDN layers whose inputs feed the K4 check: g_a's three
# GDNs and g_s's three IGDNs.
GDN_LAYERS = tuple(f"codecnet.g_a.ConvBlock_{i}.GDN_0" for i in range(3)) + \
    tuple(f"codecnet.g_s.UpBlock_{i}.GDN_0" for i in range(3))


def warp_calls(gop_name: str) -> int:
    """Float warps of one forward over a GOP: one per P-frame, two per
    B-frame (fullnet.py:_motion_comp)."""
    gop = generate_gop_struct(gop_name)
    return sum({FRAME_P: 1, FRAME_B: 2}.get(f.frame_type, 0)
               for f in gop.frames)


class GdnWatch:
    """Forward pre-hooks on a model's GDN layers that capture the first
    input of each layer named in ``capture``, with the layer: an NCHW
    copy, the exported gdn_fused's layout (the bf16 nets hand their GDN
    layers channels-last tensors)."""

    def __init__(self, model: torch.nn.Module, capture=()):
        self.inputs: Dict[str, tuple] = {}
        self._handles = [
            mod.register_forward_pre_hook(self._hook(name, mod))
            for name, mod in model.named_modules() if name in capture]

    def _hook(self, name, mod):
        def hook(_, args):
            if name not in self.inputs:
                self.inputs[name] = (args[0].detach().clone(
                    memory_format=torch.contiguous_format), mod)
        return hook

    def close(self) -> None:
        for h in self._handles:
            h.remove()


def rd_forward(model, cfg, frames444: List[torch.Tensor],
               idx_rate: float, gop_name: str = FORWARD_GOP) -> Dict:
    """gop_rd_loss in eval mode over the GOP (the trainer's weights:
    l_codec = l_mof = lambda_tradeoff[idx_rate]); every log finite."""
    dev = frames444[0].device
    lam = float(cfg.lambda_tradeoff[int(idx_rate)])
    sync(dev)
    t0 = time.time()
    with torch.inference_mode():
        loss, logs = gop_rd_loss(
            model, frames444, generate_gop_struct(gop_name), idx_rate,
            lam, lam, dist_loss=cfg.dist_loss,
            weight_i_frame_loss=cfg.weight_i_frame_loss)
    sync(dev)
    dt = time.time() - t0
    out = {k: float(v) for k, v in logs.items()}
    out["loss"] = float(loss)
    bad = [k for k, v in out.items() if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"non-finite forward logs: {bad} ({out})")
    return {"logs": out, "seconds": dt, "fps": len(frames444) / dt}


def forward_small(ckpt: str, device: torch.device, idx_rate: float,
                  size: int = 128, gop_name: str = FORWARD_GOP) -> Dict:
    """The RD forward of a small GOP on ``device`` and on the host."""
    frames = synthetic_frames(len(generate_gop_struct(gop_name)), size,
                              size, seed=2)
    out = {}
    for name, dev in (("device", device), ("host", torch.device("cpu"))):
        cfg, model = load_checkpoint(ckpt, device=dev)
        out[name] = rd_forward(model, cfg, frames_444(frames, dev),
                               idx_rate, gop_name)["logs"]
    return out


def compare_logs(a: Dict[str, float], b: Dict[str, float], tol: Dict,
                 what: str) -> Dict[str, float]:
    """Differences of the logs named in ``tol`` (relative or absolute);
    raises if one exceeds its limit."""
    diffs = {}
    for k, (kind, lim) in tol.items():
        d = abs(a[k] - b[k])
        if kind == "rel":
            d /= max(abs(b[k]), 1e-12)
        diffs[k] = d
        if not d <= lim:     # a NaN fails
            raise AssertionError(f"{what}: {k} {a[k]} vs {b[k]} ({kind} "
                                 f"difference {d} > {lim})")
    return diffs


def vclamped_bytes(x: torch.Tensor) -> int:
    """K5's byte bound on x [B, C, H, W]: per pixel 8 B of flow and 4C B
    of source read, 4C B written."""
    B, C, H, W = x.shape
    return (8 + 8 * C) * B * H * W


def _past_clamp(flow: torch.Tensor) -> float:
    """Share of the pixels whose vertical flow K5 clamps."""
    return float((flow[:, 1].abs() > warp_ops.V_RADIUS - 1).float().mean())


def _check_vclamped_bits(out, ref, what: str) -> None:
    mism = int((out.view(torch.int32) != ref.view(torch.int32)).sum())
    if mism:
        raise AssertionError(f"K5 {what}: {mism} values differ in bits "
                             "from the plain warp")


def check_warp_vclamped(device: torch.device, h: int, w: int, c: int = 3,
                        batch: int = 1, reps: int = 20,
                        seed: int = 0) -> Dict:
    """K5 against its plain version on a float frame and flows whose
    vertical part reaches +-30 rows, so the +-15 clamp engages."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.rand((batch, c, h, w), generator=g).to(device)
    flow = ((torch.rand((batch, 2, h, w), generator=g) * 2 - 1)
            * torch.tensor([40.0, 30.0]).view(1, 2, 1, 1)).to(device)
    clamped = _past_clamp(flow)
    if clamped == 0.0:
        raise AssertionError("K5 check: no vertical flow beyond the clamp")
    kern = (warp_ops.warp_vclamped_cuda if device.type == "cuda"
            else warp_ops.warp_vclamped)
    run = lambda: kern(x, flow)  # noqa: E731
    out = run()
    ref = warp_ops.warp_vclamped(x, flow)
    _check_vclamped_bits(out, ref, "on random flows")
    err = float((out - ref).abs().max())
    ms = time_ms(run, device, reps, hide_host=True)
    plain = time_ms(lambda: warp_ops.warp_vclamped(x, flow), device, 3)
    # Yardstick: the library's bilinear border-clamped sampler on the
    # same frame and flow (no vertical clamp; never called by the port).
    xs = torch.arange(w, device=device).view(1, 1, w) + flow[:, 0]
    ys = torch.arange(h, device=device).view(1, h, 1) + flow[:, 1]
    grid = torch.stack([xs / (w - 1) * 2 - 1, ys / (h - 1) * 2 - 1], dim=-1)
    lib_ms = time_ms(lambda: F.grid_sample(
        x, grid, mode="bilinear", padding_mode="border",
        align_corners=True), device, reps, hide_host=True)
    px = batch * h * w
    rec = _record("warp_vclamped", err, ms, plain, vclamped_bytes(x),
                  (16 + 10 * c) * px, library_ms=lib_ms)
    rec["clamped_share"] = clamped
    return rec


class VclampWatch:
    """Wraps ops/warp.py:warp_vclamped_cuda, which the float warp calls
    through its module, and keeps a copy of the (x, flow) of its launch
    number ``at`` (from 0) while open."""

    def __init__(self, at: int):
        self.at = at
        self.calls = 0
        self.inputs = None
        self._kernel = warp_ops.warp_vclamped_cuda
        warp_ops.warp_vclamped_cuda = self._call

    def _call(self, x, flow):
        if self.calls == self.at:
            self.inputs = (x.detach().clone(), flow.detach().clone())
        self.calls += 1
        return self._kernel(x, flow)

    def close(self) -> None:
        if warp_ops.warp_vclamped_cuda == self._call:
            warp_ops.warp_vclamped_cuda = self._kernel


def first_b_warp(gop_name: str) -> int:
    """Number (from 0) of the first float warp of a B-frame in a forward
    over the GOP, which runs the frames in coding order."""
    n = 0
    for f in generate_gop_struct(gop_name).coding_order:
        if f.frame_type == FRAME_B:
            return n
        n += int(f.frame_type == FRAME_P)
    raise ValueError(f"{gop_name} has no B-frame")


def capture_forward_warp(model, cfg, frames444: List[torch.Tensor],
                         idx_rate: float, gop_name: str = FORWARD_GOP):
    """rd_forward over the GOP with the (x, flow) of its first B-frame K5
    launch copied on the way (VclampWatch): (rd_forward's result, the
    inputs).  Used for the warm-up forward, so that the timed one carries
    no copy."""
    watch = VclampWatch(first_b_warp(gop_name))
    try:
        fwd = rd_forward(model, cfg, frames444, idx_rate, gop_name)
    finally:
        watch.close()
    if watch.inputs is None:
        raise AssertionError(f"no warp_vclamped launch number {watch.at} "
                             "in the forward")
    return fwd, watch.inputs


def check_warp_vclamped_on(inputs, reps: int = 20) -> Dict:
    """K5 on captured (x, flow) against the plain warp, bit for bit, and
    timed warm and with L2 cold (the plain version itself on the host),
    with the flows' reach and the share of pixels past the vertical
    clamp."""
    x, flow = inputs
    dev = x.device
    kern = (warp_ops.warp_vclamped_cuda if dev.type == "cuda"
            else warp_ops.warp_vclamped)
    _check_vclamped_bits(kern(x, flow), warp_ops.warp_vclamped(x, flow),
                         "on captured flows")
    run = lambda: kern(x, flow)  # noqa: E731
    return {"shape": list(x.shape),
            "ms": time_ms(run, dev, reps, hide_host=True),
            "cold_ms": time_cold_ms(run, dev, reps),
            "bound_ms": vclamped_bytes(x) / HBM_BYTES_PER_S * 1e3,
            "max_u": float(flow[:, 0].abs().max()),
            "max_v": float(flow[:, 1].abs().max()),
            "clamped_share": _past_clamp(flow)}


# The codec's largest GDN inputs at 1080p (a wave of 8, the rows padded to
# 1088), each with the checkpoint's layer whose parameters it takes: g_s's
# last IGDN in MOFNet and in CodecNet.
GDN_LAYER_CASES = (("mofnet.g_s.UpBlock_2.GDN_0", (8, 96, 544, 960)),
                   ("codecnet.g_s.UpBlock_2.GDN_0", (8, 128, 544, 960)))


@torch.no_grad()
def check_gdn_layer(layers: Dict[str, torch.nn.Module], device: torch.device,
                    reps: int = 10, cases=GDN_LAYER_CASES) -> Dict:
    """The GDN layers' kernel (a GDN layer on a bf16 input: K4 through
    gdn_layer_cuda) at each case's shape, with the parameters of the named
    layer of ``layers`` (``dict(model.named_modules())``), with and
    without lowp: the whole batch's output against gdn_layer_plain's,
    image by image (within GDN_LAYER_RTOL and GDN_LAYER_DIFFERING_SHARE),
    timed against the larger of its bytes (x read once, the output
    written once) and its tensor-core operations at the card's rates, and
    against gdn_apply on the same input; then on the same x channels-last
    (on the card the same bits as NCHW), timed too.  Returns the kernels line's
    record of the codec's own route (the last case, lowp), every case's
    record under "cases", and the launches of the checks.  Under no_grad
    and not inference mode, so that the layer's parameters keep their
    version counters and the kernel's parameters are made once."""
    g = torch.Generator(device=device).manual_seed(19)
    recs, launches = [], 0
    for name, shape in cases:
        src = layers[name]
        B, C, H, W = shape
        x = (torch.randn(shape, generator=g, device=device) * 1.5).to(
            torch.bfloat16)
        for lowp in (True, False):
            layer = gdn_ops.GDN(C, inverse=src.inverse, lowp=lowp)
            layer.load_state_dict(src.state_dict())
            layer = layer.to(device)
            kernels.reset_launches()
            got = layer(x)
            launched = kernels.LAUNCHES["gdn_layer"]
            if launched != (device.type == "cuda"):
                raise AssertionError(f"the layer launched {launched} times")
            params = gdn_ops.layer_params(
                *gdn_ops.reparam(layer.beta, layer.gamma), lowp)
            worst, rel, n_diff = 0.0, 0.0, 0.0
            for i in range(B):
                ref = gdn_ops.gdn_layer_plain(x[i:i + 1], *params,
                                              layer.inverse, lowp)
                r, share = gdn_layer_errors(got[i:i + 1], ref)
                # Written as not (x <= limit), so that a NaN fails.
                if not r <= GDN_LAYER_RTOL[got.dtype]:
                    raise AssertionError(f"GDN layer {name} {shape} lowp "
                                         f"{lowp}, image {i}: {r} relative "
                                         "from its plain version")
                worst = max(worst, float((got[i:i + 1].float()
                                          - ref.float()).abs().max()))
                rel, n_diff = max(rel, r), n_diff + share
            share = n_diff / B
            if not share <= GDN_LAYER_DIFFERING_SHARE:
                raise AssertionError(f"GDN layer {name} {shape} lowp {lowp}:"
                                     f" {share} of the outputs differ")
            # The same values channels-last, the nets' layout between
            # their convolutions: on the card the same bits.
            x_cl = x.contiguous(memory_format=torch.channels_last)
            got_cl = layer(x_cl)
            launches += kernels.LAUNCHES["gdn_layer"]
            if device.type == "cuda" and not torch.equal(got_cl, got):
                raise AssertionError(f"GDN layer {name} {shape} lowp {lowp}"
                                     ": channels-last x differs from NCHW")
            ms = time_ms(lambda: layer(x), device, reps)
            ms_cl = time_ms(lambda: layer(x_cl), device, reps)
            plain_ms = B * time_ms(lambda: gdn_ops.gdn_layer_plain(
                x[:1], *params, layer.inverse, lowp), device, 1, warmup=0)
            lib_ms = time_ms(lambda: gdn_ops.gdn_apply(
                x, layer.beta, layer.gamma, layer.inverse, 0.0, lowp),
                device, reps)
            n = x.numel()
            # lowp multiplies by gamma's hi alone, else by hi and lo.
            rec = _record("gdn_layer", worst, ms, plain_ms,
                          n * (x.element_size() + got.element_size())
                          + 4 * C + 4 * C * C,
                          2 * B * H * W * C * C * (1 if lowp else 2)
                          + 6 * n, library_ms=lib_ms,
                          ops_per_s=BF16_TC_OPS_PER_S)
            rec.update(layer=name, shape=shape, lowp=lowp,
                       max_rel_err=rel, differing_share=share,
                       ms_channels_last=ms_cl)
            recs.append(rec)
    rec = dict(next(r for r in reversed(recs) if r["lowp"]), cases=recs,
               launches=launches)
    return rec


# K6's cases (shape, type, layout, pad, channels out): CodecNet's g_a
# input behind its first GDN (f32 channels-last, pad 2) at 1080p in a wave
# of 8, the one the kernels line records; the analysis's 6-channel NCHW
# entry, staged as 8 channels; a bf16 channels-last input with pad 1 (an
# attention ResBlock's conv).
CONV_STAGE_CASES = (
    ((8, 128, 544, 960), torch.float32, "channels_last", 2, None),
    ((8, 6, 1088, 1920), torch.float32, "nchw", 2, 8),
    ((8, 128, 272, 480), torch.bfloat16, "channels_last", 1, None))


@torch.no_grad()
def check_conv_stage(device: torch.device, reps: int = 10,
                     cases=CONV_STAGE_CASES) -> Dict:
    """The conv stage K6 (ops/layers.py:pad_stage: the kernel on the card,
    its plain version on the host) at each case's shape: bit for bit
    against pad_stage_plain, timed against its bytes (x read once, the
    padded bf16 output written once) at the card's rate, against the
    plain version on the same x, and against the library passes the
    nets ran before it on the same values laid out NCHW (replication pad,
    cast, channels-last copy: cuDNN's transpose).  Returns the first
    case's record, every case's under "cases", and the launches."""
    g = torch.Generator(device=device).manual_seed(22)
    recs, launches = [], 0
    for shape, dtype, fmt, pad, channels in cases:
        x = (torch.randn(shape, generator=g, device=device) * 3).to(dtype)
        x_nchw = x
        if fmt == "channels_last":
            x = x.contiguous(memory_format=torch.channels_last)
        before = kernels.LAUNCHES["conv_stage"]
        got = layer_ops.pad_stage(x, pad, channels)
        launches += kernels.LAUNCHES["conv_stage"] - before
        ref = layer_ops.pad_stage_plain(x, pad, channels)
        if not torch.equal(got, ref):
            raise AssertionError(f"conv stage {shape} {dtype} {fmt} pad "
                                 f"{pad}: differs from its plain version")
        ms = time_ms(lambda: layer_ops.pad_stage(x, pad, channels), device,
                     reps)
        plain_ms = time_ms(
            lambda: layer_ops.pad_stage_plain(x, pad, channels), device,
            reps)
        lib_ms = time_ms(lambda: F.pad(
            x_nchw, (pad, pad, pad, pad), mode="replicate").to(
                torch.bfloat16).contiguous(
                    memory_format=torch.channels_last), device, reps)
        rec = _record("conv_stage", 0.0, ms, plain_ms,
                      x.numel() * x.element_size()
                      + got.numel() * got.element_size(), 0,
                      library_ms=lib_ms)
        rec.update(shape=shape, dtype=str(dtype).split(".")[-1], fmt=fmt,
                   pad=pad, channels=got.shape[1])
        recs.append(rec)
    return dict(recs[0], cases=recs, launches=launches)


def bf16_step(t: torch.Tensor, up: bool) -> torch.Tensor:
    """The bf16 neighbour of each value of bf16 ``t`` toward +inf (``up``)
    or -inf, through zero (+0 and -0 step to the smallest subnormal of
    the direction's sign); finite values only."""
    i = t.view(torch.int16).to(torch.int32) & 0xFFFF
    neg = i >= 0x8000
    mag = i & 0x7FFF
    grows = ~neg if up else neg
    cross = (mag == 0) & ~grows
    mag = torch.where(grows, mag + 1, torch.where(cross, 1, mag - 1))
    neg = torch.where(cross, ~neg, neg)
    bits = torch.where(neg, mag | 0x8000, mag)
    bits = torch.where(bits >= 0x8000, bits - 0x10000, bits)
    return bits.to(torch.int16).view(torch.bfloat16)


def _bf16_directed(v: torch.Tensor, up: bool) -> torch.Tensor:
    """f32 v rounded to bf16 toward +inf (``up``) or -inf."""
    r = v.to(torch.bfloat16)
    off = r.float() < v if up else r.float() > v
    return torch.where(off, bf16_step(r, up), r)


@torch.no_grad()
def conv1x1_band(x, weight, bias, epilogue, bias_in=None, residual=None,
                 trunk=None):
    """(lo, hi) float32: the outputs K7 may give where the plain version
    (its own order of the sum) gives its own.  The tensor cores sum the K
    products in another order than cuDNN: each sum is within K 2^-23 of
    the sum of |products| of the exact one (a truncating f32 adder), so
    the two within 2 K 2^-23 of it (e), and the plain version's rounded
    sum s lies within half a bf16 ulp of its own.  So the kernel's rounded
    sum lies between bf16 floor(step_down(s) - e) and ceil(step_up(s) +
    e): one bf16 ulp of the first rounding, more only where the sum
    cancels.  Every epilogue after it is monotone in that sum (the gate
    decreasing where the trunk is negative), so the output lies between
    the plain epilogue at the two ends."""
    n, k = weight.shape
    a = x
    if epilogue == "residual":
        a = torch.relu(x + bias_in.view(1, -1, 1, 1))
    w4 = weight.view(n, k, 1, 1)
    s = F.conv2d(a, w4)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        mag = F.conv2d(a.float().abs(), w4.float().abs())
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    e = 2.0 * k * 2.0 ** -23 * mag
    lo = _bf16_directed(bf16_step(s, False).float() - e, False)
    hi = _bf16_directed(bf16_step(s, True).float() + e, True)
    ends = [c1_ops.epilogue_plain(t, bias, epilogue, residual, trunk).float()
            for t in (lo, hi)]
    return torch.minimum(*ends), torch.maximum(*ends)


def conv1x1_within(out, x, weight, bias, epilogue, bias_in=None,
                   residual=None, trunk=None) -> float:
    """Share of K7's outputs ``out`` inside ``conv1x1_band`` of its
    inputs, an image at a time (the band of a 1080p wave of 8 would hold
    tens of GB); 1 where every one is."""
    inside = 0
    for i in range(x.shape[0]):
        def one(t):
            return None if t is None else t[i:i + 1]
        lo, hi = conv1x1_band(one(x), weight, bias, epilogue, bias_in,
                              one(residual), one(trunk))
        o = out[i:i + 1].float()
        inside += int(((o >= lo) & (o <= hi)).sum())
    return inside / out.numel()


# K7's cases (K, N, epilogue, [B, H, W]): the 1x1 convs of ELIC-N192-M320's
# transforms at their shapes in a 1080p wave of 8: a bottleneck's conv a
# and conv c at 544 x 960, the attention's gate at 272 x 480, and the
# M-wide ones (g_a's last attention, g_s's first) at 68 x 120.
CONV1X1_CASES = (
    (192, 96, "relu", (8, 544, 960)),
    (96, 192, "residual", (8, 544, 960)),
    (192, 192, "gate", (8, 272, 480)),
    (320, 160, "relu", (8, 68, 120)),
    (160, 320, "residual", (8, 68, 120)),
    (320, 320, "gate", (8, 68, 120)))


def conv1x1_inputs(device, k, n, shape, seed, layout=torch.channels_last):
    """Seeded bf16 (x, weight, bias, bias_in, residual, trunk) of one K7
    case: activations of unit scale in ``layout``, weights of 1 / sqrt(k),
    biases of 0.3."""
    g = torch.Generator(device=device).manual_seed(seed)
    b, h, w = shape

    def act(c):
        return torch.randn((b, c, h, w), generator=g, device=device).to(
            torch.bfloat16).contiguous(memory_format=layout)

    def vec(*size, scale):
        return (torch.randn(size, generator=g, device=device) * scale).to(
            torch.bfloat16)

    return (act(k), vec(n, k, scale=k ** -0.5), vec(n, scale=0.3),
            vec(k, scale=0.3), act(n), act(n))


@torch.no_grad()
def check_conv1x1(device: torch.device, reps: int = 10,
                  cases=CONV1X1_CASES) -> Dict:
    """K7 (ops/conv1x1.py:conv1x1, the kernel on the card) at each case's
    shape: every output within ``conv1x1_band`` of its plain version, the
    share that differs from it, the time against its bound (x, the
    residual and the trunk read once, the output written once; the
    products on the tensor cores), the plain version's time, and the
    library passes the module ran before it on NCHW tensors (cuDNN's conv
    with its bias pass, then the epilogue's elementwise passes)."""
    recs, launches = [], 0
    for i, (k, n, epi, shape) in enumerate(cases):
        x, w, b, b_in, res, trunk = conv1x1_inputs(device, k, n, shape, i)
        args = (x, w, b, epi, b_in, res, trunk)
        before = kernels.LAUNCHES["conv1x1"]
        got = c1_ops.conv1x1(*args)
        launches += kernels.LAUNCHES["conv1x1"] - before
        plain = c1_ops.conv1x1_plain(*args)
        inside = conv1x1_within(got, *args)
        if inside != 1.0:
            raise AssertionError(f"conv1x1 {k} -> {n} {epi} {shape}: "
                                 f"{1 - inside:.3e} of the outputs outside "
                                 f"the band of its plain version")
        differ = float((got != plain).float().mean())
        ms = time_ms(lambda: c1_ops.conv1x1(*args), device, reps)
        plain_ms = time_ms(lambda: c1_ops.conv1x1_plain(*args), device, reps)
        nchw = [t.contiguous() for t in (x, res, trunk)]
        w4 = w.view(n, k, 1, 1)

        def library():
            if epi == "relu":
                return torch.relu(F.conv2d(nchw[0], w4, b))
            if epi == "residual":
                return nchw[1] + F.conv2d(
                    torch.relu(nchw[0] + b_in.view(1, -1, 1, 1)), w4, b)
            return nchw[1] + nchw[2] * torch.sigmoid(F.conv2d(nchw[0], w4, b))

        lib_ms = time_ms(library, device, reps)
        extra = {"relu": 0, "residual": 1, "gate": 2}[epi]
        px = x.numel() // k
        rec = _record("conv1x1", 0.0, ms, plain_ms,
                      2 * px * (k + n * (1 + extra)) + 2 * n * k,
                      2 * px * k * n, library_ms=lib_ms,
                      ops_per_s=BF16_TC_OPS_PER_S)
        rec.update(k=k, n=n, epilogue=epi, shape=shape, differing=differ)
        recs.append(rec)
        del x, w, b, b_in, res, trunk, args, got, plain, nchw
    return dict(recs[0], cases=recs, launches=launches)


def seeded_elic(cfg, device, seed: int = 7, gain: float = 6.0):
    """An ELIC of ``cfg`` on ``device`` in eval mode, its weights normal
    of std 1 / sqrt(fan_in) (g_a's last conv times ``gain``, so that a
    good share of the y symbols is non-zero), biases of std 0.1."""
    from aivc_tpu_torch.models.elic import Elic

    model = Elic(cfg)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in sorted(model.named_parameters()):
            v = torch.randn(p.shape, generator=gen)
            p.copy_(v / float(np.sqrt(p[0].numel())) if name.endswith(
                "weight") else 0.1 * v)
        model.g_a.conv_3.weight.mul_(gain)
    return model.to(device).eval()


def elic_wave(device: torch.device, frames: int = 2, h: int = 1080,
              w: int = 1920) -> Dict:
    """One All-Intra wave of ``frames`` 1080p frames through ELIC-N192-M320
    on seeded weights (ElicCodec): encoded, decoded, the decode checked
    bit for bit against the encoder's reconstruction, with K7's launches
    and fallbacks over the wave."""
    from aivc_tpu_torch.config import ElicConfig
    from aivc_tpu_torch.pipeline.codec import make_codec

    cfg = ElicConfig()
    codec = make_codec(cfg, seeded_elic(cfg, device), h, w, device=device)
    clip = synthetic_frames(frames, h, w, seed=4)
    ai = CodingConfig(coding_config="AI")
    encode_video(codec, clip, ai, wave_batch=frames)     # warm-up
    kernels.reset_launches()
    t = time.perf_counter()
    res = encode_video(codec, clip, ai, wave_batch=frames)
    sync(device)
    enc_s = time.perf_counter() - t
    t = time.perf_counter()
    dec = decode_video(codec, res.bitstream)
    sync(device)
    dec_s = time.perf_counter() - t
    for i in range(frames):
        for c in ("y", "u", "v"):
            if not np.array_equal(dec[i].planes[c],
                                  res.decoded_frames[i].planes[c]):
                raise AssertionError(f"ELIC frame {i} plane {c}: the decode "
                                     f"differs from the encoder's")
    return {"frames": frames, "bytes": len(res.bitstream),
            "encode_s": enc_s, "decode_s": dec_s,
            "launches": kernels.LAUNCHES["conv1x1"],
            "fallbacks": kernels.FALLBACKS["conv1x1"]}


@torch.inference_mode()
def check_gdn(inputs: Dict[str, tuple], reps: int = 10) -> Dict:
    """K4 through the exported ``gdn_fused`` on captured GDN inputs, each
    with its layer's own beta / gamma: its launches there counted from 0,
    each output against the plain version on the same input (gdn_apply
    itself where the shape rule sends gdn_fused there: equal; bf16 within
    GDN_PLAIN_ULPS; f32 equal) and within GDN_APPLY_RTOL of the layer's
    own gdn_apply; timed at the largest input."""
    worst, worst_ulps, worst_rel, apply_err = 0.0, 0.0, 0.0, 0.0
    n_diff, n_all, shapes = 0, 0, []
    dev = next(iter(inputs.values()))[0].device
    kernels.reset_launches()
    outs = {name: gdn_ops.gdn_fused(x, mod.beta, mod.gamma, mod.inverse)
            for name, (x, mod) in inputs.items()}
    launches = kernels.LAUNCHES["gdn_fused"]
    for name, (x, mod) in inputs.items():
        out = outs[name]
        beta, gamma = gdn_ops.reparam(mod.beta, mod.gamma)
        lib = gdn_ops.gdn_apply(x, mod.beta, mod.gamma, mod.inverse)
        fused = gdn_ops.fused_shape(x)
        ref = gdn_ops.gdn_fused_plain(x, beta, gamma, mod.inverse) \
            if fused else lib
        diff = (out.float() - ref.float()).abs()
        err = float(diff.max())
        ulps = float(bf16_ulps(out, ref).max())
        rel = float((diff / ref.float().abs().clamp_min(1e-30)).max())
        worst, worst_ulps = max(worst, err), max(worst_ulps, ulps)
        worst_rel = max(worst_rel, rel)
        n_diff += int((diff != 0).sum())   # NaN counts as differing
        n_all += diff.numel()
        lib_rel = float(((out.float() - lib.float()).abs()
                         / (lib.float().abs() + GDN_APPLY_ATOL)).max())
        apply_err = max(apply_err, lib_rel)
        shapes.append((name, tuple(x.shape), err, ulps, lib_rel))
        # Written as not (x <= limit), so that a NaN fails.
        exact = not fused or x.dtype != torch.bfloat16
        if not ((err <= 0.0 or not exact) and ulps <= GDN_PLAIN_ULPS):
            raise AssertionError(f"K4 on {name}: {err} ({ulps} bf16 ulps) "
                                 "from its plain version")
        if not lib_rel <= GDN_APPLY_RTOL:
            raise AssertionError(f"K4 on {name}: relative error {lib_rel} "
                                 "from the layer's gdn_apply")
    name = max(inputs, key=lambda k: inputs[k][0].numel())
    x, mod = inputs[name]
    beta, gamma = gdn_ops.reparam(mod.beta, mod.gamma)
    kern = (gdn_ops.gdn_fused_cuda if dev.type == "cuda"
            else gdn_ops.gdn_fused_plain)
    ms = time_ms(lambda: kern(x, beta, gamma, mod.inverse), dev, reps,
                 hide_host=True)
    plain = time_ms(lambda: gdn_ops.gdn_fused_plain(x, beta, gamma,
                                                    mod.inverse), dev, 1)
    lib_ms = time_ms(lambda: gdn_ops.gdn_apply(x, mod.beta, mod.gamma,
                                               mod.inverse), dev, reps,
                     hide_host=True)
    B, C, H, W = x.shape
    n = B * H * W
    # bf16 products run on the tensor cores; f32 on the CUDA cores.
    rate = (BF16_TC_OPS_PER_S if x.dtype == torch.bfloat16
            else F32_OPS_PER_S)
    rec = _record("gdn_fused", worst, ms, plain,
                  2 * n * C * x.element_size() + 4 * C * C + 4 * C,
                  2 * n * C * C + 6 * n * C, library_ms=lib_ms,
                  ops_per_s=rate)
    rec["timed_on"] = f"{name} {list(x.shape)} {str(x.dtype)[6:]}"
    rec["inputs"] = shapes
    rec["apply_rel_err"] = apply_err
    rec["max_ulps"] = worst_ulps
    rec["max_rel_err"] = worst_rel
    rec["differing_share"] = n_diff / max(n_all, 1)
    if not rec["differing_share"] <= GDN_DIFFERING_SHARE:
        raise AssertionError(f"K4: {rec['differing_share']} of the outputs "
                             "differ from the plain version, more than "
                             f"{GDN_DIFFERING_SHARE}")
    rec["launches"] = launches
    return rec


def kernels_line(records: List[Dict], launches: Dict[str, int]) -> str:
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return json.dumps({"kernels": [
        {**{k: r[k] for k in keys}, "launches": launches[r["name"]]}
        for r in records]})


# ---------------------------------------------------------------------------
# CLI path (python -m aivc_tpu_torch)
# ---------------------------------------------------------------------------

def write_clip(frames, directory, name: str = "clip") -> Path:
    """Frames -> <directory>/<name>_<W>x<H>_30_420.yuv (the CLI reads the
    geometry from the name)."""
    h, w = frames[0]["y"].shape
    path = Path(directory) / f"{name}_{w}x{h}_30_420.yuv"
    with YuvWriter(path) as wr:
        for f in frames:
            wr.write_frame(f)
    return path


def parse_results(out: str) -> Dict[str, str]:
    """The CLI's [RESULT] lines -> {label: value}."""
    rows = {}
    for ln in out.splitlines():
        if ln.startswith("[RESULT]"):
            label, value = ln[len("[RESULT]"):].split(":", 1)
            rows[label.strip()] = value.strip()
    return rows


class EncodeWatch:
    """Wraps pipeline/video.py:encode_video, which the CLI calls through
    its module, and keeps the encoder's reconstructions of the last call
    while open."""

    def __init__(self):
        self.decoded = None
        self._fn = video_mod.encode_video
        video_mod.encode_video = self._call

    def _call(self, *args, **kwargs):
        res = self._fn(*args, **kwargs)
        self.decoded = res.decoded_frames
        return res

    def close(self) -> None:
        if video_mod.encode_video == self._call:
            video_mod.encode_video = self._fn


class RansWatch:
    """Wraps coding/vrans.py:encode_cuda, which encode_batch calls through
    its module, and keeps the inputs (sym, rows, table, k, segments) of
    the launch with the most dependent steps while open."""

    def __init__(self):
        self.inputs = None
        self._kernel = vrans.encode_cuda
        vrans.encode_cuda = self._call

    def _call(self, sym, rows, table, k, segment_steps=()):
        steps = sym.shape[1] // k
        if self.inputs is None or steps > self.inputs[0].shape[1] // \
                self.inputs[3]:
            self.inputs = (sym.clone(), rows.clone(), table, k,
                           tuple(segment_steps))
        return self._kernel(sym, rows, table, k, segment_steps)

    def close(self) -> None:
        if vrans.encode_cuda == self._call:
            vrans.encode_cuda = self._kernel


def run_cli(argv: List[str], keep_recon: bool = False) -> Dict:
    """``cli.main(argv)`` in this process: its [RESULT] lines, the
    kernels' launches and steps in the run (counts set to 0 just before,
    read just after), its wall seconds and, with ``keep_recon``, its
    encoder's reconstructions (``recon``).  Where it decodes to ``-o``,
    every decoded frame is held bit for bit against the encoder's
    reconstruction of the same run."""
    from aivc_tpu_torch import cli

    watch = EncodeWatch()
    buf = io.StringIO()
    kernels.reset_launches()
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
    finally:
        watch.close()
    seconds = time.time() - t0
    launches, steps = dict(kernels.LAUNCHES), dict(kernels.STEPS)
    out = buf.getvalue()
    if rc != 0:
        raise AssertionError(f"cli {argv} exited {rc}:\n{out}")
    checked = 0
    mode = argv[argv.index("--mode") + 1] if "--mode" in argv else "all"
    if mode == "all" and "-o" in argv and watch.decoded is not None:
        w, h, _ = parse_geometry(argv[argv.index("-i") + 1])
        dec = YuvReader(argv[argv.index("-o") + 1], w, h)
        if dec.n_frames != len(watch.decoded):
            raise AssertionError(f"decoded {dec.n_frames} frames, encoded "
                                 f"{len(watch.decoded)}")
        for i, rec in watch.decoded.items():
            got = dec.read_frame(i)
            for c in ("y", "u", "v"):
                if not np.array_equal(got[c], rec[c]):
                    raise AssertionError(
                        f"cli {argv}: decoded frame {i} plane {c} differs "
                        "from the encoder's reconstruction")
            checked += 1
    return {"results": parse_results(out), "launches": launches,
            "steps": steps, "seconds": seconds, "checked": checked,
            "stdout": out,
            "recon": watch.decoded if keep_recon else None}


def decode_in_process(argv: List[str], cwd, timeout_s: int = 900) -> Dict:
    """``python -m aivc_tpu_torch <argv> --mode decode`` in a second
    process (from ``cwd``, the checkout's root): its [RESULT] lines and
    wall seconds; raises if it fails."""
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "aivc_tpu_torch", *argv, "--mode", "decode"],
        capture_output=True, text=True, cwd=str(cwd), timeout=timeout_s)
    if proc.returncode != 0:
        raise AssertionError(f"decode process exited {proc.returncode}:\n"
                             f"{proc.stdout}\n{proc.stderr}")
    return {"results": parse_results(proc.stdout),
            "seconds": time.time() - t0, "stdout": proc.stdout}


def check_rans_on(inputs, plain_budget_s: float = 10.0,
                  reps: int = 3) -> Dict:
    """K1 and K2 on a captured wave (RansWatch): the whole wave timed,
    per dependent step; both held bit for bit against their plain
    versions on its first steps, as many as keep each plain run within
    about ``plain_budget_s`` (one plain step timed first)."""
    sym, rows, table, k, segs = inputs
    dev = sym.device
    steps = sym.shape[1] // k
    enc = lambda: vrans.encode_batch(sym, rows, table, k, segs)  # noqa: E731
    buf, st, seg_g = enc()
    words = _words_for_decode(buf, seg_g)
    dec = lambda: vrans.decode_batch(words, st, rows, table, k)  # noqa: E731
    if not torch.equal(dec()[0], sym):
        raise AssertionError("decode(encode(x)) != x on the captured wave")
    ms_enc = time_ms(enc, dev, reps, hide_host=True)
    ms_dec = time_ms(dec, dev, reps, hide_host=True)

    probe = min(steps, 64)
    t_step = time_ms(lambda: vrans.encode_plain(
        sym[:, :probe * k].contiguous(), rows[:, :probe * k].contiguous(),
        table, k), dev, 1, warmup=0) / 1e3 / probe
    cut = max(1, min(steps, int(plain_budget_s / max(t_step, 1e-9))))
    cs, cr = sym[:, :cut * k].contiguous(), rows[:, :cut * k].contiguous()
    t0 = time.time()
    ref = vrans.encode_plain(cs, cr, table, k)
    plain_enc_s = time.time() - t0
    out = vrans.encode_batch(cs, cr, table, k)
    if not encode_equal(out, ref):
        raise AssertionError(f"K1 differs from the plain encode on the "
                             f"captured wave's first {cut} steps")
    cw = _words_for_decode(out[0], out[2])
    t0 = time.time()
    pdec = vrans.decode_plain(cw, out[1], cr, table, k)
    plain_dec_s = time.time() - t0
    kdec = vrans.decode_batch(cw, out[1], cr, table, k)
    if not all(torch.equal(a, b) for a, b in zip(kdec, pdec)):
        raise AssertionError(f"K2 differs from the plain decode on the "
                             f"captured wave's first {cut} steps")
    return {"shape": list(sym.shape), "k": k, "steps": steps,
            "checked_steps": cut, "enc_ms": ms_enc, "dec_ms": ms_dec,
            "enc_us_per_step": ms_enc * 1e3 / steps,
            "dec_us_per_step": ms_dec * 1e3 / steps,
            "plain_enc_s": plain_enc_s, "plain_dec_s": plain_dec_s}


def cli_runs(frames, ckpt: str, tmp, device: torch.device, root,
             library_stream: bytes, say: Callable[[str], None],
             gop: int = 8, wave_batch: int = 8) -> Dict:
    """The CLI phase: the clip written to ``tmp`` and coded through
    ``cli.main`` in every structure and with every flag of the CLI, each
    run's decode held against its encoder's reconstruction:
      ra        RA (GOP ``gop``) with --rate_audit: the stream must be
                ``library_stream``, byte for byte; then decoded in a
                second process against the md5 manifest of its encoder's
                reconstructions ("identical");
      ra-debug  RA with --bitstream_debug (latent md5 trailers, [AC-dev]
                self-checks, the encoder's manifest), decoded here and in
                a second process;
      ai, ldp   All-Intra with --wave_batch, and LDP;
      host      RA with --entropy_backend host (K1, K2 never launch);
      resume    RA, GOP 4, with --stream_dir: one GOP chunk deleted and
                the encode run again gives the same bytes;
      priority  RA with --rate_priority and --rate_audit, K1's largest
                launch captured for ``check_rans_on``;
      ladder    ladder name 5 (gain surgery) on two frames, All-Intra;
                ladder name 7 refused where its checkpoint is absent."""
    tmp = Path(tmp)
    clip = write_clip(frames, tmp)
    cpu = ["--cpu"] if device.type == "cpu" else []

    def args(name, structure="RA", g=gop, *extra):
        return [*cpu, "-i", str(clip), "-o", str(tmp / f"{name}.yuv"),
                "--bitstream_out", str(tmp / f"{name}.bin"),
                "--coding_config", structure, "--gop_size", str(g),
                "--intra_period", str(g), "--model", ckpt,
                "--wave_batch", str(wave_batch), *extra]

    w, h, _ = parse_geometry(clip)

    def decode_elsewhere(name, argv):
        """Decode ``name``'s stream in a second process against the md5
        manifest beside it: "identical", and the same frames as the
        decode in this process."""
        sep = decode_in_process(argv + ["--bitstream_debug", "-o",
                                        str(tmp / f"{name}-2.yuv")], root)
        if sep["results"].get("enc/dec drift check") != "identical":
            raise AssertionError(f"{name}, decoded in a second process: "
                                 f"{sep['stdout']}")
        a = YuvReader(tmp / f"{name}-2.yuv", w, h)
        b = YuvReader(tmp / f"{name}.yuv", w, h)
        if any(not np.array_equal(a.read_frame(i)[c], b.read_frame(i)[c])
               for i in range(len(frames)) for c in ("y", "u", "v")):
            raise AssertionError(f"{name}: the second process decoded "
                                 "other frames")
        runs[name]["decode_process"] = sep

    runs: Dict[str, Dict] = {}
    runs["ra"] = run_cli(args("ra", "RA", gop, "--rate_audit"),
                         keep_recon=True)
    if (tmp / "ra.bin").read_bytes() != library_stream:
        raise AssertionError("the CLI's RA stream differs from the library "
                             "phase's stream of the same frames")
    # The same stream in a second process, against the manifest of this
    # encode's reconstructions (the one --bitstream_debug would write).
    write_md5_manifest(runs["ra"].pop("recon"),
                       str(tmp / "ra.bin") + ".md5.json")
    decode_elsewhere("ra", args("ra", "RA", gop))
    # A debug stream (latent md5 trailers, the encoder's own manifest):
    # a second process that drifted would name the first latent.
    runs["ra-debug"] = run_cli(args("ra-debug", "RA", gop,
                                    "--bitstream_debug"))
    decode_elsewhere("ra-debug", args("ra-debug", "RA", gop))
    runs["ai"] = run_cli(args("ai", "AI", 1))
    runs["ldp"] = run_cli(args("ldp", "LDP", gop))
    runs["host"] = run_cli(args("host", "RA", gop, "--entropy_backend",
                                "host"))
    sd = ["--stream_dir", str(tmp / "streams")]
    runs["resume"] = run_cli(args("resume", "RA", 4, *sd))
    full = (tmp / "resume.bin").read_bytes()
    (tmp / "streams" / "gop_00001.bin").unlink()
    runs["resume-again"] = run_cli(args("resume", "RA", 4, *sd))
    if (tmp / "resume.bin").read_bytes() != full:
        raise AssertionError("the resumed encode wrote other bytes")
    watch = RansWatch()
    try:
        runs["priority"] = run_cli(args("priority", "RA", gop,
                                        "--rate_priority", "--rate_audit"))
    finally:
        watch.close()
    runs["priority"]["captured"] = watch.inputs
    ladder = args("ladder5", "AI", 1, "--end_frame", "1")
    ladder[ladder.index("--model") + 1] = "tpu-msssim-2021cc-5"
    runs["ladder5"] = run_cli(ladder)
    if not (Path(root) / "models_ckpt" / "bf16-lr").is_dir():
        from aivc_tpu_torch import cli

        ladder[ladder.index("--model") + 1] = "tpu-msssim-2021cc-7"
        with contextlib.redirect_stderr(io.StringIO()) as err:
            rc = cli.main(ladder)
        if rc == 0 or "not on disk" not in err.getvalue():
            raise AssertionError("ladder name 7 without its checkpoint was "
                                 "not refused")
        runs["ladder7"] = {"refused": err.getvalue().strip()}
    expect = {  # kernel -> runs that must launch it / must not
        "rans_encode": ({"ra", "ai", "ldp", "priority"}, {"host"}),
        "rans_decode": ({"ra", "ai", "ldp", "priority"}, {"host"}),
        "warp_packed": ({"ra", "ldp", "host", "priority"}, {"ai"}),
    }
    if device.type == "cuda":
        for kname, (must, never) in expect.items():
            for r in must:
                if runs[r]["launches"][kname] == 0:
                    raise AssertionError(f"{kname} never launched in the "
                                         f"CLI's {r} run")
            for r in never:
                if runs[r]["launches"][kname]:
                    raise AssertionError(f"{kname} launched in the CLI's "
                                         f"{r} run")
    return runs


# ---------------------------------------------------------------------------
# Training path (python -m aivc_tpu_torch.train)
# ---------------------------------------------------------------------------

# train-small: one make_train_step step of bf16-r5 (128x128, batch 2,
# accum 2, 1_GOP_2, ms_ssim) on the card and on the host with the same
# frames and noise, whose bf16 convolutions round differently: (kind,
# limit) per log, and limits on the two gradient vectors (the mean over
# the microbatches, before clipping).  Measured on the H100
# (chip_smoke.py): loss 3.0e-3 relative (MS-SSIM's, as dist_pure in
# forward-small), rate_bpp 2.5e-4 relative, PSNR 0.0074 dB, grad norm
# 9.5e-3 relative, cosine 0.999959, relative L2 0.0132; the limits are
# three to twenty times that.
TRAIN_SMALL_TOL = {"loss": ("rel", 0.01), "rate_bpp": ("rel", 0.003),
                   "psnr": ("abs", 0.1), "grad_norm": ("rel", 0.1)}
TRAIN_SMALL_MIN_COSINE = 0.999
TRAIN_SMALL_MAX_REL_L2 = 0.15
# Each gradient leaf on its own is held on a second step of the same
# checkpoint with both nets in float32 (TF32 off, the step's rule), so
# that a fault in a small leaf (GDN beta / gamma, the factorized prior,
# gains) cannot hide under the convolution weights' norm.  In bf16 a
# leaf whose true gradient is near 0 is rounding noise on either device
# (mofnet.g_a's attention branch behind a saturated gate: its bias 5.6e-11
# in float32; card against host up to 5.7 relative L2 there; a GDN gamma
# leaf 47 relative L2 from its float32 value on the host, 76 on the
# card), so no per-leaf limit can be set there.  Measured in float32
# (H100 against the host): logs within 3.6e-6 relative (grad norm
# 3.2e-5), every leaf within 2.3e-3 relative L2 (a GDN beta; median
# 3.0e-6), cosine 0.999997 at worst.
TRAIN_SMALL_F32_TOL = {"loss": ("rel", 1e-4), "rate_bpp": ("rel", 1e-4),
                       "psnr": ("abs", 1e-3), "grad_norm": ("rel", 1e-3)}
TRAIN_SMALL_F32_LEAF_MAX_REL_L2 = 0.02
TRAIN_SMALL_F32_LEAF_MIN_COSINE = 0.9998
# The round-5 continuation recipe (docs/STATUS.md:208-216), as a slice of
# a leg: --steps STEP0 + N with --step0 STEP0 past the 200-step warmup, so
# the N steps take the schedule's peak rate with Adam's state fresh.
RECIPE_STEP0, RECIPE_STEPS = 200, 6


class HostNoise:
    """A noise source (ops/quantizer.py) drawing on the host from a seeded
    generator and copying to the asking tensor's device, so that two
    devices see the same noise.  The trainer draws on the device
    (GeneratorNoise); this is for comparisons only."""

    def __init__(self, seed: int):
        self.gen = torch.Generator().manual_seed(seed)

    def uniform(self, like: torch.Tensor) -> torch.Tensor:
        u = torch.rand(tuple(like.shape), generator=self.gen) - 0.5
        return u.to(like.device)


@contextlib.contextmanager
def plain_float_warp():
    """The float warp off the AIVC_WARP=pallas route for the block, as in
    a process without the switch (the trainer's): that route, like JAX's,
    has no gradient."""
    saved = warp_ops._USE_PALLAS
    warp_ops._USE_PALLAS = False
    try:
        yield
    finally:
        warp_ops._USE_PALLAS = saved


def _train_small_step(model, cfg, gop, frames, dev, accum, idx_rate, lr,
                      mesh=None):
    """One make_train_step step (over ``mesh`` where given): its logs
    with the seconds and largest parameter change, and each parameter's
    gradient on the host."""
    from aivc_tpu_torch.train.trainer import make_optimizer, make_train_step

    params = [p for _, p in model.named_parameters()]
    before = [p.detach().clone() for p in params]
    step = make_train_step(model, cfg, gop, make_optimizer(params, lr),
                           dist_loss="ms_ssim", accum=accum, mesh=mesh)
    sync(dev)
    t0 = time.time()
    logs = step(frames.to(dev), idx_rate, HostNoise(5))
    sync(dev)
    logs["seconds"] = time.time() - t0
    logs["max_param_change"] = max(float((p.detach() - b).abs().max())
                                   for p, b in zip(params, before))
    if logs["step_skipped"] or not all(math.isfinite(v)
                                       for v in logs.values()):
        raise AssertionError(f"train-small on {dev}: {logs}")
    return logs, {n: p.grad.detach().float().cpu()
                  for n, p in model.named_parameters()}


def train_small_inputs(size: int = 128, batch: int = 2, accum: int = 2,
                       gop_name: str = "1_GOP_2") -> torch.Tensor:
    """train-small's frames (train/data.py:make_batch, no photos), [n, B,
    3, H, W] on the host."""
    from aivc_tpu_torch.train.data import make_batch

    n = len(generate_gop_struct(gop_name))
    return torch.from_numpy(make_batch(
        np.random.default_rng(0), n, batch * accum, size)).permute(
            0, 1, 4, 2, 3).contiguous()


def f32_config(cfg):
    """``cfg`` with both nets in float32 (train-small's second step)."""
    import dataclasses as dc

    return dc.replace(cfg, mofnet=dc.replace(cfg.mofnet, dtype="float32"),
                      codecnet=dc.replace(cfg.codecnet, dtype="float32"))


def train_small(ckpt: str, device: torch.device, size: int = 128,
                batch: int = 2, accum: int = 2, gop_name: str = "1_GOP_2",
                idx_rate: int = 3, lr: float = 4e-6) -> Dict:
    """One train step of ``ckpt`` on ``device`` and on the host, with the
    same frames (train/data.py:make_batch, no photos) and the same noise
    (HostNoise), in the checkpoint's own precision and then with both
    nets in float32: each side's logs, seconds and largest parameter
    change; the cosine and relative L2 distance of the device's gradient
    vector from the host's, with the worst leaf's; and of the float32
    step the worst leaf's.  Raises past TRAIN_SMALL_TOL and the gradient
    limits, and past TRAIN_SMALL_F32_* in float32."""
    from aivc_tpu_torch.config import ModelConfig
    from aivc_tpu_torch.utils.checkpoint import model_from_params, read_params

    gop = generate_gop_struct(gop_name)
    frames = train_small_inputs(size, batch, accum, gop_name)
    cfg = ModelConfig.from_json((Path(ckpt) / "config.json").read_text())
    cfg32 = f32_config(cfg)
    raw = read_params(ckpt)
    res = {}
    with plain_float_warp():
        for prec, c in (("own", cfg), ("f32", cfg32)):
            for name, dev in (("device", device),
                              ("host", torch.device("cpu"))):
                model = model_from_params(c, raw, dev)
                res[prec, name] = _train_small_step(
                    model, c, gop, frames, dev, accum, idx_rate, lr)
                del model
    out = {}
    for prec, tol in (("own", TRAIN_SMALL_TOL), ("f32", TRAIN_SMALL_F32_TOL)):
        (ld, gd), (lh, gh) = res[prec, "device"], res[prec, "host"]
        diffs = compare_logs(ld, lh, tol, f"train-small ({prec})")
        g = torch.cat([v.reshape(-1) for v in gd.values()]).double()
        h = torch.cat([v.reshape(-1) for v in gh.values()]).double()
        rows = leaf_distances(gd, gh)
        out[prec] = {
            "device": ld, "host": lh, "diffs": diffs,
            "cosine": float(torch.dot(g, h) / (g.norm() * h.norm())),
            "rel_l2": float((g - h).norm() / h.norm()),
            "n_params": g.numel(), "n_leaves": len(rows),
            "worst_leaf_rel_l2": max(rows, key=lambda r: r[1]),
            "worst_leaf_cosine": min(rows, key=lambda r: r[2])}
    own, f32 = out["own"], out["f32"]
    if not (own["cosine"] >= TRAIN_SMALL_MIN_COSINE
            and own["rel_l2"] <= TRAIN_SMALL_MAX_REL_L2):
        raise AssertionError(
            f"train-small: gradient cosine {own['cosine']} (limit "
            f"{TRAIN_SMALL_MIN_COSINE}), relative L2 {own['rel_l2']} "
            f"(limit {TRAIN_SMALL_MAX_REL_L2})")
    if not (f32["worst_leaf_rel_l2"][1] <= TRAIN_SMALL_F32_LEAF_MAX_REL_L2
            and f32["worst_leaf_cosine"][2]
            >= TRAIN_SMALL_F32_LEAF_MIN_COSINE):
        raise AssertionError(
            f"train-small (float32): worst leaf relative L2 "
            f"{f32['worst_leaf_rel_l2']} (limit "
            f"{TRAIN_SMALL_F32_LEAF_MAX_REL_L2}), worst leaf cosine "
            f"{f32['worst_leaf_cosine']} (limit "
            f"{TRAIN_SMALL_F32_LEAF_MIN_COSINE})")
    return dict(own, f32=f32)


def leaf_distances(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]
                   ) -> List[tuple]:
    """(name, relative L2 of a from b, cosine) for each gradient leaf,
    in float64; a leaf zero on both sides reads (0, 1), zero on one side
    only (inf, 0)."""
    rows = []
    for k, bv in b.items():
        x, y = a[k].double().reshape(-1), bv.double().reshape(-1)
        nx, ny = float(x.norm()), float(y.norm())
        if ny == 0.0 or nx == 0.0:
            rows.append((k, 0.0, 1.0) if nx == ny else (k, math.inf, 0.0))
            continue
        rows.append((k, float((x - y).norm()) / ny,
                     float(torch.dot(x, y)) / (nx * ny)))
    return rows


def recipe_argv(ckpt: str, out: str, steps: int = RECIPE_STEPS,
                step0: int = RECIPE_STEP0) -> List[str]:
    """The round-5 continuation recipe of bf16-r5 at 192x192."""
    return ["--resume", ckpt, "--size", "192", "--batch", "2", "--accum",
            "4", "--gop", "1_GOP_4", "--dist", "ms_ssim", "--ema", "0.998",
            "--lr", "4e-6", "--lr_final", "1e-6", "--warmup", "200",
            "--steps", str(step0 + steps), "--step0", str(step0),
            "--log_every", "1", "--out", out]


def train_recipe(ckpt: str, out: str, root, device: torch.device,
                 steps: int = RECIPE_STEPS, timeout_s: int = 600) -> Dict:
    """``python -m aivc_tpu_torch.train`` with the recipe on ``device``, in
    a subprocess whose environment has no AIVC_WARP (the trainer's own
    settings), then
    checks: every logged loss finite, at least one step applied, the
    files of the checkpoint, its optimizer state and the EMA twin, each
    reloaded through the port's reader, the parameters moved from
    ``ckpt``'s, and the eval forward of the written checkpoint at
    128x128 finite."""
    from aivc_tpu_torch.train.trainer import make_optimizer
    from aivc_tpu_torch.utils.checkpoint import read_opt_state

    env = {k: v for k, v in os.environ.items() if k != "AIVC_WARP"}
    env["PYTHONPATH"] = str(root)
    argv = recipe_argv(ckpt, out, steps)
    if device.type == "cpu":
        argv.append("--cpu")
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "aivc_tpu_torch.train"]
                          + argv, capture_output=True, text=True, env=env,
                          cwd=root, timeout=timeout_s)
    wall = time.time() - t0
    if proc.returncode != 0:
        raise AssertionError(f"train-recipe exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    lines = proc.stdout.splitlines()
    step_lines = [ln for ln in lines if ln.startswith("step ")
                  and " loss " in ln]
    skipped = [ln for ln in lines if ln.startswith("step ")
               and "skipped" in ln]
    losses = [float(ln.split(" loss ")[1].split()[0]) for ln in step_lines]
    if len(step_lines) != steps or not all(math.isfinite(v)
                                           for v in losses):
        raise AssertionError(f"train-recipe: step lines {step_lines}")
    if len(skipped) >= steps:
        raise AssertionError(f"train-recipe: every step skipped {skipped}")
    paths = {"params": Path(out) / "params.msgpack",
             "config": Path(out) / "config.json",
             "opt_state": Path(out) / "opt_state.msgpack",
             "ema": Path(f"{out}-ema") / "params.msgpack"}
    missing = [k for k, p in paths.items() if not p.is_file()]
    if missing:
        raise AssertionError(f"train-recipe: missing files {missing}")
    _, start = load_checkpoint(ckpt, device="cpu")
    cfg, model = load_checkpoint(out, device="cpu")
    _, ema = load_checkpoint(f"{out}-ema", device="cpu")
    sd0, sd1, sde = start.state_dict(), model.state_dict(), ema.state_dict()
    moved = max(float((sd1[k] - sd0[k]).abs().max()) for k in sd0)
    ema_moved = max(float((sde[k] - sd0[k]).abs().max()) for k in sd0)
    if not moved > 0.0:
        raise AssertionError("train-recipe: the parameters did not move")
    names = [n for n, _ in model.named_parameters()]
    opt = make_optimizer([p for _, p in model.named_parameters()], 4e-6,
                         lr_final=1e-6, decay_steps=RECIPE_STEP0 + steps,
                         warmup_steps=200)
    read_opt_state(paths["opt_state"], opt, names)
    applied = steps - len(skipped)
    if opt.count != applied or opt.schedule_count != RECIPE_STEP0 + applied:
        raise AssertionError(f"train-recipe: optimizer counts {opt.count} / "
                             f"{opt.schedule_count} after {applied} steps")
    del start, model, ema, sd0, sd1, sde
    fwd = forward_small(out, device, 0.0)["device"]
    timing = [ln for ln in lines if ln.startswith("timing: ")]
    return {"lines": [ln for ln in lines if ln.startswith(
                ("resumed", "WARNING", "schedule", "photo", "step ",
                 "timing", "saved"))],
            "wall_s": wall, "losses": losses, "skipped": len(skipped),
            "max_param_change": moved, "ema_max_change": ema_moved,
            "opt_count": opt.count, "schedule_count": opt.schedule_count,
            "file_mb": {k: p.stat().st_size / 2**20
                        for k, p in paths.items()},
            "forward_logs": fwd, "timing": timing[0] if timing else ""}


# ---------------------------------------------------------------------------
# golden: the suite's pins on the card (eval/golden.py)
# ---------------------------------------------------------------------------

# The pins the card runs: every suite pin of bf16-r5, the sanity pin, and
# ra_240p_lowrate, whose checkpoint (models_ckpt/bf16-lr) .chiprunignore
# keeps off the card's machine, so it is reported as skipped there.
GOLDEN_PINS = ("ai_240p", "ra_240p", "ldp_240p", "ra_720p", "ra_1080p",
               "golden_sanity", "ra_240p_lowrate")
# The port's torch MS-SSIM (evaluate_frames, float32 on the card) against
# the numpy oracle (ops/metrics_np.msssim_np, float64 on the host) on the
# same decoded frames; tests/test_ops.py holds JAX's msssim to the oracle
# within the same 2e-4.
ORACLE_MS_SSIM_TOL = 2e-4


def golden_runs(device: torch.device, names=GOLDEN_PINS, limits=None,
                say: Callable[[str], None] = print) -> Dict[str, Dict]:
    """Each pin through eval/golden.py:run_pin on ``device`` (a skipped
    pin says why), held against the pin within ``limits`` (the card's by
    default), its decode bit-exact, its MS-SSIM against the numpy oracle
    on the host; one line each.  Raises after the last pin if any
    failed."""
    from aivc_tpu_torch.eval import golden

    limits = limits or golden.CARD_LIMITS
    pins = golden.suite_pins()
    loaded, out, failed = {}, {}, []
    for name in names:
        pin = pins[name]
        reason = golden.skip_reason(pin)
        if reason:
            out[name] = {"skipped": reason}
            say(f"golden {name}: skipped ({reason})")
            continue
        if pin["ckpt"] not in loaded:
            loaded[pin["ckpt"]] = load_checkpoint(
                str(golden.REPO / pin["ckpt"]), device=device)
        got = golden.run_pin(pin, device, keep=True,
                             loaded=loaded[pin["ckpt"]])
        t0 = time.time()
        oracle = golden.oracle_ms_ssim(got.pop("frames"),
                                       got.pop("decoded"))["ms_ssim"]
        got["oracle_s"] = time.time() - t0
        got["oracle_ms_ssim"] = oracle
        got["oracle_err"] = abs(got["ms_ssim"] - oracle)
        cmp = golden.compare(got, pin["expect"], limits)
        got.update(cmp=cmp, expect=pin["expect"])
        out[name] = got
        la = got["launches"]
        say(golden.report_line(name, got, pin["expect"], cmp)
            .replace("[GOLDEN] ", "golden "))
        say(f"golden {name}: encode {got['encode_s']:.2f} s, decode "
            f"{got['decode_s']:.2f} s; launches rans_encode "
            f"{la['rans_encode']}, rans_decode {la['rans_decode']}, "
            f"warp_packed {la['warp_packed']}; MS-SSIM {got['ms_ssim']:.7f} "
            f"against the numpy oracle's {oracle:.7f}: "
            f"{got['oracle_err']:.2e} (limit {ORACLE_MS_SSIM_TOL}; oracle "
            f"{got['oracle_s']:.1f} s on the host)")
        need = ["rans_encode", "rans_decode"]
        if pin["config"]["coding"] != "AI":
            need.append("warp_packed")
        if device.type == "cuda" and any(la[k] == 0 for k in need):
            failed.append(f"{name}: kernels {need} not all launched {la}")
        if not cmp["ok"]:
            failed.append(f"{name}: outside the limits {limits} or decode "
                          f"not bit-exact")
        if not got["oracle_err"] <= ORACLE_MS_SSIM_TOL:
            failed.append(f"{name}: MS-SSIM {got['oracle_err']:.2e} from "
                          f"the numpy oracle")
    if failed:
        raise AssertionError("golden: " + "; ".join(failed))
    return out


# ---------------------------------------------------------------------------
# formats: the dense v1 stream and another schedule byte
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def switched(**switches: str):
    """The environment switches set while a codec is built inside, and
    restored after (FrameCodec reads them at construction)."""
    old = {k: os.environ.get(k) for k in switches}
    os.environ.update(switches)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class RansDecodeWatch:
    """Wraps coding/vrans.py:decode_cuda and keeps the inputs (words,
    states, rows, table, k, g0) of every launch while open."""

    def __init__(self):
        self.inputs = []
        self._kernel = vrans.decode_cuda
        vrans.decode_cuda = self._call

    def _call(self, words, states, rows, table, k, g0=None):
        self.inputs.append((words.clone(), states.clone(), rows.clone(),
                            table, k, None if g0 is None else g0.clone()))
        return self._kernel(words, states, rows, table, k, g0)

    def close(self) -> None:
        if vrans.decode_cuda == self._call:
            vrans.decode_cuda = self._kernel


def check_encode_launch(inputs) -> Dict:
    """K1 on a captured launch (RansWatch), segments and all, against its
    plain version on the same inputs, bit for bit."""
    sym, rows, table, k, segs = inputs
    t0 = time.time()
    ref = vrans.encode_plain(sym, rows, table, k, segs)
    plain_s = time.time() - t0
    if not encode_equal(vrans.encode_batch(sym, rows, table, k, segs), ref):
        raise AssertionError(f"K1 differs from the plain encode on the "
                             f"captured launch {list(sym.shape)}")
    return {"shape": list(sym.shape), "k": k, "segments": list(segs),
            "steps": sym.shape[1] // k, "plain_s": plain_s}


def check_decode_launches(launches) -> Dict:
    """Every captured K2 launch (RansDecodeWatch) against its plain
    version on the same inputs: symbols, states and word offsets."""
    shapes = []
    for words, states, rows, table, k, g0 in launches:
        got = vrans.decode_batch(words, states, rows, table, k, g0)
        ref = vrans.decode_plain(words, states, rows, table, k, g0)
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            raise AssertionError(f"K2 differs from the plain decode on a "
                                 f"captured launch {list(rows.shape)} K {k}")
        shapes.append((list(rows.shape), k))
    return {"launches": len(shapes), "shapes": shapes}


def frame_chunks(bitstream: bytes) -> List[Dict]:
    """Every frame container of a muxed bitstream, unpacked."""
    return [bs.unpack_frame(fb) for g in bs.unpack_video(bitstream)[1]
            for fb in bs.unpack_gop(g)[1]]


def formats_runs(ckpt: str, frames, device: torch.device,
                 wave_batch: int = 8, gop: int = 8) -> Dict[str, Dict]:
    """The clip coded three ways through the entry points, each decode
    bit-exact (code_clip) with its kernels' launches (counts set to 0
    just before, read just after): the default v2 stream; the dense v1
    stream (AIVC_VRANS_ELIDE=0), whose deepest K1 launch and every K2
    launch are kept for their checks ("captured_enc", "captured_dec";
    none on the host); and AIVC_GDN_LOWP=0 AIVC_DC_OFFSET=0 (schedule
    0x0D).  Then the v2 stream handed to the 0x0D codec must raise the
    schedule error."""
    cfg, model = load_checkpoint(ckpt, device=device)
    h, w = frames[0]["y"].shape
    out, codecs = {}, {}
    for name, switches in (("v2", {}), ("v1", {"AIVC_VRANS_ELIDE": "0"}),
                           ("sched", {"AIVC_GDN_LOWP": "0",
                                      "AIVC_DC_OFFSET": "0"})):
        with switched(**switches):
            codec = FrameCodec(cfg, model, h, w, device=device)
        watches = ((RansWatch(), RansDecodeWatch()) if name == "v1"
                   else ())
        kernels.reset_launches()
        try:
            res = code_clip(codec, frames, wave_batch=wave_batch, gop=gop)
        finally:
            for wt in watches:
                wt.close()
        res["launches"] = dict(kernels.LAUNCHES)
        res["sched"] = codec.sched_bits
        res["elide"] = codec.elide
        codecs[name] = codec
        if watches:
            res["captured_enc"] = watches[0].inputs
            res["captured_dec"] = watches[1].inputs
        out[name] = res
    if any(c["codecnet_z"][0] & vrans.CHUNK_V2
           for c in frame_chunks(out["v1"]["bitstream"])):
        raise AssertionError("AIVC_VRANS_ELIDE=0 wrote a v2 chunk")
    if any(c.get("__dc__") is not None
           for c in frame_chunks(out["sched"]["bitstream"])):
        raise AssertionError("AIVC_DC_OFFSET=0 wrote a DC trailer")
    try:
        decode_video(codecs["sched"], out["v2"]["bitstream"])
    except ValueError as e:
        out["refused"] = str(e)
    else:
        raise AssertionError("a codec with schedule 0x0D decoded a 0x1F "
                             "stream")
    return out


# ---------------------------------------------------------------------------
# multidevice: ranks over torch.distributed (parallel/)
# ---------------------------------------------------------------------------

# chip_smoke.py's ranks share one card, and NCCL refuses two ranks on one
# GPU: the phase runs on gloo, whose collectives go through host copies.
MULTI_BACKEND = "gloo"
MULTI_WORLD = 2
# The K of the round-robin's pinned encodes: the policy's own choice for
# most 1080p waves (PERF.md §6), so the pin moves the bytes least.
MULTI_PIN_K = 1024
# The most the phase's ranks may take, all four parts.
MULTI_TIMEOUT_S = 600.0
# The train step's layouts over the ranks, as (batch, accum) of
# train_small_inputs and the mesh's 'spatial' size: over 'data' = 2 a
# whole microbatch a rank (accum 2), and one microbatch of 2 split a
# sample a rank (accum 1); over 'spatial' = 2 each microbatch's rows
# split into two bands.
MULTI_TRAIN_CASES = {"microbatch_per_rank": (2, 2, 1),
                     "split_microbatch": (2, 1, 1),
                     "spatial": (2, 2, 2)}
# The spatial part's mesh: every rank on 'spatial' (bands of 544 rows of
# a 1088-row frame, 34 at the y level).
MULTI_SPATIAL = 2


def recon_md5(decoded, indices) -> Dict[int, str]:
    """md5 of each frame's y, u and v planes, by frame index."""
    return {i: hashlib.md5(b"".join(np.ascontiguousarray(decoded[i][c])
                                    .tobytes() for c in ("y", "u", "v"))
                           ).hexdigest() for i in indices}


def stream_ks(bitstream: bytes) -> List[int]:
    """The K of each frame's fused chunk of a device-backend stream, in
    stream order."""
    if bs.unpack_video(bitstream)[0].backend != bs.BACKEND_DEVICE:
        raise ValueError("a host-backend stream has no fused chunks")
    return [vrans.parse_chunk_v2(c["codecnet_z"])[2]
            for c in frame_chunks(bitstream)]


def _barrier_sync(device: torch.device) -> None:
    sync(device)
    if dist.is_initialized():
        dist.barrier()


def rank_round_robin(device, ckpt: str, frames, gop: int, wave_batch: int,
                     pin_k: int = 0) -> Dict:
    """On a rank: the GOP round-robin encode (encode_video_multihost) of
    the RA clip with a fresh codec, under AIVC_VRANS_K=pin_k where pin_k
    is set; the muxed stream, the md5 of this rank's reconstructions and
    the seconds from a barrier to the stream on this rank."""
    from aivc_tpu_torch.parallel.multihost import encode_video_multihost

    cfg, model = load_checkpoint(ckpt, device=device)
    h, w = frames[0]["y"].shape
    codec = FrameCodec(cfg, model, h, w, device=device)
    decoded = {}
    _barrier_sync(device)
    t0 = time.time()
    with switched(**({"AIVC_VRANS_K": str(pin_k)} if pin_k else {})):
        stream = encode_video_multihost(codec, frames, ra_coding(gop),
                                        wave_batch=wave_batch,
                                        decoded=decoded)
    sync(device)
    return {"bitstream": stream, "seconds": time.time() - t0,
            "md5": recon_md5(decoded, sorted(decoded))}


def rank_mesh_codec(device, ckpt: str, frames, gop: int,
                    wave_batch: int, spatial: int = 1) -> Dict:
    """On a rank: the clip encoded and decoded by a FrameCodec over the
    ('data', 'spatial') mesh of every rank with ``spatial`` bands; the
    decode must equal the encoder's reconstructions bit for bit.  The
    stream, the md5 of the reconstructions, PSNR, seconds, the
    collectives' seconds (all of them; under 'spatial' the halo
    exchanges' and the row gathers' too: the encode's and the decode's
    ``mesh.gather``, ``halo.exchange`` and ``halo.gather`` spans),
    K1-K3's launches, the peak device memory and, on a card's band past
    the first, the inputs of one K3 band launch of the encode."""
    from aivc_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(spatial=spatial)
    cfg, model = load_checkpoint(ckpt, device=device)
    h, w = frames[0]["y"].shape
    codec = FrameCodec(cfg, model, h, w, device=device, mesh=mesh)
    _barrier_sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    launches0 = dict(kernels.LAUNCHES)
    watch = (WarpWatch(band=True)
             if codec.band is not None and device.type == "cuda" else None)
    with tracing.recording() as rec:
        t0 = time.time()
        try:
            enc = encode_video(codec, frames, ra_coding(gop),
                               wave_batch=wave_batch)
        finally:
            if watch is not None:
                watch.close()
        sync(device)
        t1 = time.time()
        dec = decode_video(codec, enc.bitstream)
        md5 = recon_md5(dec, range(len(frames)))
        sync(device)
        t2 = time.time()
    if md5 != recon_md5(enc.decoded_frames, range(len(frames))):
        raise AssertionError("the mesh codec's decode differs from its "
                             "encoder's reconstructions")
    q = evaluate_frames(frames, dec, device=device)
    return {"bitstream": enc.bitstream, "md5": md5, "psnr": q["psnr"],
            "encode_s": t1 - t0, "decode_s": t2 - t1,
            "comm_s": rec.seconds("mesh.gather"),
            "halo_s": rec.seconds("halo.exchange"),
            "gather_s": rec.seconds("halo.gather"),
            "launches": {k: v - launches0[k]
                         for k, v in kernels.LAUNCHES.items()},
            "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                         if device.type == "cuda" else None),
            # One K3 launch on a band below the first (row0 > 0), its
            # inputs on the host: the largest batch of the encode's.
            "band_warp": (None if watch is None or watch.inputs is None
                          else tuple(t.cpu() if torch.is_tensor(t) else t
                                     for t in watch.inputs))}


def train_step_on(ckpt: str, device: torch.device, frames: torch.Tensor,
                  accum: int, gop_name: str = "1_GOP_2", idx_rate: int = 3,
                  lr: float = 4e-6, mesh=None) -> Dict:
    """One train-small step of ``ckpt`` with both nets in float32 (over
    ``mesh`` where given): logs, gradients on the host and the sha256 of
    the updated parameters' bytes."""
    from aivc_tpu_torch.config import ModelConfig
    from aivc_tpu_torch.utils.checkpoint import model_from_params, read_params

    cfg = f32_config(ModelConfig.from_json(
        (Path(ckpt) / "config.json").read_text()))
    model = model_from_params(cfg, read_params(ckpt), device)
    with plain_float_warp():
        logs, grads = _train_small_step(
            model, cfg, generate_gop_struct(gop_name), frames, device,
            accum, idx_rate, lr, mesh=mesh)
    digest = hashlib.sha256()
    for p in model.parameters():
        digest.update(p.detach().cpu().numpy().tobytes())
    return {"logs": logs, "grads": grads, "params_sha256": digest.hexdigest()}


def rank_train_step(device, ckpt: str, frames: torch.Tensor, accum: int,
                    spatial: int = 1, **kw) -> Dict:
    """On a rank: train_step_on over the ('data', 'spatial') mesh of
    every rank with ``spatial`` bands."""
    from aivc_tpu_torch.parallel.mesh import make_mesh

    return train_step_on(ckpt, device, frames, accum,
                         mesh=make_mesh(spatial=spatial), **kw)


def rank_multidevice(device, ckpt: str, rr: Dict, mesh: Dict,
                     train: Dict[str, Dict]) -> Dict:
    """chip_smoke.py's multidevice phase on one rank: the round-robin
    encode pinned (which warms the shapes) then free, the mesh codec over
    'data', the data-parallel train step of each case of ``train``;
    K1-K3's launches over those coding parts; then the mesh codec over
    'spatial' (its own launches, seconds and peak memory)."""
    kernels.reset_launches()
    out = {"rr_pinned": rank_round_robin(device, ckpt, **rr,
                                         pin_k=MULTI_PIN_K),
           "rr_free": rank_round_robin(device, ckpt, **rr)}
    out["mesh"] = rank_mesh_codec(device, ckpt, **mesh)
    out["launches"] = dict(kernels.LAUNCHES)
    out["train"] = {name: rank_train_step(device, ckpt, **kw)
                    for name, kw in train.items()}
    out["spatial"] = rank_mesh_codec(device, ckpt, **mesh,
                                     spatial=MULTI_SPATIAL)
    return out


def _same(results: List[Dict], key: str, what: str):
    first = results[0][key]
    if any(r[key] != first for r in results[1:]):
        raise AssertionError(f"{what}: the ranks disagree on {key}")
    return first


def _decode_check(codec: FrameCodec, stream: bytes, md5: Dict[int, str],
                  what: str) -> None:
    dec = decode_video(codec, stream)
    if recon_md5(dec, sorted(md5)) != md5:
        raise AssertionError(f"{what}: the decode differs from the ranks' "
                             f"encoder reconstructions")


def multidevice_runs(ckpt: str, device: torch.device, workdir,
                     rr_frames, mesh_frames, mesh_stream: bytes,
                     rr_gop: int = 4, rr_wave: int = 4, mesh_gop: int = 8,
                     mesh_wave: int = 8, train_size: int = 128,
                     train_idx_rate: int = 3) -> Dict:
    """chip_smoke.py's multidevice phase: MULTI_WORLD ranks on
    MULTI_BACKEND (parallel/launch.py) against one process here.

    (a) GOP round-robin of ``rr_frames`` (RA ``rr_gop``): both ranks
        return the same stream; pinned (AIVC_VRANS_K=MULTI_PIN_K) it
        equals this process's pinned encode byte for byte; free, its
        difference from this process's free encode (bytes, K per frame)
        is returned; both decode here bit-exactly against the ranks'
        reconstructions.  Encode seconds warm: one process against the
        ranks' free encode.
    (b) the mesh codec on ``mesh_frames``: both ranks return the same
        stream, which their own decode reproduced bit for bit; its bytes
        and PSNR against ``mesh_stream`` (one process's stream of the
        clip), and whether this process decodes it bit-exactly.
    (c) train-small in float32 over the ranks against one process, in
        each layout of MULTI_TRAIN_CASES (whole microbatches a rank; one
        microbatch split over the ranks; the rows split over
        'spatial'): TRAIN_SMALL_F32_TOL on the logs, each gradient leaf
        within TRAIN_SMALL_F32_LEAF_MAX_REL_L2, and the updated
        parameters equal on the ranks.
    (d) the mesh codec over 'spatial' = MULTI_SPATIAL on ``mesh_frames``,
        checked and reported as (b), with each rank's K1-K3 launches,
        halo-exchange and row-gather seconds and peak memory; on the card
        the K3 band launch a rank captured (row0 > 0) is held bit for bit
        against the plain warp and timed here (``band_warp``).
    Raises on any failed check; the ranks' K1-K3 launches are returned
    and, on the card, each must be nonzero, in (b) and in (d)."""
    cfg, model = load_checkpoint(ckpt, device=device)
    h, w = rr_frames[0]["y"].shape
    coding = ra_coding(rr_gop)
    one = {}
    for name, pin in (("pinned", MULTI_PIN_K), ("free", 0)):
        codec = FrameCodec(cfg, model, h, w, device=device)
        sync(device)
        t0 = time.time()
        with switched(**({"AIVC_VRANS_K": str(pin)} if pin else {})):
            enc = encode_video(codec, rr_frames, coding, wave_batch=rr_wave)
        sync(device)
        one[name] = {"bitstream": enc.bitstream, "seconds": time.time() - t0}
    train_kw, train_one, by_shape = {}, {}, {}
    t0 = time.time()
    for name, (batch, accum, spatial) in MULTI_TRAIN_CASES.items():
        kw = {"frames": train_small_inputs(train_size, batch, accum),
              "accum": accum, "idx_rate": train_idx_rate}
        if (batch, accum) not in by_shape:
            by_shape[batch, accum] = train_step_on(ckpt, device, **kw)
        train_one[name] = by_shape[batch, accum]
        train_kw[name] = dict(kw, spatial=spatial)
    train_one_s = time.time() - t0

    t0 = time.time()
    ranks = run_ranks(
        "aivc_tpu_torch.smoke:rank_multidevice", MULTI_WORLD, MULTI_BACKEND,
        workdir, timeout_s=MULTI_TIMEOUT_S,
        device=None if device.type == "cuda" else "cpu",
        kwargs={"ckpt": ckpt,
                "rr": {"frames": rr_frames, "gop": rr_gop,
                       "wave_batch": rr_wave},
                "mesh": {"frames": mesh_frames, "gop": mesh_gop,
                         "wave_batch": mesh_wave},
                "train": train_kw})
    ranks_s = time.time() - t0
    out = {"ranks_s": ranks_s, "one": one, "train_one_s": train_one_s,
           "launches": [r["launches"] for r in ranks]}

    # (a)
    codec = FrameCodec(cfg, model, h, w, device=device)
    rr = {}
    for name in ("pinned", "free"):
        res = [r[f"rr_{name}"] for r in ranks]
        stream = _same(res, "bitstream", f"round-robin ({name})")
        md5 = {}
        for r in res:
            md5.update(r["md5"])
        if sorted(md5) != list(range(len(rr_frames))):
            raise AssertionError(f"round-robin ({name}): reconstructions of "
                                 f"frames {sorted(md5)}")
        _decode_check(codec, stream, md5, f"round-robin ({name})")
        ref = one[name]["bitstream"]
        rr[name] = {"bytes": len(stream), "one_bytes": len(ref),
                    "equal": stream == ref, "ks": stream_ks(stream),
                    "one_ks": stream_ks(ref),
                    "seconds": max(r["seconds"] for r in res),
                    "one_seconds": one[name]["seconds"]}
    if not rr["pinned"]["equal"]:
        raise AssertionError(
            f"round-robin with AIVC_VRANS_K={MULTI_PIN_K}: "
            f"{rr['pinned']['bytes']} B against one process's "
            f"{rr['pinned']['one_bytes']} B")
    out["rr"] = rr

    # (b)
    out["mesh"] = _mesh_codec_report([r["mesh"] for r in ranks],
                                     "mesh codec", cfg, model, mesh_frames,
                                     mesh_stream, device)

    # (c)
    out["train"] = {}
    for name in MULTI_TRAIN_CASES:
        what = f"multidevice train step ({name})"
        res = [r["train"][name] for r in ranks]
        if len({r["params_sha256"] for r in res}) != 1:
            raise AssertionError(f"{what}: the ranks' parameters differ "
                                 f"after the update")
        one = train_one[name]
        diffs = compare_logs(res[0]["logs"], one["logs"],
                             TRAIN_SMALL_F32_TOL, what)
        rows = leaf_distances(res[0]["grads"], one["grads"])
        worst = max(rows, key=lambda r: r[1])
        if not worst[1] <= TRAIN_SMALL_F32_LEAF_MAX_REL_L2:
            raise AssertionError(f"{what}: gradient leaf {worst[0]} "
                                 f"relative L2 {worst[1]} (limit "
                                 f"{TRAIN_SMALL_F32_LEAF_MAX_REL_L2})")
        out["train"][name] = {"diffs": diffs, "worst_leaf_rel_l2": worst,
                              "n_leaves": len(rows),
                              "ranks": res[0]["logs"], "one": one["logs"]}
    # (d)
    res = [r["spatial"] for r in ranks]
    sp = _mesh_codec_report(res, "spatial mesh codec", cfg, model,
                            mesh_frames, mesh_stream, device)
    for key in ("halo_s", "gather_s", "launches", "peak_gib"):
        sp[key] = [r[key] for r in res]
    band = [r["band_warp"] for r in res if r["band_warp"] is not None]
    sp["band_warp"] = None
    if device.type == "cuda":
        if not band:
            raise AssertionError("no K3 launch on a band past the first")
        sp["band_warp"] = check_warp_on(tuple(
            t.to(device) if torch.is_tensor(t) else t for t in band[0]))
    out["spatial"] = sp
    if device.type == "cuda":
        for part, launches in (("round-robin and mesh codec",
                                out["launches"]),
                               ("spatial mesh codec", sp["launches"])):
            for i, la in enumerate(launches):
                missing = [k for k in ("rans_encode", "rans_decode",
                                       "warp_packed") if la[k] == 0]
                if missing:
                    raise AssertionError(f"{part}: rank {i} never launched "
                                         f"{missing}")
    return out


def _mesh_codec_report(res: List[Dict], what: str, cfg, model, frames,
                       one_stream: bytes, device: torch.device) -> Dict:
    """The ranks' results of rank_mesh_codec: the same stream and
    reconstructions on every rank; its bytes and PSNR against one
    process's stream ``one_stream`` of ``frames``, and in how many frames
    one process's decode of it differs from the ranks'."""
    stream = _same(res, "bitstream", what)
    md5 = _same(res, "md5", what)
    h, w = frames[0]["y"].shape
    single = FrameCodec(cfg, model, h, w, device=device)
    dec = decode_video(single, stream)
    q_one = evaluate_frames(frames, decode_video(single, one_stream),
                            device=device)
    return {
        "bytes": len(stream), "one_bytes": len(one_stream),
        "equal": stream == one_stream, "psnr": res[0]["psnr"],
        "one_psnr": q_one["psnr"],
        "one_decode_differs": sum(
            v != md5[i] for i, v in recon_md5(dec, sorted(md5)).items()),
        "encode_s": [r["encode_s"] for r in res],
        "decode_s": [r["decode_s"] for r in res],
        "comm_s": [r["comm_s"] for r in res]}


def lookahead_runs(ckpt: str, frames, device: torch.device,
                   depths=(0, 4), gop: int = 8, wave_batch: int = 8
                   ) -> Dict:
    """The clip encoded warm by a fresh codec at each
    AIVC_PIPELINE_LOOKAHEAD of ``depths`` in turns (depths, then depths
    reversed): the bytes must be equal; each depth's encode fps, both
    turns.  One warm-up encode first, at lookahead 0."""
    cfg, model = load_checkpoint(ckpt, device=device)
    h, w = frames[0]["y"].shape
    streams, fps = {}, {d: [] for d in depths}
    order = [0] + list(depths) + list(reversed(depths))
    for i, depth in enumerate(order):
        codec = FrameCodec(cfg, model, h, w, device=device)
        sync(device)
        t0 = time.time()
        with switched(AIVC_PIPELINE_LOOKAHEAD=str(depth)):
            enc = encode_video(codec, frames, ra_coding(gop),
                               wave_batch=wave_batch)
        sync(device)
        if i:
            fps[depth].append(len(frames) / (time.time() - t0))
        streams.setdefault(depth, enc.bitstream)
        if enc.bitstream != streams[0]:
            raise AssertionError(f"lookahead {depth}: {len(enc.bitstream)} "
                                 f"B against lookahead 0's "
                                 f"{len(streams[0])} B")
    return {"bytes": len(streams[0]), "fps": fps}


# ---------------------------------------------------------------------------
# scripts phase: the operational tools (aivc_tpu_torch/scripts/)
# ---------------------------------------------------------------------------

# rd_sweep's rates on the clip (a fractional one among them) and its
# worker count; eval_ckpt's size, families and rates (four: BD metrics
# need four points a curve).
SWEEP_RATES = "0,2.5,6"
SWEEP_PROCS = 3
EVAL_H, EVAL_W, EVAL_CLIPS, EVAL_RATES = 240, 416, 3, "0,2,4,6"
SCRIPTS_TIMEOUT_S = 900


def _quiet_main(main, argv: List[str]) -> str:
    """A script's main(argv) in this process: its standard output;
    raises if it exits nonzero."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main([str(a) for a in argv])
    if rc != 0:
        raise AssertionError(f"{main.__module__} {argv} exited {rc}:\n"
                             f"{buf.getvalue()}")
    return buf.getvalue()


def _no_fps(rows: List[Dict]) -> List[Dict]:
    return [{k: v for k, v in r.items() if k != "enc_fps"} for r in rows]


def scripts_runs(ckpt: str, frames, device: torch.device, tmp, root,
                 cli_stream: bytes, gop: int = 8, wave_batch: int = 8,
                 pin_k: int = MULTI_PIN_K,
                 eval_size=(EVAL_H, EVAL_W)) -> Dict:
    """The scripts phase, each tool through its own entry points:

      sweep     rd_sweep of the clip (written to ``tmp`` as a YUV) at
                SWEEP_RATES with --rate_audit, RA GOP ``gop``: K free in
                this process (every stream decoded here bit-exactly
                against its encoder's reconstruction; the K of each
                frame) and over SWEEP_PROCS workers (each row's bytes
                against the sequential row's); with AIVC_VRANS_K=
                ``pin_k`` in this process (decoded the same way) and over
                the workers, whose rows must equal the in-process rows
      eval      eval_ckpt on EVAL_CLIPS held-out families at
                ``eval_size`` (EVAL_H x EVAL_W), RA, of the checkpoint
                and of the low-rate specialist make_lowrate writes from
                it under ``tmp``
                (each decode bit-exact, checked by eval_ckpt), and
                bd_from_eval of the two
      latents   latent_range at ``eval_size`` (report only)
      motion    probe_motion at ``eval_size`` (report only)
      aivc      scripts.aivc's three processes on the clip with the CLI
                phase's RA flags: the stream must be ``cli_stream`` byte
                for byte, and the decode stage's frames the ones this
                process decodes from it

    The kernels' launches of each part run in this process are counted
    (set to 0 just before, read just after); the workers' come from
    their wall lines; the aivc stages' happen in their own processes."""
    from aivc_tpu_torch.scripts import (
        bd_from_eval,
        eval_ckpt,
        latent_range,
        make_lowrate,
        probe_motion,
        rd_sweep,
    )

    tmp = Path(tmp)
    clip = write_clip(frames, tmp)
    h, w = frames[0]["y"].shape
    cpu = ["--cpu"] if device.type == "cpu" else []
    cfg, model = load_checkpoint(ckpt, device=device)
    dec_codec = FrameCodec(cfg, model, h, w, device=device)
    out: Dict = {}

    def sweep_args(*extra):
        return rd_sweep.build_parser().parse_args([str(a) for a in [
            *cpu, "--input", clip, "--ckpt", ckpt, "--frames", len(frames),
            "--coding_config", "RA", "--gop_size", gop, "--intra_period",
            gop, "--rates", SWEEP_RATES, "--rate_audit", *extra]])

    def decode_all(results) -> Dict:
        kernels.reset_launches()
        t0 = time.time()
        for res in results:
            dec = decode_video(dec_codec, res.bitstream)
            for i in range(len(frames)):
                for c in ("y", "u", "v"):
                    if not np.array_equal(dec[i][c],
                                          res.decoded_frames[i][c]):
                        raise AssertionError(
                            f"sweep stream of {len(res.bitstream)} B: "
                            f"decoded frame {i} plane {c} differs from "
                            "the encoder's reconstruction")
        sync(device)
        return {"streams": len(results), "seconds": time.time() - t0,
                "launches": dict(kernels.LAUNCHES)}

    def in_process() -> Dict:
        t0 = time.time()
        rows, wall, results = rd_sweep.sweep(sweep_args(), device,
                                             emit=lambda line: None,
                                             keep=True)
        return {"rows": rows, "wall": wall, "seconds": time.time() - t0,
                "ks": [stream_ks(r.bitstream) for r in results],
                "decode": decode_all(results)}

    def workers() -> Dict:
        t0 = time.time()
        rows, wall = rd_sweep.fan_out(sweep_args("--procs", SWEEP_PROCS),
                                      device, emit=lambda line: None)
        return {"rows": rows, "wall": wall, "seconds": time.time() - t0}

    sweeps = {"free": in_process(), "free_procs": workers()}
    with switched(AIVC_VRANS_K=str(pin_k)):
        sweeps["pinned"] = in_process()
        sweeps["pinned_procs"] = workers()
    if _no_fps(sweeps["pinned_procs"]["rows"]) != \
            _no_fps(sweeps["pinned"]["rows"]):
        raise AssertionError(
            f"AIVC_VRANS_K={pin_k}: the {SWEEP_PROCS} workers' rows "
            f"{sweeps['pinned_procs']['rows']} differ from the in-process "
            f"rows {sweeps['pinned']['rows']}")
    sweeps["free_procs"]["bytes_minus_sequential"] = [
        a["bytes"] - b["bytes"] for a, b in zip(
            sweeps["free_procs"]["rows"], sweeps["free"]["rows"])]
    out["sweep"] = sweeps

    eh, ew = eval_size
    ev_args = eval_ckpt.build_parser().parse_args([str(a) for a in [
        *cpu, "--h", eh, "--w", ew, "--clips", EVAL_CLIPS,
        "--rates", EVAL_RATES]])
    rates = [float(r) for r in EVAL_RATES.split(",")]
    clips, names = eval_ckpt.heldout_clips(EVAL_CLIPS, ev_args.frames,
                                           eh, ew)
    lowrate = tmp / "lowrate"
    surgery = _quiet_main(make_lowrate.main, ["--src", ckpt,
                                              "--out", lowrate])
    evals = {"families": names, "make_lowrate": surgery.strip()}
    for name, path in (("flagship", ckpt), ("lowrate", str(lowrate))):
        lines: List[str] = []
        kernels.reset_launches()
        t0 = time.time()
        summary, mean = eval_ckpt.evaluate(path, clips, names, rates,
                                           ev_args, device,
                                           emit=lines.append)
        sync(device)
        evals[name] = {"summary": summary, "mean": mean,
                       "seconds": time.time() - t0,
                       "launches": dict(kernels.LAUNCHES)}
        (tmp / f"{name}.jsonl").write_text("\n".join(lines) + "\n")
    evals["bd"] = bd_from_eval.deltas(
        bd_from_eval.load_rows(str(tmp / "flagship.jsonl")),
        bd_from_eval.load_rows(str(tmp / "lowrate.jsonl")))
    out["eval"] = evals

    probe = [*cpu, "--ckpt", ckpt, "--h", eh, "--w", ew]
    for name, main in (("latents", latent_range.main),
                       ("motion", probe_motion.main)):
        kernels.reset_launches()
        t0 = time.time()
        text = _quiet_main(main, probe)
        sync(device)
        out[name] = {"lines": text.strip().splitlines(),
                     "seconds": time.time() - t0,
                     "launches": dict(kernels.LAUNCHES)}

    argv = [*cpu, "-i", str(clip), "-o", str(tmp / "aivc.yuv"),
            "--bitstream_out", str(tmp / "aivc.bin"), "--coding_config",
            "RA", "--gop_size", str(gop), "--intra_period", str(gop),
            "--model", ckpt, "--wave_batch", str(wave_batch), "--rate_audit"]
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "aivc_tpu_torch.scripts.aivc", *argv],
        capture_output=True, text=True, cwd=str(root),
        timeout=SCRIPTS_TIMEOUT_S)
    seconds = time.time() - t0
    if proc.returncode != 0:
        raise AssertionError(f"scripts.aivc exited {proc.returncode}:\n"
                             f"{proc.stdout}\n{proc.stderr}")
    stream = (tmp / "aivc.bin").read_bytes()
    if stream != cli_stream:
        raise AssertionError(f"scripts.aivc wrote {len(stream)} B, the "
                             f"CLI's RA stream is {len(cli_stream)} B")
    kernels.reset_launches()
    dec = decode_video(dec_codec, stream)
    reader = YuvReader(tmp / "aivc.yuv", w, h)
    if reader.n_frames != len(frames) or any(
            not np.array_equal(reader.read_frame(i)[c], dec[i][c])
            for i in range(len(frames)) for c in ("y", "u", "v")):
        raise AssertionError("scripts.aivc's decode stage wrote other "
                             "frames than this process decodes")
    out["aivc"] = {"results": parse_results(proc.stdout),
                   "stages": [ln for ln in proc.stdout.splitlines()
                              if ln.startswith("[aivc]")],
                   "seconds": seconds, "bytes": len(stream),
                   "decode_launches": dict(kernels.LAUNCHES)}
    return out
