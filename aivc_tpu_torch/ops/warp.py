"""Bilinear motion-compensation warps, NCHW.

The coding path (counterpart of aivc_tpu/ops/warp.py:pack_yuv_u32 and
warp_packed, warp.py:96-169, and of the bounded-flow kernel that
flow-bounded models take on the TPU, ops/warp_pallas.py:
warp_bounded_pallas): ``warp_packed`` is the plain PyTorch version;
``warp_packed_cuda`` wraps kernel K3 (csrc/kernels.cu:warp_packed_kernel),
which is bit-identical to it on the card.  ``mc_warp`` takes the plain
version for a tensor on the host and the kernel for a tensor on the card.
Each takes a row window ``row0`` for a band of a frame split over a
mesh's 'spatial' axis: the whole reference, the band's flows, the band's
output rows; so does the float ``warp`` (plain only, for a band).

The RD forward path (counterpart of warp.py:32-94,221-234): the float
``warp`` and ``motion_compensation``.  With ``AIVC_WARP=pallas`` in the
environment at import, ``warp`` takes the vertically clamped warp of
ops/warp_pallas.py:warp_pallas where JAX's shape rule allows it
(W % 128 == 0 and H % min(H, 256) == 0, warp.py:51):
``warp_vclamped`` on the host, kernel K5
(csrc/kernels.cu:warp_vclamped_kernel, bit-identical) on the card.
"""

from __future__ import annotations

import os

import torch

from aivc_tpu_torch import kernels
from aivc_tpu_torch.ops import ties

# AIVC_WARP=pallas routes the float warp through the vertically clamped
# warp (K5 on the card) where shapes allow, as aivc_tpu/ops/warp.py:29.
_USE_PALLAS = os.environ.get("AIVC_WARP", "") == "pallas"
# ops/warp_pallas.py: vertical reach of the clamped warp and lane width.
V_RADIUS = 16
LANE = 128

# Largest flow bound the bounded-warp engine serves
# (aivc_tpu/ops/warp_pallas.py:FB_MAX).
FB_MAX = 38
_INV255 = 1.0 / 255.0


def pack_yuv_u32(x: torch.Tensor) -> torch.Tensor:
    """256-level [B, 3, H, W] frame in [0, 1] -> [B, H, W] int32 holding
    the bytes y | u << 8 | v << 16."""
    q = torch.round(x * 255.0).to(torch.int32)
    return q[:, 0] | (q[:, 1] << 8) | (q[:, 2] << 16)


def warp_packed(packed: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                row0: int = 0) -> torch.Tensor:
    """Plain version: backward-warp ``packed`` [B, H, W] by the flow planes
    (u horizontal, v vertical) [B, h, W] of the output rows row0 ..
    row0 + h - 1 (all rows by default: h = H, row0 = 0), border clamp,
    bilinear: the source row of output row y is (row0 + y) + v, clamped
    to the whole frame.  Returns f32 [B, 3, h, W] in [0, 1].  Every float
    op is a separate eager op, so nothing is contracted into an FMA."""
    B, H, W = packed.shape
    h = u.shape[1]
    dev = packed.device
    f32 = torch.float32
    xx = torch.arange(W, dtype=f32, device=dev).view(1, 1, W)
    yy = torch.arange(row0, row0 + h, dtype=f32, device=dev).view(1, h, 1)
    sx = torch.clamp(xx + u.to(f32), 0.0, float(W - 1))
    sy = torch.clamp(yy + v.to(f32), 0.0, float(H - 1))
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    wx = (sx - x0).unsqueeze(1)
    wy = (sy - y0).unsqueeze(1)
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    x1i = torch.clamp_max(x0i + 1, W - 1)
    y1i = torch.clamp_max(y0i + 1, H - 1)
    flat = packed.reshape(B, H * W)

    def corner(yi, xi):
        return torch.gather(flat, 1, (yi * W + xi).reshape(B, h * W)
                            ).reshape(B, 1, h, W)

    shifts = torch.tensor([0, 8, 16], dtype=torch.int32,
                          device=dev).view(1, 3, 1, 1)
    inv = torch.tensor(_INV255, dtype=f32, device=dev)

    def unpack(c):
        return ((c >> shifts) & 0xFF).to(f32) * inv

    v00 = unpack(corner(y0i, x0i))
    v01 = unpack(corner(y0i, x1i))
    v10 = unpack(corner(y1i, x0i))
    v11 = unpack(corner(y1i, x1i))
    top = v00 + (v01 - v00) * wx
    bot = v10 + (v11 - v10) * wx
    return top + (bot - top) * wy


def warp_packed_cuda(packed: torch.Tensor, u: torch.Tensor,
                     v: torch.Tensor, row0: int = 0) -> torch.Tensor:
    """Kernel K3 on the card: same contract as ``warp_packed``."""
    B, H, W = packed.shape
    h = u.shape[1]
    if not 0 <= row0 <= H - h:
        raise ValueError(f"rows {row0} .. {row0 + h - 1} are not rows of a "
                         f"frame of {H}")
    kernels.require(packed, "packed", torch.int32, (B, H, W))
    kernels.require(u, "u", torch.float32, (B, h, W))
    kernels.require(v, "v", torch.float32, (B, h, W))
    out = torch.empty((B, 3, h, W), dtype=torch.float32,
                      device=packed.device)
    lib = kernels.lib()
    rc = lib.aivc_warp_packed(packed.data_ptr(), u.data_ptr(), v.data_ptr(),
                              B, H, W, row0, h, out.data_ptr(),
                              kernels.stream_ptr())
    kernels.check("warp_packed", rc)
    kernels.LAUNCHES["warp_packed"] += 1
    return out


def warp_engine(flow_bound: float) -> str:
    """Engine choice of aivc_tpu/pipeline/codec.py:282-298 without the TPU
    probe: a flow-bounded model with ceil(bound) <= FB_MAX takes the
    bounded engine (kernel K3 on the card), any other the packed one."""
    fb = int(-(-float(flow_bound or 0.0) // 1))
    return "bounded" if 0 < fb <= FB_MAX else "packed"


def mc_warp(packed: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
            engine: str, row0: int = 0) -> torch.Tensor:
    """Motion-compensation warp of the output rows from ``row0`` (a band
    of a frame split over 'spatial': the whole reference, the band's
    flows).  On the host both engines run the plain version; on the card
    the bounded engine launches K3 (no fallback) and the packed engine
    runs the plain version op by op."""
    if packed.device.type == "cuda" and engine == "bounded":
        return warp_packed_cuda(packed.contiguous(), u.contiguous(),
                                v.contiguous(), row0)
    return warp_packed(packed, u, v, row0)


# ---------------------------------------------------------------------------
# Float warp of the RD forward path
# ---------------------------------------------------------------------------

def _sample_grid(flow: torch.Tensor, vclamp: bool, H: int = None,
                 row0: int = 0):
    """Sample coordinates of a backward warp by flow [B, 2, h, W] (plane 0
    horizontal, 1 vertical) of the output rows row0 .. row0 + h - 1 of a
    frame of H rows (default: h, row0 0), border-clamped; with
    ``vclamp`` the vertical flow is first clamped to +-(V_RADIUS - 1)
    rows."""
    _, _, h, W = flow.shape
    H = h if H is None else H
    dev = flow.device
    f32 = torch.float32
    xx = torch.arange(W, dtype=f32, device=dev).view(1, 1, W)
    yy = torch.arange(row0, row0 + h, dtype=f32, device=dev).view(1, h, 1)
    fy = flow[:, 1].to(f32)
    if vclamp:
        fy = torch.clamp(fy, -V_RADIUS + 1, V_RADIUS - 1)
    sx = ties.clip(xx + flow[:, 0].to(f32), 0.0, float(W - 1))
    sy = ties.clip(yy + fy, 0.0, float(H - 1))
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    # A NaN flow gives NaN weights (so NaN samples, as JAX's gather does)
    # and an undefined integer: keep the index inside the frame, where a
    # gather cannot fault.  Finite flows are already inside.
    x0i = torch.clamp(x0.to(torch.int64), 0, W - 1)
    y0i = torch.clamp(y0.to(torch.int64), 0, H - 1)
    return (sx - x0, sy - y0, x0i, torch.clamp_max(x0i + 1, W - 1), y0i,
            torch.clamp_max(y0i + 1, H - 1))


def _corners(x: torch.Tensor, yi, x0i, x1i):
    """x [B, C, H, W] at rows yi and columns x0i / x1i ([B, h, W])."""
    B, C, H, W = x.shape
    h = yi.shape[1]
    flat = x.reshape(B, C, H * W)

    def at(xi):
        idx = (yi * W + xi).reshape(B, 1, h * W).expand(B, C, h * W)
        return torch.gather(flat, 2, idx).reshape(B, C, h, W)

    return at(x0i), at(x1i)


def warp_plain(x: torch.Tensor, flow: torch.Tensor,
               row0: int = 0) -> torch.Tensor:
    """The XLA warp of aivc_tpu/ops/warp.py:53-94 on x [B, C, H, W]:
    border-clamped bilinear, ``top + (bot - top) * wy``.  ``flow``
    [B, 2, h, W] moves the output rows row0 .. row0 + h - 1 (all of them
    by default); the result is [B, C, h, W].  Autograd differentiates it
    with respect to x and the flow as ``jax.grad`` does JAX's (the
    coordinate clips split a tie as ``jnp.clip``); the training forward
    takes it."""
    wx, wy, x0i, x1i, y0i, y1i = _sample_grid(flow, vclamp=False,
                                              H=x.shape[2], row0=row0)
    wx = wx.to(x.dtype).unsqueeze(1)
    wy = wy.to(x.dtype).unsqueeze(1)
    v00, v01 = _corners(x, y0i, x0i, x1i)
    v10, v11 = _corners(x, y1i, x0i, x1i)
    top = v00 + (v01 - v00) * wx
    bot = v10 + (v11 - v10) * wx
    return top + (bot - top) * wy


def _pick_row_block(h: int):
    """Largest divisor of h in [8, 256] (warp_pallas.py:_pick_row_block)."""
    for hb in range(min(h, 256), 7, -1):
        if h % hb == 0:
            return hb
    return None


def _check_vclamped(x: torch.Tensor, flow: torch.Tensor) -> None:
    B, C, H, W = x.shape
    if tuple(flow.shape) != (B, 2, H, W):
        raise ValueError(f"flow must have shape {(B, 2, H, W)}, got "
                         f"{tuple(flow.shape)}")
    if W % LANE != 0:
        raise ValueError(f"W={W} must be a multiple of {LANE}")
    if _pick_row_block(H) is None:
        raise ValueError(f"H={H} has no row-block divisor in [8, 256]")


def warp_vclamped(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel K5 (ops/warp_pallas.py:warp_pallas and its
    body _warp_plane_kernel :70-109) on x [B, C, H, W], flow [B, 2, H, W].

    Horizontal displacement unrestricted and border-clamped; vertical flow
    clamped to +-(V_RADIUS - 1) rows, then to the frame; edge rows stand
    in for rows outside it.  The Pallas kernel's select-accumulate over
    row offsets adds only exact zeros besides its two row terms, so it
    computes (1 - wy) * top + wy * bot, top and bot being
    ``h0 + (h1 - h0) * wx`` on the two rows; every float op here is a
    separate eager op, so nothing is contracted into an FMA."""
    _check_vclamped(x, flow)
    wx, wy, x0i, x1i, y0i, y1i = _sample_grid(flow, vclamp=True)
    wx = wx.unsqueeze(1)
    wy = wy.unsqueeze(1)
    h0, h1 = _corners(x, y0i, x0i, x1i)
    top = h0 + (h1 - h0) * wx
    h0, h1 = _corners(x, y1i, x0i, x1i)
    bot = h0 + (h1 - h0) * wx
    return (1.0 - wy) * top + wy * bot


def warp_vclamped_cuda(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Kernel K5 on the card: same contract as ``warp_vclamped`` for f32
    x and flow.  Forward only: JAX cannot differentiate warp_pallas
    either, so an input that requires grad is refused."""
    _check_vclamped(x, flow)
    B, C, H, W = x.shape
    kernels.require(x, "x", torch.float32, (B, C, H, W))
    kernels.require(flow, "flow", torch.float32, (B, 2, H, W))
    if x.requires_grad or flow.requires_grad:
        raise ValueError("warp_vclamped_cuda is forward-only; its inputs "
                         "must not require grad")
    out = torch.empty_like(x)
    rc = kernels.lib().aivc_warp_vclamped(
        x.data_ptr(), flow.data_ptr(), B, C, H, W, V_RADIUS - 1,
        out.data_ptr(), kernels.stream_ptr())
    kernels.check("warp_vclamped", rc)
    kernels.LAUNCHES["warp_vclamped"] += 1
    return out


def warp(x: torch.Tensor, flow: torch.Tensor, row0: int = 0) -> torch.Tensor:
    """Backward-warp x [B, C, H, W] by flow [B, 2, h, W]:
    out(y, x) = x(row0 + y + v, x + u) (aivc_tpu/ops/warp.py:32-94; h = H
    and row0 = 0 but for a band of rows split over 'spatial', which takes
    the plain warp).

    Under ``AIVC_WARP=pallas`` and JAX's shape rule (W % 128 == 0 and
    H % min(H, 256) == 0) the vertically clamped warp: kernel K5 for a
    tensor on the card, its plain version on the host.  That route has no
    gradient, in JAX as here, so an input that requires grad raises.
    Other shapes, or no switch, take the plain border-clamped warp, as in
    JAX."""
    H, W = x.shape[2], x.shape[3]
    whole = row0 == 0 and flow.shape[2] == H
    if _USE_PALLAS and whole and W % LANE == 0 and H % min(H, 256) == 0:
        if torch.is_grad_enabled() and (x.requires_grad
                                        or flow.requires_grad):
            raise ValueError(
                "the vertically clamped warp (AIVC_WARP=pallas) cannot be "
                "differentiated, in the JAX package either: train without "
                "AIVC_WARP=pallas, or at a width that is not a multiple of "
                f"{LANE}")
        if x.device.type == "cuda":
            return warp_vclamped_cuda(x.contiguous(), flow.contiguous())
        return warp_vclamped(x, flow)
    return warp_plain(x, flow, row0)


def motion_compensation(prev: torch.Tensor, nxt: torch.Tensor,
                        v_prev: torch.Tensor, v_next: torch.Tensor,
                        beta: torch.Tensor, row0: int = 0) -> torch.Tensor:
    """beta * warp(prev, v_prev) + (1 - beta) * warp(next, v_next)
    (warp.py:221-234), of the output rows from ``row0``."""
    return (beta * warp(prev, v_prev, row0)
            + (1.0 - beta) * warp(nxt, v_next, row0))
