"""Bilinear motion-compensation warp of byte-packed frames (NCHW output).

Counterpart of aivc_tpu/ops/warp.py:pack_yuv_u32 and warp_packed
(warp.py:96-169) and of the bounded-flow kernel that flow-bounded models
take on the TPU (ops/warp_pallas.py:warp_bounded_pallas).

``warp_packed`` is the plain PyTorch version; ``warp_packed_cuda`` wraps
kernel K3 (csrc/kernels.cu:warp_packed_kernel), which is bit-identical to
it on the card.  ``mc_warp`` takes the plain version for a tensor on the
host and the kernel for a tensor on the card.
"""

from __future__ import annotations

import torch

from aivc_tpu_torch import kernels

# Largest flow bound the bounded-warp engine serves
# (aivc_tpu/ops/warp_pallas.py:FB_MAX).
FB_MAX = 38
_INV255 = 1.0 / 255.0


def pack_yuv_u32(x: torch.Tensor) -> torch.Tensor:
    """256-level [B, 3, H, W] frame in [0, 1] -> [B, H, W] int32 holding
    the bytes y | u << 8 | v << 16."""
    q = torch.round(x * 255.0).to(torch.int32)
    return q[:, 0] | (q[:, 1] << 8) | (q[:, 2] << 16)


def warp_packed(packed: torch.Tensor, u: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
    """Plain version: backward-warp ``packed`` [B, H, W] by the flow planes
    (u horizontal, v vertical) [B, H, W], border clamp, bilinear.  Returns
    f32 [B, 3, H, W] in [0, 1].  Every float op is a separate eager op, so
    nothing is contracted into an FMA."""
    B, H, W = packed.shape
    dev = packed.device
    f32 = torch.float32
    xx = torch.arange(W, dtype=f32, device=dev).view(1, 1, W)
    yy = torch.arange(H, dtype=f32, device=dev).view(1, H, 1)
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
        return torch.gather(flat, 1, (yi * W + xi).reshape(B, H * W)
                            ).reshape(B, 1, H, W)

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
                     v: torch.Tensor) -> torch.Tensor:
    """Kernel K3 on the card: same contract as ``warp_packed``."""
    B, H, W = packed.shape
    kernels.require(packed, "packed", torch.int32, (B, H, W))
    kernels.require(u, "u", torch.float32, (B, H, W))
    kernels.require(v, "v", torch.float32, (B, H, W))
    out = torch.empty((B, 3, H, W), dtype=torch.float32,
                      device=packed.device)
    lib = kernels.lib()
    rc = lib.aivc_warp_packed(packed.data_ptr(), u.data_ptr(), v.data_ptr(),
                              B, H, W, out.data_ptr(), kernels.stream_ptr())
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
            engine: str) -> torch.Tensor:
    """Motion-compensation warp.  On the host both engines run the plain
    version; on the card the bounded engine launches K3 (no fallback) and
    the packed engine runs the plain version op by op."""
    if packed.device.type == "cuda" and engine == "bounded":
        return warp_packed_cuda(packed.contiguous(), u.contiguous(),
                                v.contiguous())
    return warp_packed(packed, u, v)
