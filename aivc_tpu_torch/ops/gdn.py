"""Generalized Divisive Normalization (NCHW).

y[i] = x[i] / sqrt(beta[i] + sum_j gamma[i, j] * x[j]^2)   (inverse: multiply)

``gdn_apply`` is the counterpart of aivc_tpu/ops/gdn.py:gdn_apply
(gdn.py:57-97), with its ``clamp`` and its low-precision rule; the channel
mixing is a 1x1 convolution (cuDNN), accumulated in float32 whatever the
activation type.

``gdn_fused`` is the counterpart of the fused Pallas GDN,
aivc_tpu/ops/gdn.py:gdn_pallas (body _gdn_kernel, gdn.py:121-165):
kernel K4 on the card (csrc/kernels.cu: gdn_fused_tc_kernel on the
tensor cores for bf16, gdn_fused_f32_kernel for f32),
``gdn_fused_plain`` on the host, under JAX's shape rule.  Like
gdn_pallas it is an exported function with no caller in the models: the
GDN layers use ``gdn_apply``, as the JAX models do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from aivc_tpu_torch import kernels
from aivc_tpu_torch.ops import ties

REPARAM_OFFSET = 2.0 ** -18
PEDESTAL = REPARAM_OFFSET ** 2
BETA_MIN = 1e-6
# Initial gamma of a fresh GDN: sqrt(GAMMA_INIT * I + PEDESTAL).
GAMMA_INIT = 0.1
# gdn_pallas's shape rule: rows in tiles of 512, channels a multiple of 128.
FUSED_ROWS = 512
FUSED_CHANNELS = 128


class LowerBound(torch.autograd.Function):
    """max(x, bound) whose gradient passes where x >= bound or where it
    pushes the value up (g < 0), JAX's custom VJP ``lower_bound``
    (aivc_tpu/ops/gdn.py:31-46): a parameter at the bound is not stuck
    there, as it would be under ``torch.clamp_min``."""

    @staticmethod
    def forward(ctx, x, bound: float):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp_min(x, bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        pass_through = (x >= ctx.bound) | (g < 0)
        return torch.where(pass_through, g, torch.zeros_like(g)), None


def lower_bound(x: torch.Tensor, bound: float) -> torch.Tensor:
    return LowerBound.apply(x, bound)


def reparam(beta_r: torch.Tensor, gamma_r: torch.Tensor):
    """LowerBound reparameterisation -> (beta [C], gamma [C, C])."""
    beta_bound = (BETA_MIN + PEDESTAL) ** 0.5
    beta = lower_bound(beta_r, beta_bound) ** 2 - PEDESTAL
    gamma = lower_bound(gamma_r, REPARAM_OFFSET) ** 2 - PEDESTAL
    return beta, gamma


def gdn_apply(x: torch.Tensor, beta_r: torch.Tensor, gamma_r: torch.Tensor,
              inverse: bool, clamp: float = 0.0,
              lowp: bool = False) -> torch.Tensor:
    """(I)GDN of NCHW ``x`` given reparameterised beta [C] / gamma [C, C].

    Type rules follow the JAX function: the parameters stay float32
    unless ``lowp`` and ``x`` is not float32, in which case they are cast
    to ``x``'s type; the normaliser is accumulated in float32, cast to
    ``x``'s type, and the sum with beta promotes as JAX does."""
    beta, gamma = reparam(beta_r, gamma_r)
    x2 = torch.square(x)
    if lowp and x.dtype != torch.float32:
        gamma = gamma.to(x.dtype)
        beta = beta.to(x.dtype)
        # bf16 x bf16 products are exact in f32; the conv accumulates in
        # f32 and rounds once to x's type.
        norm = F.conv2d(x2, gamma[:, :, None, None])
    else:
        norm = F.conv2d(x2.float(), gamma.float()[:, :, None, None])
        norm = norm.to(x.dtype)
    norm = torch.sqrt(norm + beta.view(1, -1, 1, 1))
    if clamp > 0.0:
        norm = ties.clip(norm, 1.0 / clamp, clamp)
    return x * norm if inverse else x / norm


def gdn_fused_plain(x: torch.Tensor, beta: torch.Tensor, gamma: torch.Tensor,
                    inverse: bool) -> torch.Tensor:
    """Plain version of kernel K4 on x [B, C, H, W] (f32 or bf16) and the
    reparameterised beta [C], gamma [C, C] (f32).

    The body of gdn_pallas: x2 = x * x in x's type; norm[o] =
    sqrt(sum_j x2[j] * gamma[o, j] + beta[o]) in f32, summed over j in
    order (each product and each sum rounded, no FMA, as the kernel
    does; elementwise ops only, so no TF32 matmul or convolution), cast
    to x's type; then x / norm (x * norm for the inverse)."""
    x2 = torch.square(x).float()
    g = gamma.float()
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for j in range(x.shape[1]):
        acc = acc + x2[:, j:j + 1] * g[:, j].view(1, -1, 1, 1)
    norm = torch.sqrt(acc + beta.float().view(1, -1, 1, 1)).to(x.dtype)
    return x * norm if inverse else x / norm


def split_gamma(gamma: torch.Tensor):
    """gamma (f32) as two bf16 terms (hi, lo): hi = bf16(gamma), lo =
    bf16(gamma - hi), so hi + lo keeps ~16 bits of gamma.  K4's bf16 path
    multiplies both on the tensor cores."""
    g = gamma.float()
    hi = g.to(torch.bfloat16)
    lo = (g - hi.float()).to(torch.bfloat16)
    return hi.contiguous(), lo.contiguous()


def gdn_fused_cuda(x: torch.Tensor, beta: torch.Tensor, gamma: torch.Tensor,
                   inverse: bool) -> torch.Tensor:
    """Kernel K4 on the card: the contract of ``gdn_fused_plain`` for a
    contiguous f32 or bf16 x with C % 128 == 0.  f32 x is bit-identical
    to it; bf16 x goes to the tensor cores, which sum in their own order,
    and is within 2 bf16 ulps of it.  Forward only (it has no backward
    yet), so an input that requires grad is refused."""
    B, C, H, W = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.requires_grad or beta.requires_grad or gamma.requires_grad:
        raise ValueError("gdn_fused_cuda is forward-only; its inputs must "
                         "not require grad")
    kernels.require(x, "x", x.dtype, (B, C, H, W))
    if C % FUSED_CHANNELS:
        raise ValueError(f"C={C} must be a multiple of {FUSED_CHANNELS}")
    beta = beta.float().contiguous()
    kernels.require(beta, "beta", torch.float32, (C,))
    out = torch.empty_like(x)
    if x.dtype == torch.bfloat16:
        hi, lo = split_gamma(gamma)
        kernels.require(hi, "gamma", torch.bfloat16, (C, C))
        rc = kernels.lib().aivc_gdn_fused_bf16(
            x.data_ptr(), hi.data_ptr(), lo.data_ptr(), beta.data_ptr(), B,
            C, H * W, int(inverse), out.data_ptr(), kernels.stream_ptr())
    else:
        gamma_t = gamma.float().t().contiguous()      # [j, o]
        kernels.require(gamma_t, "gamma", torch.float32, (C, C))
        rc = kernels.lib().aivc_gdn_fused(
            x.data_ptr(), gamma_t.data_ptr(), beta.data_ptr(), B, C, H * W,
            int(inverse), out.data_ptr(), kernels.stream_ptr())
    kernels.check("gdn_fused", rc)
    kernels.LAUNCHES["gdn_fused"] += 1
    return out


def fused_shape(x: torch.Tensor) -> bool:
    """gdn_pallas's shape rule on NCHW x: B*H*W rows a multiple of 512
    and C of 128."""
    B, C, H, W = x.shape
    return (B * H * W) % FUSED_ROWS == 0 and C % FUSED_CHANNELS == 0


def gdn_fused(x: torch.Tensor, beta_r: torch.Tensor, gamma_r: torch.Tensor,
              inverse: bool = False) -> torch.Tensor:
    """Fused (I)GDN of NCHW x, the counterpart of
    aivc_tpu/ops/gdn.py:gdn_pallas.  Rows are the B*H*W pixels; when
    their count is not a multiple of 512 or C not of 128 this is
    ``gdn_apply(x, beta_r, gamma_r, inverse)``, as in JAX (gdn.py:143).
    Otherwise kernel K4 for a tensor on the card, its plain version on
    the host."""
    if not fused_shape(x):
        return gdn_apply(x, beta_r, gamma_r, inverse)
    beta, gamma = reparam(beta_r, gamma_r)
    if x.device.type == "cuda":
        return gdn_fused_cuda(x.contiguous(), beta, gamma, inverse)
    return gdn_fused_plain(x, beta, gamma, inverse)


class GDN(nn.Module):
    """Holds the reparameterised beta/gamma (checkpoint names kept)."""

    def __init__(self, ch: int, inverse: bool = False, clamp: float = 0.0,
                 lowp: bool = False):
        super().__init__()
        self.beta = nn.Parameter(torch.ones(ch))
        self.gamma = nn.Parameter(torch.eye(ch))
        self.inverse, self.clamp, self.lowp = inverse, clamp, lowp

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gdn_apply(x, self.beta, self.gamma, self.inverse, self.clamp,
                         self.lowp)
