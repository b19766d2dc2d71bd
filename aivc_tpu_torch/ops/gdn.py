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
gdn_pallas it is an exported function with no caller in the models.

The GDN layers (``GDN``) compute ``gdn_apply``.  On the card, a bf16
input of 96 or 128 channels that autograd needs no graph for, in a layer
without a clamp, goes to K4 at gdn_apply's own rounding points
(``gdn_layer_cuda``: csrc/kernels.cu:gdn_layer_tc_kernel; its plain
version ``gdn_layer_plain``), with or without the low-precision rule:
the same function, summed in the tensor cores' order.  It takes x
NCHW-contiguous or channels-last (the bf16 nets' layout between their
convolutions, ops/layers.py) and returns its output in x's layout, each
value the same in both.  Every other input
(the host, training, float32 nets, clamped layers) takes gdn_apply, and
on the card counts in ``kernels.FALLBACKS["gdn_layer"]``; the kernel's
launches count in ``kernels.LAUNCHES["gdn_layer"]``, gdn_fused's in
``LAUNCHES["gdn_fused"]``.
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
# Channel counts the GDN layers' kernel is built for (MOFNet, CodecNet).
LAYER_CHANNELS = (96, 128)


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


def layer_params(beta: torch.Tensor, gamma: torch.Tensor, lowp: bool):
    """The GDN layers' kernel's parameters from the reparameterised beta
    and gamma: (beta f32 [C], hi, lo bf16 [C, C]); with ``lowp`` beta
    holds bf16(beta) and gamma is hi alone (lo is hi, and not read), as
    gdn_apply casts both to the activation's type."""
    hi, lo = split_gamma(gamma)
    beta = beta.float()
    if lowp:
        beta, lo = beta.to(torch.bfloat16).float(), hi
    return beta.contiguous(), hi, lo


def gdn_layer_plain(x: torch.Tensor, beta: torch.Tensor, hi: torch.Tensor,
                    lo: torch.Tensor, inverse: bool,
                    lowp: bool) -> torch.Tensor:
    """Plain version of the GDN layers' kernel (``gdn_layer_cuda``'s
    arguments) on bf16 x [B, C, H, W]: ``gdn_apply(x, ..., clamp=0,
    lowp=lowp)`` with the channel sum of the tensor cores, x2 * (hi + lo)
    (hi alone with ``lowp``), emulated exact in float64 and rounded once
    to f32.  Every rounding after the sum is gdn_apply's: the sum to
    bf16; then with ``lowp`` bf16(beta) added, the root and the quotient
    each rounded to bf16; without it all in f32, an f32 output."""
    g = hi.double() if lowp else hi.double() + lo.double()
    x2 = torch.square(x).double()
    norm = torch.einsum("bjhw,oj->bohw", x2, g).float().to(x.dtype)
    if lowp:
        beta = beta.to(x.dtype)
    norm = torch.sqrt(norm + beta.view(1, -1, 1, 1))
    return x * norm if inverse else x / norm


def gdn_layer_cuda(x: torch.Tensor, beta: torch.Tensor, hi: torch.Tensor,
                   lo: torch.Tensor, inverse: bool,
                   lowp: bool) -> torch.Tensor:
    """Kernel K4 at gdn_apply's rounding points, the contract of
    ``gdn_layer_plain``, on a bf16 x of C in LAYER_CHANNELS, contiguous
    or channels-last, and ``layer_params``.  Out, in x's layout: bf16
    with ``lowp``, else f32, gdn_apply's types.  Forward only, as
    gdn_fused_cuda: an x that requires grad is refused (the layer hands
    it a detached x, under no graph)."""
    B, C, H, W = x.shape
    if x.requires_grad:
        raise ValueError("gdn_layer_cuda is forward-only; x must not "
                         "require grad")
    fmt = kernels.layout(x)
    kernels.require(x, "x", torch.bfloat16, (B, C, H, W), fmt)
    if C not in LAYER_CHANNELS:
        raise ValueError(f"C={C} must be one of {LAYER_CHANNELS}")
    kernels.require(beta, "beta", torch.float32, (C,))
    kernels.require(hi, "gamma", torch.bfloat16, (C, C))
    kernels.require(lo, "gamma", torch.bfloat16, (C, C))
    out = torch.empty(x.shape, device=x.device,
                      dtype=torch.bfloat16 if lowp else torch.float32,
                      memory_format=fmt)
    rc = kernels.lib().aivc_gdn_layer_bf16(
        x.data_ptr(), hi.data_ptr(), lo.data_ptr(), beta.data_ptr(), B, C,
        H * W, int(inverse), int(lowp), int(fmt == torch.channels_last),
        out.data_ptr(), kernels.stream_ptr())
    kernels.check("gdn_layer", rc)
    kernels.LAUNCHES["gdn_layer"] += 1
    return out


def _on_card(x: torch.Tensor) -> bool:
    return x.device.type == "cuda"


class GDN(nn.Module):
    """Holds the reparameterised beta/gamma (checkpoint names kept).

    The forward is ``gdn_apply``; on the card it takes K4
    (``gdn_layer_cuda``) where ``takes_kernel`` holds.  The kernel's
    parameters are made once per version of beta and gamma: the cache is
    keyed on their version counters and storage, which ``load_state_dict``,
    optimiser steps, ``copy_`` and moves between devices all change (an
    update through ``.data`` would not; the port makes none)."""

    def __init__(self, ch: int, inverse: bool = False, clamp: float = 0.0,
                 lowp: bool = False):
        super().__init__()
        self.beta = nn.Parameter(torch.ones(ch))
        self.gamma = nn.Parameter(torch.eye(ch))
        self.inverse, self.clamp, self.lowp = inverse, clamp, lowp
        self._kernel_params = None

    def takes_kernel(self, x: torch.Tensor) -> bool:
        """K4 for x: on the card, bf16, 96 or 128 channels, no clamp, and
        no autograd graph wanted (grad mode off, or neither x nor the
        parameters require grad)."""
        needs_graph = torch.is_grad_enabled() and (
            x.requires_grad or self.beta.requires_grad
            or self.gamma.requires_grad)
        return (_on_card(x) and x.dtype == torch.bfloat16
                and x.shape[1] in LAYER_CHANNELS and self.clamp == 0.0
                and not needs_graph)

    def kernel_params(self):
        """``layer_params`` of this layer's parameters, made again only
        after they change (every call where they are inference tensors,
        which have no version counter)."""
        p = (self.beta, self.gamma)
        key = None if any(t.is_inference() for t in p) else tuple(
            v for t in p for v in (t._version, t.data_ptr()))
        if key is None or self._kernel_params is None \
                or self._kernel_params[0] != key:
            with torch.no_grad():
                beta, gamma = reparam(self.beta, self.gamma)
                self._kernel_params = (key, layer_params(beta, gamma,
                                                         self.lowp))
        return self._kernel_params[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.takes_kernel(x):
            x = x.detach()
            return gdn_layer_cuda(x.contiguous(
                memory_format=kernels.layout(x)),
                                  *self.kernel_params(),
                                  self.inverse, self.lowp)
        if _on_card(x):
            kernels.FALLBACKS["gdn_layer"] += 1
        return gdn_apply(x, self.beta, self.gamma, self.inverse, self.clamp,
                         self.lowp)
