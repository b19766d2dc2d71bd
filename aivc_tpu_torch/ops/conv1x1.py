"""Kernel K7: a channels-last bf16 1x1 convolution with its bias, its
activation and its residual in the same pass (ELIC's bottlenecks and
attention gates, models/elic.py).

``conv1x1`` computes, for x [B, K, H, W], a weight [N, K] and a bias [N]
(all bf16), at the rounding points of the unfused path on the card (cuDNN
rounds the conv to bf16; PyTorch then adds the bias, and applies ReLU,
sigmoid, product and sum, each rounding once), s = bf16(conv(x)):

* ``"relu"``:     relu(bf16(s + b))                     (a bottleneck's conv a)
* ``"residual"``: x is the raw output r of the 3x3 conv before (run
  without its bias ``bias_in``) and enters as relu(bf16(r + bias_in));
  out = bf16(residual + bf16(s + b))                    (conv c)
* ``"gate"``:     out = bf16(residual + bf16(trunk * bf16(sigmoid(bf16(s +
  b)))))                                                (the attention's gate)

``conv1x1_cuda`` is the kernel (csrc/kernels.cu:conv1x1_tc_kernel): x,
``residual`` and ``trunk`` channels-last, the output channels-last; it
sums in the tensor cores' order, so its first rounding may differ from
cuDNN's by one bf16 ulp (more only where the sum cancels) and the rest
follows it.  ``conv1x1_plain`` is the same function in PyTorch ops, in
the module's own order; ``conv1x1`` takes the kernel for a tensor on the
card and the plain version on the host.  The kernel's launches count in
``kernels.LAUNCHES["conv1x1"]``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from aivc_tpu_torch import kernels

EPILOGUES = ("relu", "residual", "gate")
# Widths the kernel takes: multiples of 16 (the tensor cores' k-step and
# two n-tiles of 8) up to 320 (ELIC's M), inputs and outputs alike.
WIDTH_STEP = 16
MAX_WIDTH = 320


def fits(k: int, n: int) -> bool:
    """Whether K7 takes a 1x1 conv of k inputs and n outputs."""
    return all(c % WIDTH_STEP == 0 and WIDTH_STEP <= c <= MAX_WIDTH
               for c in (k, n))


def epilogue_plain(s: torch.Tensor, bias: torch.Tensor, epilogue: str,
                   residual: Optional[torch.Tensor] = None,
                   trunk: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The epilogue of ``conv1x1_plain`` on the conv's rounded output s
    [B, N, H, W] bf16: the bias, then ReLU, the residual add or the gate,
    each rounded to bf16 as PyTorch's ops round."""
    v = s + bias.view(1, -1, 1, 1)
    if epilogue == "relu":
        return torch.relu(v)
    if epilogue == "residual":
        return residual + v
    if epilogue == "gate":
        return residual + trunk * torch.sigmoid(v)
    raise ValueError(f"epilogue must be one of {EPILOGUES}, got "
                     f"{epilogue!r}")


def conv1x1_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  epilogue: str, bias_in: Optional[torch.Tensor] = None,
                  residual: Optional[torch.Tensor] = None,
                  trunk: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of kernel K7, in PyTorch ops: the contract of
    ``conv1x1_cuda`` on any device and layout (x's layout out)."""
    n, k = weight.shape
    if epilogue == "residual":
        x = torch.relu(x + bias_in.view(1, -1, 1, 1))
    s = F.conv2d(x, weight.view(n, k, 1, 1))
    return epilogue_plain(s, bias, epilogue, residual, trunk).contiguous(
        memory_format=kernels.layout(x))


def conv1x1_cuda(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 epilogue: str, bias_in: Optional[torch.Tensor] = None,
                 residual: Optional[torch.Tensor] = None,
                 trunk: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel K7 on the card.  x bf16 [B, K, H, W] channels-last; weight
    bf16 [N, K] contiguous; bias bf16 [N]; ``bias_in`` bf16 [K] (the
    residual epilogue); ``residual`` bf16 [B, N, H, W] channels-last (the
    residual and the gate epilogues), ``trunk`` the same (the gate).  K
    and N multiples of 16 up to 320 (``fits``), every tensor 16-byte
    aligned.  Out: bf16 [B, N, H, W] channels-last.  Forward only: an
    input that requires grad is refused (the nets call it under no
    graph)."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"epilogue must be one of {EPILOGUES}, got "
                         f"{epilogue!r}")
    if x.dim() != 4:
        raise ValueError(f"x must be [B, K, H, W], got {tuple(x.shape)}")
    B, K, H, W = x.shape
    if weight.dim() != 2 or weight.shape[1] != K:
        raise ValueError(f"weight must be [N, {K}], got "
                         f"{tuple(weight.shape)}")
    N = weight.shape[0]
    if not fits(K, N):
        raise ValueError(f"K={K}, N={N}: each must be a multiple of "
                         f"{WIDTH_STEP} from {WIDTH_STEP} to {MAX_WIDTH}")
    if B * H * W >= 2 ** 31:
        raise ValueError(f"{B * H * W} pixels: at most 2^31 - 1")
    need = {"x": x, "weight": weight, "bias": bias}
    if epilogue == "residual":
        need["bias_in"] = bias_in
    if epilogue != "relu":
        need["residual"] = residual
    if epilogue == "gate":
        need["trunk"] = trunk
    for name, t in need.items():
        if t is None:
            raise ValueError(f"the {epilogue} epilogue needs {name}")
        if t.requires_grad:
            raise ValueError(f"conv1x1_cuda is forward-only; {name} must "
                             f"not require grad")
    shapes = {"x": (B, K, H, W), "weight": (N, K), "bias": (N,),
              "bias_in": (K,), "residual": (B, N, H, W),
              "trunk": (B, N, H, W)}
    fmts = {}
    for name, t in need.items():
        fmts[name] = fmt = (torch.channels_last if t.dim() == 4
                            else torch.contiguous_format)
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bfloat16, got {t.dtype}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} must have shape {shapes[name]}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous(memory_format=fmt):
            raise ValueError(f"{name} must be contiguous ({fmt})")
    for name, t in need.items():
        kernels.require(t, name, torch.bfloat16, shapes[name], fmts[name])
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start 16-byte aligned")
    out = torch.empty((B, N, H, W), device=x.device, dtype=torch.bfloat16,
                      memory_format=torch.channels_last)

    def ptr(name):
        return need[name].data_ptr() if name in need else None

    rc = kernels.lib().aivc_conv1x1(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), ptr("bias_in"),
        ptr("residual"), ptr("trunk"), B * H * W, K, N,
        EPILOGUES.index(epilogue), out.data_ptr(), kernels.stream_ptr())
    kernels.check("conv1x1", rc)
    kernels.LAUNCHES["conv1x1"] += 1
    return out


def conv1x1(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            epilogue: str, bias_in: Optional[torch.Tensor] = None,
            residual: Optional[torch.Tensor] = None,
            trunk: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K7 for a tensor on the card, its plain version on the host."""
    fn = conv1x1_cuda if x.device.type == "cuda" else conv1x1_plain
    return fn(x, weight, bias, epilogue, bias_in, residual, trunk)
