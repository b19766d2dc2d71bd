"""Quality metrics: PSNR, SSIM, MS-SSIM on NCHW tensors (counterpart of
aivc_tpu/ops/metrics.py).

An 11-tap Gaussian window with sigma 1.5 (smaller when the image is),
VALID filtering, 5 scales with weights MSSSIM_WEIGHTS, a reflect pad to
even size before each 2x2 average pool, a 1e-4 floor before the powers
and the combination prod(mcs[:-1] ** w) * mssim[-1] ** w.  YUV metrics
weight each plane by its pixel count.

The window is applied as two 1-D passes of explicit multiply-adds in
float32: the same sums as JAX's 2-D depthwise convolution in another
order, and no TF32 convolution on the card (the variance terms
E[x^2] - mu^2 cancel and would lose digits).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from aivc_tpu_torch.ops import ties

MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def psnr(mse, max_value: float = 1.0):
    return 20.0 * math.log10(max_value) - 10.0 * torch.log10(
        torch.as_tensor(mse))


def _gaussian_taps(size: int = 11, sigma: float = 1.5):
    g = [math.exp(-((i - size // 2) ** 2) / (2.0 * sigma ** 2))
         for i in range(size)]
    total = sum(g)
    return [v / total for v in g]


def _filter2d(x: torch.Tensor, taps) -> torch.Tensor:
    """Separable VALID filter of NCHW x with the outer product of taps."""
    k = len(taps)
    h, w = x.shape[2] - k + 1, x.shape[3] - k + 1
    rows = taps[0] * x[:, :, :, 0:w]
    for i in range(1, k):
        rows = rows + taps[i] * x[:, :, :, i:i + w]
    out = taps[0] * rows[:, :, 0:h]
    for i in range(1, k):
        out = out + taps[i] * rows[:, :, i:i + h]
    return out


def ssim(img1: torch.Tensor, img2: torch.Tensor, val_range: float = 1.0,
         window_size: int = 11):
    """(SSIM mean, contrast-sensitivity mean) of NCHW images."""
    H, W = img1.shape[2], img1.shape[3]
    taps = _gaussian_taps(min(window_size, H, W))
    mu1 = _filter2d(img1, taps)
    mu2 = _filter2d(img2, taps)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _filter2d(img1 * img1, taps) - mu1_sq
    sigma2_sq = _filter2d(img2 * img2, taps) - mu2_sq
    sigma12 = _filter2d(img1 * img2, taps) - mu1_mu2
    C1 = (0.01 * val_range) ** 2
    C2 = (0.03 * val_range) ** 2
    v1 = 2.0 * sigma12 + C2
    v2 = sigma1_sq + sigma2_sq + C2
    cs = torch.mean(v1 / v2)
    ssim_map = ((2 * mu1_mu2 + C1) * v1) / ((mu1_sq + mu2_sq + C1) * v2)
    return torch.mean(ssim_map), cs


def _reflect_pad_to_even(x: torch.Tensor) -> torch.Tensor:
    pad_h, pad_w = x.shape[2] % 2, x.shape[3] % 2
    if pad_h or pad_w:
        x = F.pad(x, (0, pad_w, 0, pad_h), mode="reflect")
    return x


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    B, C, H, W = x.shape
    return x.reshape(B, C, H // 2, 2, W // 2, 2).mean(dim=(3, 5))


def msssim(img1: torch.Tensor, img2: torch.Tensor,
           val_range: float = 1.0, batch_mean=None) -> torch.Tensor:
    """Multi-scale SSIM of NCHW images (means over the whole batch).
    ``batch_mean``, where the batch is one rank's equal slice of a larger
    one, maps the stacked per-scale means of the slice to the whole
    batch's (parallel/mesh.py:mean_over_data), before the floor and the
    powers, as one computation over the whole batch takes them."""
    weights = torch.tensor(MSSSIM_WEIGHTS, dtype=img1.dtype,
                           device=img1.device)
    mssim, mcs = [], []
    for _ in range(len(MSSSIM_WEIGHTS)):
        sim, cs = ssim(img1, img2, val_range=val_range)
        mssim.append(sim)
        mcs.append(cs)
        img1 = _avg_pool2(_reflect_pad_to_even(img1))
        img2 = _avg_pool2(_reflect_pad_to_even(img2))
    mssim_t, mcs_t = torch.stack(mssim), torch.stack(mcs)
    if batch_mean is not None:
        both = batch_mean(torch.cat([mssim_t, mcs_t]))
        mssim_t, mcs_t = both[:len(mssim)], both[len(mssim):]
    # The floor before the fractional powers keeps their gradients finite
    # (metrics.py:96-104); a tie passes half the gradient, as jnp.maximum.
    mssim_t = ties.floor_at(mssim_t, 1e-4)
    mcs_t = ties.floor_at(mcs_t, 1e-4)
    pow1 = mcs_t ** weights
    pow2 = mssim_t ** weights
    return torch.prod(pow1[:-1]) * pow2[-1]


def yuv_mse(a: Dict[str, torch.Tensor],
            b: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Pixel-count-weighted MSE over a YUV dict of planes."""
    se = 0.0
    n = 0
    for k in ("y", "u", "v"):
        se = se + torch.sum((a[k] - b[k]) ** 2)
        n += a[k].numel()
    return se / n


def yuv_psnr(a, b, max_value: float = 1.0) -> torch.Tensor:
    return psnr(yuv_mse(a, b), max_value)


def yuv_msssim(a, b, max_value: float = 1.0, batch_mean=None
               ) -> torch.Tensor:
    """Pixel-count-weighted per-plane MS-SSIM (``batch_mean``: msssim's)."""
    total = 0.0
    n = 0
    for k in ("y", "u", "v"):
        total = total + msssim(a[k], b[k], val_range=max_value,
                               batch_mean=batch_mean) * a[k].numel()
        n += a[k].numel()
    return total / n


def msssim_db(ms) -> torch.Tensor:
    return -10.0 * torch.log10(1.0 - torch.as_tensor(ms))
