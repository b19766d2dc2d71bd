"""Independent numpy reference metrics (evaluation oracle): the port's
copy of aivc_tpu/ops/metrics_np.py, the same arithmetic line for line.

A second implementation of PSNR and MS-SSIM (Wang 2003, the CLIC-aligned
combination), in float64 numpy with no framework, that holds the port's
torch metrics (ops/metrics.py) on the host where there is no JAX, and
on the card's machine beside the card's results.
"""

from __future__ import annotations

import numpy as np

MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def psnr_np(a: np.ndarray, b: np.ndarray, max_value: float = 1.0) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float(20 * np.log10(max_value) - 10 * np.log10(max(mse, 1e-12)))


def _gaussian_window(size=11, sigma=1.5):
    g = np.exp(-((np.arange(size) - size // 2) ** 2) / (2 * sigma ** 2))
    g /= g.sum()
    return np.outer(g, g)


def _filter2_valid(img: np.ndarray, window: np.ndarray) -> np.ndarray:
    from numpy.lib.stride_tricks import sliding_window_view

    patches = sliding_window_view(img, window.shape)
    return np.einsum("ijkl,kl->ij", patches, window)


def ssim_np(img1: np.ndarray, img2: np.ndarray, val_range: float = 1.0):
    """(mean SSIM, contrast sensitivity) of 2-D single-channel images."""
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    real_size = min(11, img1.shape[0], img1.shape[1])
    window = _gaussian_window(real_size)

    mu1 = _filter2_valid(img1, window)
    mu2 = _filter2_valid(img2, window)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = _filter2_valid(img1 * img1, window) - mu1_sq
    sigma2_sq = _filter2_valid(img2 * img2, window) - mu2_sq
    sigma12 = _filter2_valid(img1 * img2, window) - mu1_mu2

    C1 = (0.01 * val_range) ** 2
    C2 = (0.03 * val_range) ** 2
    v1 = 2 * sigma12 + C2
    v2 = sigma1_sq + sigma2_sq + C2
    cs = float(np.mean(v1 / v2))
    ssim_map = ((2 * mu1_mu2 + C1) * v1) / ((mu1_sq + mu2_sq + C1) * v2)
    return float(np.mean(ssim_map)), cs


def _reflect_pad_to_even(x: np.ndarray) -> np.ndarray:
    ph, pw = x.shape[0] % 2, x.shape[1] % 2
    if ph or pw:
        x = np.pad(x, ((0, ph), (0, pw)), mode="reflect")
    return x


def msssim_np(img1: np.ndarray, img2: np.ndarray, val_range: float = 1.0) -> float:
    """5-scale MS-SSIM of 2-D single-channel images, CLIC-aligned
    combination prod(mcs[:-1]**w) * mssim[-1]**w."""
    mssim, mcs = [], []
    a, b = img1.astype(np.float64), img2.astype(np.float64)
    for _ in MSSSIM_WEIGHTS:
        s, cs = ssim_np(a, b, val_range)
        mssim.append(s)
        mcs.append(cs)
        a = _reflect_pad_to_even(a)
        b = _reflect_pad_to_even(b)
        a = a.reshape(a.shape[0] // 2, 2, a.shape[1] // 2, 2).mean(axis=(1, 3))
        b = b.reshape(b.shape[0] // 2, 2, b.shape[1] // 2, 2).mean(axis=(1, 3))
    mssim = np.maximum(np.array(mssim), 0.0)
    mcs = np.maximum(np.array(mcs), 0.0)
    w = np.array(MSSSIM_WEIGHTS)
    return float(np.prod(mcs[:-1] ** w[:-1]) * mssim[-1] ** w[-1])
