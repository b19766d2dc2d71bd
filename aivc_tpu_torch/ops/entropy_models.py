"""Learned entropy models (counterpart of
aivc_tpu/ops/entropy_models.py): the factorized prior of z, the Laplace /
normal bin probabilities of y, the rate proxy, and the K-component
mixture parameterisation of the hyper-synthesis output.  Layout NCHW.
The clips follow JAX's gradient rule at their bounds (``ops/ties.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from aivc_tpu_torch.config import (
    LOG_VAR_MAX,
    LOG_VAR_MIN,
    PROBA_MIN,
    ec_mode_parts,
)
from aivc_tpu_torch.ops import ties

SQRT2 = 1.4142135623730951


class FactorizedPrior(nn.Module):
    """Per-channel learned CDF (Balle 2018, K = 4 layers of width r = 3)."""

    def __init__(self, nb_channel: int, K: int = 4, r: int = 3):
        super().__init__()
        self.nb_channel, self.K = nb_channel, K
        dims = [1] + [r] * (K - 1) + [1]
        for i in range(K):
            setattr(self, f"h{i}", nn.Parameter(
                torch.zeros(nb_channel, dims[i], dims[i + 1])))
            setattr(self, f"b{i}", nn.Parameter(
                torch.zeros(nb_channel, dims[i + 1])))
        for i in range(K - 1):
            setattr(self, f"a{i}", nn.Parameter(
                torch.zeros(nb_channel, dims[i + 1])))

    def cdf(self, x: torch.Tensor) -> torch.Tensor:
        """x [C, N] evaluation points -> [C, N] CDF values (float32)."""
        t = x[..., None].float()
        for i in range(self.K):
            h = F.softplus(getattr(self, f"h{i}"))
            t = torch.einsum("cnd,cdr->cnr", t, h)
            t = t + getattr(self, f"b{i}")[:, None, :]
            if i != self.K - 1:
                t = t + (torch.tanh(getattr(self, f"a{i}")[:, None, :])
                         * torch.tanh(t))
        return torch.sigmoid(t[..., 0])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Bin probability cdf(x + .5) - cdf(x - .5) of the quantized
        hyper-latent x [B, C, H, W] (entropy_models.py:107-118)."""
        B, C, H, W = x.shape
        flat = x.transpose(0, 1).reshape(C, B * H * W)
        p = self.cdf(flat + 0.5) - self.cdf(flat - 0.5)
        return p.reshape(C, B, H, W).transpose(0, 1)


def laplace_cdf(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return 0.5 + 0.5 * torch.sign(x) * (1.0 - torch.exp(-torch.abs(x) / scale))


def laplace_bin_prob(y: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """P(Y = y) for integer y under a Laplace of std sigma."""
    b = sigma / SQRT2
    return laplace_cdf(y + 0.5, b) - laplace_cdf(y - 0.5, b)


def normal_bin_prob(y: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    ndtr = torch.special.ndtr
    return ndtr((y + 0.5) / sigma) - ndtr((y - 0.5) / sigma)


def bin_prob(y: torch.Tensor, sigma: torch.Tensor,
             pdf_family: str) -> torch.Tensor:
    if "laplace" in pdf_family.split("_"):
        return laplace_bin_prob(y, sigma)
    if "normal" in pdf_family.split("_"):
        return normal_bin_prob(y, sigma)
    raise ValueError(f"unknown pdf family {pdf_family!r}")


def rate_bits(p: torch.Tensor) -> torch.Tensor:
    """Rate proxy in bits: -log2 of the probability clamped at 2^-16."""
    return -torch.log2(ties.clip(p, PROBA_MIN, 1.0))


def pdf_parameterize(x: torch.Tensor, nb_ft: int):
    """Hyper-synthesis output [B, 2C, H, W] -> (mu, sigma), the K = 1
    path: sigma = exp(0.5 * clamp(log-var))."""
    mu = x[:, :nb_ft]
    logvar = ties.clip(x[:, nb_ft:2 * nb_ft], LOG_VAR_MIN, LOG_VAR_MAX)
    return mu, torch.exp(0.5 * logvar)


def pdf_parameterize_mixture(x: torch.Tensor, nb_ft: int,
                             ec_mode: str = "one"):
    """Hyper-synthesis output [B, n*C, H, W] -> K components, each a dict
    {mu, sigma, gamma, weight} of [B, C, H, W] tensors
    (entropy_models.py:134-172).  Channel layout of the reference
    PdfParamParameterizer: K*C mu | K*C log-var | K*C log-gamma (with
    '_gamma') | (K-1)*C weight logits; the weights are a softmax over K
    with component 0's logit wired to 1; gamma is 1 without '_gamma'.
    Coding consumes component 0."""
    K, with_gamma = ec_mode_parts(ec_mode)
    C = nb_ft
    pos = 0

    def take(n):
        nonlocal pos
        out = [x[:, pos + k * C: pos + (k + 1) * C] for k in range(n)]
        pos += n * C
        return out

    def scale(v):
        return torch.exp(0.5 * ties.clip(v, LOG_VAR_MIN, LOG_VAR_MAX))

    mus = take(K)
    sigmas = [scale(lv) for lv in take(K)]
    gammas = ([scale(lg) for lg in take(K)] if with_gamma
              else [torch.ones_like(mus[0])] * K)
    logits = [torch.ones_like(mus[0])] + take(K - 1)
    w = torch.softmax(torch.stack(logits, dim=0), dim=0)
    return [{"mu": mus[k], "sigma": sigmas[k], "gamma": gammas[k],
             "weight": w[k]} for k in range(K)]


def mixture_bin_prob(y: torch.Tensor, components, pdf_family: str,
                     zero_mu: bool = True) -> torch.Tensor:
    """Sum over the components of cdf(y + .5) - cdf(y - .5), unweighted,
    as the reference composes it (entropy_models.py:175-187: the
    overcount is tamed by the rate proxy's clip to [2^-16, 1]).
    ``zero_mu``: mu was subtracted before quantization (the coding
    path)."""
    p = torch.zeros_like(y)
    for comp in components:
        yc = y if zero_mu else y - comp["mu"]
        p = p + bin_prob(yc, comp["sigma"], pdf_family)
    return p
