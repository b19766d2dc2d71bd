"""ConditionalNet: one conditional autoencoder with hyperprior and gains,
NCHW (counterpart of aivc_tpu/models/conditional.py:163-321).

  analyze:         y = g_a(x) * gain_enc;  z_q = clip(round(h_a(y)))
  hyper_decode:    mu, sigma of component 0 of pdf_param(h_s(z_q))
  synthesize:      x_hat = g_s(cat((y_cq + mu) * gain_dec, g_a_ref(shortcut)))
  encode_latents:  analyze + hyper_decode + y_cq = clip(round(y - mu)) and
                   the rates -log2 p of z_q and y_cq (the RD forward); in
                   training, uniform noise replaces both roundings (z's
                   drawn first, then y's) and the rate of a mixture
                   ec_mode sums its components

Row bands (``split_rows``, a parallel/halo.py:RowBand): g_a, g_a_ref and
g_s run on this rank's band of the frame's rows, with their convs'
halos exchanged; the hyper stages run whole on every rank, on y gathered
over 'spatial' (the z grid, hp / 64 rows, does not split, and holds
1/256 of the pixels).  ``analyze`` then returns the whole y;
``encode_latents`` this band's y_cq, mu, sigma and rate_y (noise drawn
for the whole y, this band's rows kept) with the whole z_q and rate_z;
``synthesize`` takes this band's y_cq, mu and shortcut.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from aivc_tpu_torch.config import (
    AC_MAX_VAL,
    FRAME_B,
    FRAME_I,
    FRAME_P,
    ConditionalNetConfig,
)
from aivc_tpu_torch.ops import ties
from aivc_tpu_torch.ops.entropy_models import (
    FactorizedPrior,
    bin_prob,
    mixture_bin_prob,
    pdf_parameterize,
    pdf_parameterize_mixture,
    rate_bits,
)
from aivc_tpu_torch.ops.gain import GainMatrix
from aivc_tpu_torch.ops.layers import (
    ConvBlock,
    SimplifiedAttention,
    UpBlock,
    nchw_f32,
    split_rows,
)
from aivc_tpu_torch.ops.quantizer import quantize
from aivc_tpu_torch.parallel.halo import BandNoise


def _gdn_name(base: str, clamp: float, lowp: bool) -> str:
    name = base if not clamp else f"{base}@{clamp}"
    return name + "!lp" if lowp else name


class AnalysisTransform(nn.Module):
    """g_a / g_a_ref: 4x stride-2 conv stack with GDN -> float32 latents."""

    def __init__(self, in_c: int, nb_ft: int, out_ft: int, k_size: int = 5,
                 use_attention: bool = True, dtype: str = "float32",
                 gdn_clamp: float = 0.0, gdn_lowp: bool = False):
        super().__init__()
        gdn = _gdn_name("gdn", gdn_clamp, gdn_lowp)
        self.ConvBlock_0 = ConvBlock(in_c, nb_ft, k_size, 2, gdn, dtype)
        self.ConvBlock_1 = ConvBlock(nb_ft, nb_ft, k_size, 2, gdn, dtype)
        self.use_attention = use_attention
        if use_attention:
            self.SimplifiedAttention_0 = SimplifiedAttention(nb_ft,
                                                             dtype=dtype)
        self.ConvBlock_2 = ConvBlock(nb_ft, nb_ft, k_size, 2, gdn, dtype)
        self.ConvBlock_3 = ConvBlock(nb_ft, out_ft, k_size, 2, "no", dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.ConvBlock_1(self.ConvBlock_0(self.ConvBlock_0.entry(x)))
        if self.use_attention:
            x = self.SimplifiedAttention_0(x)
        x = self.ConvBlock_3(self.ConvBlock_2(x))
        return nchw_f32(x)


class SynthesisTransform(nn.Module):
    """g_s: 4x x2 upsampling with IGDN -> float32 output."""

    def __init__(self, in_c: int, nb_ft: int, out_ft: int, k_size: int = 5,
                 use_attention: bool = True, dtype: str = "float32",
                 gdn_clamp: float = 0.0, gdn_lowp: bool = False):
        super().__init__()
        igdn = _gdn_name("gdn_inverse", gdn_clamp, gdn_lowp)
        self.UpBlock_0 = UpBlock(in_c, nb_ft, k_size, igdn, dtype)
        self.use_attention = use_attention
        if use_attention:
            self.SimplifiedAttention_0 = SimplifiedAttention(nb_ft,
                                                             dtype=dtype)
        self.UpBlock_1 = UpBlock(nb_ft, nb_ft, k_size, igdn, dtype)
        self.UpBlock_2 = UpBlock(nb_ft, nb_ft, k_size, igdn, dtype)
        self.UpBlock_3 = UpBlock(nb_ft, out_ft, k_size, "no", dtype)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        y = self.UpBlock_0(self.UpBlock_0.entry(y))
        if self.use_attention:
            y = self.SimplifiedAttention_0(y)
        y = self.UpBlock_3(self.UpBlock_2(self.UpBlock_1(y)))
        return nchw_f32(y)


class HyperAnalysis(nn.Module):
    def __init__(self, in_c: int, nb_ft: int, out_ft: int,
                 dtype: str = "float32"):
        super().__init__()
        self.ConvBlock_0 = ConvBlock(in_c, nb_ft, 3, 1, "leaky_relu", dtype)
        self.ConvBlock_1 = ConvBlock(nb_ft, nb_ft, 5, 2, "leaky_relu", dtype)
        self.ConvBlock_2 = ConvBlock(nb_ft, out_ft, 5, 2, "no", dtype)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        y = self.ConvBlock_0.entry(ties.abs_(y))
        return nchw_f32(self.ConvBlock_2(self.ConvBlock_1(
            self.ConvBlock_0(y))))


class HyperSynthesis(nn.Module):
    def __init__(self, in_c: int, nb_ft: int, out_ft: int,
                 dtype: str = "float32"):
        super().__init__()
        self.UpBlock_0 = UpBlock(in_c, nb_ft, 5, "leaky_relu", dtype)
        self.UpBlock_1 = UpBlock(nb_ft, nb_ft, 5, "leaky_relu", dtype)
        self.ConvBlock_0 = ConvBlock(nb_ft, out_ft, 3, 1, "no", dtype)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        z = self.UpBlock_1(self.UpBlock_0(self.UpBlock_0.entry(z)))
        return nchw_f32(self.ConvBlock_0(z))


class ConditionalNet(nn.Module):
    def __init__(self, c: ConditionalNetConfig, gain_i: bool = True):
        """gain_i=False leaves out the I-frame gains, which MOFNet never
        uses (its checkpoints carry none)."""
        super().__init__()
        self.cfg = c
        d, clamp, lowp = c.dtype, c.gdn_clamp, c.gdn_lowp
        self.g_a = AnalysisTransform(c.in_c, c.nb_ft, c.nb_ft_y, c.k_size,
                                     c.use_attention, d, clamp, lowp)
        if c.in_c_shortcut > 0:
            self.g_a_ref = AnalysisTransform(
                c.in_c_shortcut, c.nb_ft, c.out_c_shortcut_y, c.k_size,
                False, d, clamp, lowp)
        self.g_s = SynthesisTransform(c.nb_ft_y + c.out_c_shortcut_y,
                                      c.nb_ft, c.out_c, c.k_size,
                                      c.use_attention, d, clamp, lowp)
        self.h_a = HyperAnalysis(c.nb_ft_y, c.nb_ft_z, c.nb_ft_z, d)
        self.h_s = HyperSynthesis(c.nb_ft_z, c.nb_ft_y, c.sigma_cond_c, d)
        self.pdf_z = FactorizedPrior(c.nb_ft_z)
        if gain_i or not c.gain_p_b:
            self.gain_I = GainMatrix(c.n_rates, c.nb_ft_y)
        if c.gain_p_b:
            self.gain_P = GainMatrix(c.n_rates, c.nb_ft_y)
            self.gain_B = GainMatrix(c.n_rates, c.nb_ft_y)
        self.band = None

    def split_rows(self, band) -> None:
        """Run g_a, g_a_ref and g_s on the row band ``band`` (a RowBand;
        None: the whole frame)."""
        self.band = band
        for stage in (self.g_a, getattr(self, "g_a_ref", None), self.g_s):
            if stage is not None:
                split_rows(stage, band)

    def _whole(self, y: torch.Tensor) -> torch.Tensor:
        return y if self.band is None else self.band.gather(y)

    def _gain(self, x, idx_rate: float, mode: str, frame_type: int):
        if not self.cfg.gain_p_b or frame_type == FRAME_I:
            return self.gain_I(x, idx_rate, mode)
        if frame_type == FRAME_P:
            return self.gain_P(x, idx_rate, mode)
        if frame_type == FRAME_B:
            return self.gain_B(x, idx_rate, mode)
        raise ValueError(f"bad frame_type {frame_type}")

    def analyze(self, x: torch.Tensor, idx_rate: float, frame_type: int):
        """x [B, in_c, H, W] -> (gained y, integer-valued z_q), float32
        (of a row band x: the whole y)."""
        y = self._whole(self._gain(self.g_a(x), idx_rate, "enc",
                                   frame_type))
        return y, quantize(self.h_a(y), AC_MAX_VAL)

    def _pdf_components(self, z_q: torch.Tensor, hy: int, wy: int):
        """Hyper-synthesis -> the K mixture components (dicts of mu and
        sigma, plus gamma and weight for K > 1), cropped to a y grid of
        hy x wy (conditional.py:277-291)."""
        h = self.h_s(z_q)
        if self.cfg.mixture_k == 1:
            mu, sigma = pdf_parameterize(h, self.cfg.nb_ft_y)
            comps = [{"mu": mu, "sigma": sigma}]
        else:
            comps = pdf_parameterize_mixture(h, self.cfg.nb_ft_y,
                                             self.cfg.ec_mode)
        return [{k: v[:, :, :hy, :wy] for k, v in c.items()} for c in comps]

    def hyper_decode(self, z_q: torch.Tensor):
        """Decoded z -> (mu, sigma) of component 0, cropped to the y grid
        (the coding path reads component 0, conditional.py:293-297)."""
        c0 = self._pdf_components(z_q, z_q.shape[2] * 4,
                                  z_q.shape[3] * 4)[0]
        return c0["mu"], c0["sigma"]

    def encode_latents(self, x: torch.Tensor, idx_rate: float,
                       frame_type: int, training: bool = False,
                       noise=None):
        """x [B, in_c, H, W] -> quantized latents, distribution parameters
        (component 0) and rate maps in bits (conditional.py:212-256).
        ``training``: the latents carry uniform noise from the noise
        source ``noise`` (ops/quantizer.py) instead of being rounded."""
        y = self._gain(self.g_a(x), idx_rate, "enc", frame_type)
        yw = self._whole(y)
        z = self.h_a(yw)
        z_q = quantize(z, AC_MAX_VAL, training=training, noise=noise)
        comps = self._pdf_components(z_q, yw.shape[2], yw.shape[3])
        y_noise = noise
        if self.band is not None:
            comps = [{k: self.band.rows(v) for k, v in c.items()}
                     for c in comps]
            y_noise = None if noise is None else BandNoise(noise, self.band)
        mu, sigma = comps[0]["mu"], comps[0]["sigma"]
        y_cq = quantize(y - mu, AC_MAX_VAL, training=training,
                        noise=y_noise)
        if len(comps) == 1:
            p_y = bin_prob(y_cq, sigma, self.cfg.pdf_family)
        else:
            p_y = mixture_bin_prob(y_cq, comps, self.cfg.pdf_family)
        return {
            "y_cq": y_cq,
            "z_q": z_q,
            "mu": mu,
            "sigma": sigma,
            "rate_y": rate_bits(p_y),
            "rate_z": rate_bits(self.pdf_z(z_q)),
        }

    def synthesize(self, y_cq: torch.Tensor, mu: torch.Tensor,
                   shortcut_in: Optional[torch.Tensor], idx_rate: float,
                   frame_type: int) -> torch.Tensor:
        y_hat = self._gain(y_cq + mu, idx_rate, "dec", frame_type)
        if shortcut_in is not None and self.cfg.in_c_shortcut > 0:
            y_shortcut = self.g_a_ref(shortcut_in)
        else:
            B, _, H, W = y_hat.shape
            y_shortcut = torch.zeros((B, self.cfg.out_c_shortcut_y, H, W),
                                     dtype=y_hat.dtype, device=y_hat.device)
        return self.g_s(torch.cat([y_hat, y_shortcut], dim=1))

    def forward(self, x: torch.Tensor, shortcut_in: Optional[torch.Tensor],
                idx_rate: float, frame_type: int, training: bool = False,
                noise=None):
        """Coding round trip -> (synthesis output, latents)
        (conditional.py:315-321)."""
        lat = self.encode_latents(x, idx_rate, frame_type, training, noise)
        out = self.synthesize(lat["y_cq"], lat["mu"], shortcut_in, idx_rate,
                              frame_type)
        return out, lat
