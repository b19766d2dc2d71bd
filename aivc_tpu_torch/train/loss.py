"""Rate-distortion loss over a GOP (counterpart of
aivc_tpu/train/loss.py:34-190):

  loss = sum_frames [ l_codec * R_codec + l_mof * R_mode + D ]

with D = MSE or 1 - MS-SSIM (plus 0.25 * MSE) on pixel-count-weighted
YUV planes, I-frame weighting, and padded frames contributing rate but
not distortion.  The GOP is walked in coding order; references are the
clipped reconstructions, through which the gradient reaches MOFNet.  In
training the latents carry uniform noise from a noise source
(ops/quantizer.py), drawn frame by frame in coding order, as JAX splits
one key per frame.

Under a row band (``model.band``, set by make_train_step over a mesh's
'spatial' axis; models/fullnet.py) every rank holds the whole frames,
the nets run on its band, and each reconstruction is gathered into the
whole frame (parallel/halo.py:gather_rows) for the references and the
distortion.  The loss and logs are then this rank's *shares*, which sum
over 'spatial' to the whole: the rate of y is the band's sum over the
whole frame's pixels; the terms every rank computes whole (the rate of
z, the distortion, MS-SSIM included) and the band means (the flow and
alpha logs and penalties) are divided by the band count.  flow_max is
the band's (the whole is the maximum over 'spatial'), psnr that of the
share of mse (the caller takes it from the summed mse).
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from aivc_tpu_torch.config import FRAME_B, FRAME_I
from aivc_tpu_torch.gop import GopStruct
from aivc_tpu_torch.ops import ties
from aivc_tpu_torch.ops.layers import x444_to_yuv420
from aivc_tpu_torch.ops.metrics import yuv_mse, yuv_msssim


def _to_yuv(x444: torch.Tensor) -> Dict[str, torch.Tensor]:
    y, u, v = x444_to_yuv420(x444)
    return {"y": y, "u": u, "v": v}


def psnr_of_mse(mse: torch.Tensor) -> torch.Tensor:
    """The psnr log of a GOP's mean mse (aivc_tpu/train/loss.py:182)."""
    return 10.0 * torch.log10(1.0 / ties.floor_at(mse, 1e-12))


def gop_rd_loss(model, frames444: List[torch.Tensor], gop: GopStruct,
                idx_rate: float, l_codec: float, l_mof: float,
                dist_loss: str = "mse", weight_i_frame_loss: float = 1.0,
                nb_pad_frame: int = 0, training: bool = False,
                flow_penalty: float = 0.0, alpha_penalty: float = 0.0,
                noise=None, batch_mean=None):
    """frames444: [B, 3, H, W] padded frames in display order.
    ``training`` needs the noise source ``noise``.  ``batch_mean`` (one
    rank's slice of a batch split over a mesh) makes MS-SSIM's means
    those of the whole batch (ops/metrics.py:msssim); every other term
    is a batch mean already, so the slices' values average to the whole
    batch's.

    Returns (loss, logs) with JAX's log keys: rate_bpp, mode_rate_bpp,
    codec_rate_bpp, mse, dist, dist_pure, psnr, flow_mag, flow_max and
    alpha_mean, each a 0-d float32 tensor."""
    if training and noise is None:
        raise ValueError("gop_rd_loss(training=True) needs a noise source")
    n = len(gop)
    B, _, H, W = frames444[0].shape
    nb_pixel = H * W
    dev = frames444[0].device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    band = getattr(model, "band", None)

    def share(t: torch.Tensor) -> torch.Tensor:
        return t if band is None else t / band.size

    recon: Dict[int, torch.Tensor] = {}
    zeros = torch.zeros_like(frames444[0])
    total_loss = zero
    logs = {k: zero for k in ("rate_bpp", "mode_rate_bpp", "codec_rate_bpp",
                              "mse", "dist", "dist_pure")}
    n_dist = n - nb_pad_frame
    flow_sum = flow_max = alpha_sum = zero
    n_inter = 0

    for spec in gop.coding_order:
        frame = frames444[spec.idx]
        prev = (recon.get(spec.prev_ref, zeros)
                if spec.prev_ref is not None else zeros)
        nxt = (recon.get(spec.next_ref, zeros)
               if spec.next_ref is not None else zeros)
        x_hat, aux = model.forward_frame(frame, prev, nxt, idx_rate,
                                         spec.frame_type, training, noise)
        if band is not None:
            x_hat = band.gather(x_hat)
        # References are pixel-range reconstructions, as at inference;
        # the distortion reads the unclipped x_hat (loss.py:73-82).
        recon[spec.idx] = ties.clip(x_hat, 0.0, 1.0)

        cod = aux["cod"]
        codec_rate = (cod["rate_y"].sum() + share(cod["rate_z"].sum())) / (
            B * nb_pixel)
        if aux["mof"] is not None:
            mof = aux["mof"]
            mode_rate = (mof["rate_y"].sum() + share(mof["rate_z"].sum())
                         ) / (B * nb_pixel)
            if spec.frame_type == FRAME_B:
                av = torch.abs(torch.cat([aux["v_prev"], aux["v_next"]],
                                         dim=1))
            else:
                av = torch.abs(aux["v_prev"])
            flow_sum = flow_sum + share(torch.mean(av))
            flow_max = torch.maximum(flow_max, torch.max(av))
            alpha_sum = alpha_sum + share(torch.mean(aux["alpha"]))
            n_inter += 1
            raw = aux["flow_raw"].float()
            if alpha_penalty > 0.0:
                total_loss = total_loss + alpha_penalty * share(torch.mean(
                    F.softplus(4.0 * raw[:, 0:1])))
            if flow_penalty > 0.0:
                total_loss = total_loss + flow_penalty * share(torch.mean(
                    ties.abs_(raw)))
        else:
            mode_rate = zero

        if spec.idx >= n - nb_pad_frame:
            dist = mse = dist_pure = zero
        else:
            yuv_hat = _to_yuv(x_hat)
            yuv_ref = _to_yuv(frame)
            mse = yuv_mse(yuv_hat, yuv_ref)
            if dist_loss == "ms_ssim":
                # The MSE anchor prices DC offsets MS-SSIM is blind to;
                # dist_pure is the un-anchored objective (loss.py:134-156).
                dist_pure = 1.0 - yuv_msssim(yuv_hat, yuv_ref,
                                             batch_mean=batch_mean)
                dist = dist_pure + 0.25 * mse
            else:
                dist = dist_pure = mse
            mse, dist, dist_pure = share(mse), share(dist), share(dist_pure)

        cur = l_codec * codec_rate + l_mof * mode_rate + dist
        if spec.frame_type == FRAME_I:
            cur = cur * weight_i_frame_loss
        total_loss = total_loss + cur

        logs["rate_bpp"] = logs["rate_bpp"] + codec_rate + mode_rate
        logs["mode_rate_bpp"] = logs["mode_rate_bpp"] + mode_rate
        logs["codec_rate_bpp"] = logs["codec_rate_bpp"] + codec_rate
        logs["mse"] = logs["mse"] + mse
        logs["dist"] = logs["dist"] + dist
        logs["dist_pure"] = logs["dist_pure"] + dist_pure

    logs = {k: v / n for k, v in logs.items()}
    if n_dist > 0:
        for k in ("mse", "dist", "dist_pure"):
            logs[k] = logs[k] * n / n_dist
    logs["psnr"] = psnr_of_mse(logs["mse"])
    logs["flow_mag"] = flow_sum / max(n_inter, 1)
    logs["flow_max"] = flow_max
    logs["alpha_mean"] = alpha_sum / max(n_inter, 1)
    return total_loss, logs
