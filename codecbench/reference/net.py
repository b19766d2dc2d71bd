"""Plain reference of the codec: MOFNet + motion compensation + CodecNet
with hyperpriors, as the AIVC papers describe it (arXiv 2202.04365) and
as the checkpoint's tree lays it out, written from the equations in
plain PyTorch, NCHW, float32.  It imports nothing of the program and
takes nothing the program made: the weights come from the checkpoint's
raw file (reference/msgpack.py), the tables and the references are
worked out here.

    analysis:   y = g_a(x) * gain_enc;  z = h_a(|y|)
    hyper:      mu, log-var = h_s(round(z));  sigma = exp(log-var / 2)
    latents:    y_q = clip(round(y - mu))
    synthesis:  x_hat = g_s(cat((y_q + mu) * gain_dec, g_a_ref(shortcut)))
    motion:     maps = MOFNet's synthesis -> alpha, beta, flows;
                x_warp = beta * warp(prev, v_prev) + (1 - beta) *
                warp(next, v_next);  pred = alpha * x_warp;
                CodecNet codes cat(frame, pred) with the shortcut pred
                and adds skip = (1 - alpha) * x_warp
    frame:      uint8 YUV 4:2:0 in and out; the decoder adds the
                stream's per-plane DC offsets

``precision`` picks the arithmetic of every convolution: "f32" (full
float32, TF32 off), "tf32" (TF32 on: the control of a float32
configuration) or "fp8" (inputs and weights of each convolution rounded
to float8 e4m3 with a per-tensor scale: the control of a bfloat16
configuration).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

FRAME_I, FRAME_P, FRAME_B = 0, 1, 2
LOG_VAR_MIN, LOG_VAR_MAX = -18.4207, 10.0
PAD_MULTIPLE = 64
REPARAM_OFFSET = 2.0 ** -18
PEDESTAL = REPARAM_OFFSET ** 2
BETA_MIN = 1e-6
FP8_MAX = 448.0


@contextlib.contextmanager
def arithmetic(precision: str):
    """TF32 on for "tf32", off otherwise, restored on exit."""
    keep = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    on = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = keep


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale (amax -> 448)."""
    amax = float(x.abs().max())
    if amax == 0.0 or not math.isfinite(amax):
        return x
    s = amax / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class RefNet:
    """The two conditional autoencoders of one checkpoint on ``device``."""

    def __init__(self, tree: dict, cfg: dict, device, precision="f32"):
        if precision not in ("f32", "tf32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.cfg = cfg
        self.precision = precision
        self.ac_max = int(cfg.get("ac_max_val") or 256)
        self.flow_bound = float(cfg.get("flow_bound") or 0.0)
        self.p = self._to_device(tree, device)
        self.device = device

    @staticmethod
    def _to_device(tree, device):
        if isinstance(tree, dict):
            return {k: RefNet._to_device(v, device) for k, v in tree.items()}
        arr = np.asarray(tree, np.float32)
        if arr.ndim == 4:                       # HWIO -> OIHW
            arr = arr.transpose(3, 2, 0, 1)
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)

    # -- layers ---------------------------------------------------------
    def conv(self, x, p, stride=1):
        w, b = p["kernel"], p["bias"]
        pad = w.shape[-1] // 2
        if pad:
            x = F.pad(x, (pad, pad, pad, pad), mode="replicate")
        if self.precision == "fp8":
            x, w = fp8_round(x), fp8_round(w)
        return F.conv2d(x, w, b, stride=stride)

    @staticmethod
    def gdn(x, p, inverse):
        beta = torch.clamp_min(p["beta"], (BETA_MIN + PEDESTAL) ** 0.5) ** 2
        gamma = torch.clamp_min(p["gamma"], REPARAM_OFFSET) ** 2 - PEDESTAL
        beta = beta - PEDESTAL
        # norm_i = sqrt(beta_i + sum_j gamma[i, j] x_j^2)
        norm = torch.einsum("ij,bjhw->bihw", gamma, x * x)
        norm = torch.sqrt(norm + beta.view(1, -1, 1, 1))
        return x * norm if inverse else x / norm

    @staticmethod
    def depth_to_space(x):
        """[B, 4C, H, W] with channel (i * 2 + j) * C + c -> [B, C, 2H, 2W]
        (the checkpoint's channel order)."""
        B, C4, H, W = x.shape
        C = C4 // 4
        x = x.view(B, 2, 2, C, H, W).permute(0, 3, 4, 1, 5, 2)
        return x.reshape(B, C, 2 * H, 2 * W)

    def conv_block(self, x, p, stride, nl):
        x = self.conv(x, p["Conv_0"], stride)
        if "GDN_0" in p:
            return self.gdn(x, p["GDN_0"], inverse=False)
        return F.leaky_relu(x, 0.01) if nl == "leaky" else x

    def up_block(self, x, p, nl):
        x = self.depth_to_space(self.conv(x, p["Conv_0"]))
        if "GDN_0" in p:
            return self.gdn(x, p["GDN_0"], inverse=True)
        return F.leaky_relu(x, 0.01) if nl == "leaky" else x

    def res_block(self, x, p):
        h = torch.relu(self.conv(x, p["ConvBlock_0"]["Conv_0"]))
        return torch.relu(x + self.conv(h, p["ConvBlock_1"]["Conv_0"]))

    def attention(self, x, p):
        trunk = x
        for i in range(3):
            trunk = self.res_block(trunk, p[f"ResBlock_{i}"])
        att = x
        for i in range(3, 6):
            att = self.res_block(att, p[f"ResBlock_{i}"])
        return trunk * torch.sigmoid(self.conv(att, p["Conv_0"])) + x

    def g_a(self, x, p):
        x = self.conv_block(x, p["ConvBlock_0"], 2, "gdn")
        x = self.conv_block(x, p["ConvBlock_1"], 2, "gdn")
        if "SimplifiedAttention_0" in p:
            x = self.attention(x, p["SimplifiedAttention_0"])
        x = self.conv_block(x, p["ConvBlock_2"], 2, "gdn")
        return self.conv_block(x, p["ConvBlock_3"], 2, "no")

    def g_s(self, y, p):
        y = self.up_block(y, p["UpBlock_0"], "gdn")
        if "SimplifiedAttention_0" in p:
            y = self.attention(y, p["SimplifiedAttention_0"])
        for i in (1, 2, 3):
            y = self.up_block(y, p[f"UpBlock_{i}"], "gdn")
        return y

    def h_a(self, y, p):
        y = self.conv_block(torch.abs(y), p["ConvBlock_0"], 1, "leaky")
        y = self.conv_block(y, p["ConvBlock_1"], 2, "leaky")
        return self.conv_block(y, p["ConvBlock_2"], 2, "no")

    def h_s(self, z, p):
        z = self.up_block(z, p["UpBlock_0"], "leaky")
        z = self.up_block(z, p["UpBlock_1"], "leaky")
        return self.conv_block(z, p["ConvBlock_0"], 1, "no")

    @staticmethod
    def gain(p, frame_type: int, idx_rate: float, mode: str):
        """The gain vector of ``mode`` ("enc" | "dec") at idx_rate:
        |m_r|^l * |m_r+1|^(1 - l) between the two trained rows."""
        name = {FRAME_I: "gain_I", FRAME_P: "gain_P", FRAME_B: "gain_B"}
        key = name[frame_type] if name[frame_type] in p else "gain_I"
        m = torch.abs(p[key][f"{mode}_gain"])
        n = m.shape[0]
        idx = min(max(float(idx_rate), 0.0), float(n - 1))
        lo = int(math.floor(idx))
        hi = min(lo + 1, n - 1)
        l = 1.0 - (idx - lo)
        return (m[lo] ** l * m[hi] ** (1.0 - l)).view(1, -1, 1, 1)

    # -- stages ---------------------------------------------------------
    def analyze(self, net: str, x, frame_type: int, idx_rate: float):
        """-> (gained y, z before rounding)."""
        p = self.p[net]
        y = self.g_a(x, p["g_a"]) * self.gain(p, frame_type, idx_rate, "enc")
        return y, self.h_a(y, p["h_a"])

    def hyper(self, net: str, z_sym):
        """Integer z -> (mu, sigma) on the y grid."""
        p = self.p[net]
        h = self.h_s(z_sym, p["h_s"])
        c = self.cfg[net]["nb_ft_y"]
        mu = h[:, :c]
        sigma = torch.exp(0.5 * torch.clamp(h[:, c:2 * c], LOG_VAR_MIN,
                                            LOG_VAR_MAX))
        hy, wy = z_sym.shape[2] * 4, z_sym.shape[3] * 4
        return mu[:, :, :hy, :wy], sigma[:, :, :hy, :wy]

    def synthesize(self, net: str, y_sym, mu, shortcut, frame_type: int,
                   idx_rate: float):
        p = self.p[net]
        c = self.cfg[net]
        y_hat = (y_sym + mu) * self.gain(p, frame_type, idx_rate, "dec")
        if shortcut is not None and c["in_c_shortcut"] > 0:
            ys = self.g_a(shortcut, p["g_a_ref"])
        else:
            B, _, H, W = y_hat.shape
            ys = torch.zeros((B, c["out_c_shortcut_y"], H, W),
                             dtype=y_hat.dtype, device=y_hat.device)
        return self.g_s(torch.cat([y_hat, ys], dim=1), p["g_s"])

    def maps(self, m, frame_type: int):
        """MOFNet output [B, 6, H, W] -> alpha, beta, v_prev, v_next."""
        if self.flow_bound > 0.0:
            alpha = torch.sigmoid(4.0 * m[:, 0:1])
            beta = torch.sigmoid(4.0 * m[:, 1:2])
            vp = m[:, 2:4] / (1.0 + torch.abs(m[:, 2:4]) / self.flow_bound)
            vn = m[:, 4:6] / (1.0 + torch.abs(m[:, 4:6]) / self.flow_bound)
        else:
            alpha = torch.clamp(m[:, 0:1] + 0.5, 0.0, 1.0)
            beta = torch.clamp(m[:, 1:2] + 0.5, 0.0, 1.0)
            vp, vn = m[:, 2:4], m[:, 4:6]
        if frame_type == FRAME_P:
            beta = torch.ones_like(beta)
            vn = torch.zeros_like(vn)
        return alpha, beta, vp, vn

    def quantize(self, v):
        return torch.clamp(torch.round(v), -self.ac_max, self.ac_max - 1)


# ---------------------------------------------------------------------------
# Frames, warp, cast and DC offsets
# ---------------------------------------------------------------------------

def _pad_edge(x, mult):
    ph, pw = (-x.shape[2]) % mult, (-x.shape[3]) % mult
    if ph or pw:
        x = F.pad(x, (0, pw, 0, ph), mode="replicate")
    return x


def to_444(planes: Dict[str, torch.Tensor]) -> torch.Tensor:
    """uint8 planes [B, H, W] / [B, ceil(H/2), ceil(W/2)] -> float 4:4:4
    [B, 3, Hp, Wp] in [0, 1], edge-padded to a multiple of 64, chroma
    repeated 2x2."""
    y = _pad_edge(planes["y"][:, None].float() / 255.0, PAD_MULTIPLE)
    uv = [_pad_edge(planes[k][:, None].float() / 255.0, PAD_MULTIPLE // 2)
          for k in ("u", "v")]
    H, W = y.shape[2:]
    uv = torch.cat(uv, dim=1).repeat_interleave(2, 2).repeat_interleave(2, 3)
    return torch.cat([y, uv[:, :, :H, :W]], dim=1)


def warp(ref444: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Backward bilinear warp of the 8-bit frame ``ref444`` [B, 3, H, W]
    by the flows u (horizontal), v (vertical) [B, H, W], source positions
    clamped to the frame."""
    B, C, H, W = ref444.shape
    dev = ref444.device
    xx = torch.arange(W, dtype=torch.float32, device=dev).view(1, 1, W)
    yy = torch.arange(H, dtype=torch.float32, device=dev).view(1, H, 1)
    sx = torch.clamp(xx + u, 0.0, W - 1.0)
    sy = torch.clamp(yy + v, 0.0, H - 1.0)
    x0, y0 = torch.floor(sx), torch.floor(sy)
    wx, wy = (sx - x0)[:, None], (sy - y0)[:, None]
    x0, y0 = x0.long(), y0.long()
    x1, y1 = torch.clamp_max(x0 + 1, W - 1), torch.clamp_max(y0 + 1, H - 1)
    levels = torch.round(ref444 * 255.0).reshape(B, C, H * W)

    def at(yi, xi):
        idx = (yi * W + xi).reshape(B, 1, H * W).expand(B, C, H * W)
        return torch.gather(levels, 2, idx).reshape(B, C, H, W) / 255.0

    top = at(y0, x0) + (at(y0, x1) - at(y0, x0)) * wx
    bot = at(y1, x0) + (at(y1, x1) - at(y1, x0)) * wx
    return top + (bot - top) * wy


def cast_planes(x444: torch.Tensor, h: int, w: int) -> Dict[str, torch.Tensor]:
    """float 4:4:4 -> uint8 4:2:0 planes cropped to h x w (chroma by 2x2
    means)."""
    B, _, H, W = x444.shape
    uv = x444[:, 1:3].reshape(B, 2, H // 2, 2, W // 2, 2).mean(dim=(3, 5))

    def q(p):
        return torch.clamp(torch.round(torch.clamp(p, 0.0, 1.0) * 255.0),
                           0, 255).to(torch.uint8)

    hc, wc = (h + 1) // 2, (w + 1) // 2
    return {"y": q(x444[:, 0])[:, :h, :w], "u": q(uv[:, 0])[:, :hc, :wc],
            "v": q(uv[:, 1])[:, :hc, :wc]}


def apply_dc(planes, dc: torch.Tensor):
    """Per-plane offsets dc [B, 3] added with saturation."""
    return {k: torch.clamp(planes[k].to(torch.int32) + dc[:, i, None, None],
                           0, 255).to(torch.uint8)
            for i, k in enumerate(("y", "u", "v"))}


def measure_dc(planes, orig) -> torch.Tensor:
    """round(mean(orig) - mean(planes)) per plane, [B, 3] int32."""
    out = []
    for k in ("y", "u", "v"):
        d = (orig[k].to(torch.int64).sum(dim=(1, 2))
             - planes[k].to(torch.int64).sum(dim=(1, 2)))
        n = planes[k].shape[1] * planes[k].shape[2]
        out.append(torch.round(d.to(torch.float32) / n).to(torch.int32))
    return torch.stack(out, dim=1)


def dc_offsets(planes, orig) -> torch.Tensor:
    """The encoder's DC offsets: measured, applied, measured again; the
    sum clamped to +-127."""
    dc1 = measure_dc(planes, orig)
    once = apply_dc(planes, torch.clamp(dc1, -127, 127))
    return torch.clamp(dc1 + measure_dc(once, orig), -127, 127)


def encode_frame(net: RefNet, orig, prev: Optional[dict], nxt: Optional[dict],
                 frame_type: int, idx_rate: float, z_syms=None, y_syms=None):
    """One frame through the reference: the analysis of ``orig`` given the
    decoded references ``prev`` / ``nxt`` (uint8 plane dicts [1, ...]),
    then the synthesis.

    The latents synthesised are the reference's own roundings unless
    ``z_syms`` / ``y_syms`` ({"mofnet": ..., "codecnet": ...}) give the
    symbols a stream carries, which then set mu and feed the synthesis
    (the reference judging a stream).  Returns a dict: per net the
    unrounded z and y - mu ("z", "r"), the symbols used ("zq", "yq"), the
    reconstruction before DC ("pre_dc") and the DC offsets of the
    reference's own reconstruction ("dc")."""
    h, w = orig["y"].shape[1:]
    x = to_444(orig)
    out = {}

    def code(net_name, inp, shortcut):
        y, z = net.analyze(net_name, inp, frame_type, idx_rate)
        zq = (net.quantize(z) if z_syms is None else z_syms[net_name])
        mu, _ = net.hyper(net_name, zq)
        r = y - mu
        yq = net.quantize(r) if y_syms is None else y_syms[net_name]
        out[net_name] = {"z": z, "zq": zq, "r": r, "yq": yq}
        return net.synthesize(net_name, yq, mu, shortcut, frame_type,
                              idx_rate)

    if frame_type == FRAME_I:
        pred = skip = torch.zeros_like(x)
        shortcut = None
    else:
        p444 = to_444(prev)
        n444 = to_444(nxt) if nxt is not None else torch.zeros_like(p444)
        mof_sc = torch.cat([p444, n444], 1) if frame_type == FRAME_B else None
        m = code("mofnet", torch.cat([x, p444, n444], 1), mof_sc)
        alpha, beta, vp, vn = net.maps(m, frame_type)
        x_warp = warp(p444, vp[:, 0], vp[:, 1])
        if frame_type == FRAME_B:
            x_warp = beta * x_warp + (1.0 - beta) * warp(n444, vn[:, 0],
                                                         vn[:, 1])
        pred, skip = alpha * x_warp, (1.0 - alpha) * x_warp
        shortcut = pred
    x_hat = code("codecnet", torch.cat([x, pred], 1), shortcut) + skip
    out["pre_dc"] = cast_planes(x_hat, h, w)
    out["dc"] = dc_offsets(out["pre_dc"], orig)
    return out
