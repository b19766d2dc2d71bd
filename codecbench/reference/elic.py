"""Plain reference of ELIC (He et al., CVPR 2022, arXiv 2203.10886 sections
3-4; mean-scale hyperprior of Minnen et al. 2018, arXiv 1809.02736), written
from the equations in plain PyTorch, NCHW.  It imports nothing of the
program: it takes a parameter tree (nested dicts of numpy arrays, conv
kernels HWIO, transposed-conv kernels HWIO read as the conv of the same
input and output widths) and a model block (dict: n, m, groups,
ac_max_val).  Two copies, kept equal: tests/torch_elic_ref.py (the CPU
tests) and codecbench/reference/elic.py (the benchmark's judge).

    y = g_a(x);  z = h_a(y);  hyper = h_s(round(z))
    for each group k of ``groups`` (channels in order), for the anchors
    ((row + col) even), then the non-anchors:
        cc = channel context of the decoded groups < k (none for k = 0)
        sc = checkerboard-masked conv5 of group k's decoded anchors (0 in
             the anchor pass)
        mu, s = aggregation(cat(hyper, cc, sc));  sigma = max(s, 0.11)
        symbols = clip(round(y_k - mu)) at the pass's positions;
        y_hat_k = symbols + mu there
    x_hat = g_s(y_hat)

Every convolution pads with zeros.  Departures from the paper, which the
codec makes and the reference follows: 4:4:4 YUV in [0, 1] in place of
RGB (chroma repeated 2x2, the frame edge-padded to a multiple of 64);
scales bounded below by 0.11 and coded through 64 log-spaced sigma bins
(``sigma_bin``) with symbols clipped to +-ac_max_val; the context and
aggregation widths are read from the parameters (the paper's figure does
not state them); the attention's residual units add no ReLU after the
sum; the decoder adds the stream's per-plane DC offsets.

``precision``: "f32" (float32, TF32 off for cuDNN and matmuls), "tf32"
or "fp8" (inputs and weights of each convolution rounded to float8 e4m3
with a per-tensor scale).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

PAD_MULTIPLE = 64
SCALE_MIN = 0.11
FP8_MAX = 448.0
NBINS = 64
SIGMA_MIN, SIGMA_MAX = 0.05, 160.0


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


def anchor_mask(h: int, w: int, device=None) -> torch.Tensor:
    """bool [h, w]: (row + col) even."""
    r = torch.arange(h, device=device)[:, None]
    c = torch.arange(w, device=device)[None, :]
    return (r + c) % 2 == 0


def sigma_bin(sigma: torch.Tensor) -> torch.Tensor:
    """Index of sigma's bin among NBINS log-spaced centres from 0.05 to
    160, in float32: round((log sigma - log 0.05) * 63 / log(3200))."""
    lo = torch.tensor(np.float32(math.log(SIGMA_MIN)), device=sigma.device)
    sc = torch.tensor(np.float32((NBINS - 1) / (math.log(SIGMA_MAX)
                                                - math.log(SIGMA_MIN))),
                      device=sigma.device)
    t = (torch.log(torch.clamp_min(sigma.float(), 1e-9)) - lo) * sc
    return torch.clamp(torch.round(t), 0, NBINS - 1).to(torch.int32)


class RefElic:
    """ELIC's nets on ``device`` from a parameter tree."""

    def __init__(self, tree: dict, cfg: dict, device, precision="f32"):
        if precision not in ("f32", "tf32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision
        self.groups = [int(g) for g in cfg["groups"]]
        self.m = int(cfg["m"])
        self.ac_max = int(cfg.get("ac_max_val") or 256)
        self.p = self._to_device(tree, device)
        self.device = device

    @staticmethod
    def _to_device(tree, device):
        if isinstance(tree, dict):
            return {k: RefElic._to_device(v, device) for k, v in tree.items()}
        arr = np.asarray(tree, np.float32)
        if arr.ndim == 4:                       # HWIO -> OIHW
            arr = arr.transpose(3, 2, 0, 1)
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)

    # -- layers ---------------------------------------------------------
    def _operands(self, x, w):
        if self.precision == "fp8":
            return fp8_round(x), fp8_round(w)
        return x, w

    def conv(self, x, p, stride=1, mask=None):
        w = p["kernel"] if mask is None else p["kernel"] * mask
        x, w = self._operands(x, w)
        return F.conv2d(x, w, p["bias"], stride=stride,
                        padding=w.shape[-1] // 2)

    def tconv(self, x, p):
        """Transposed conv, stride 2: [B, cin, H, W] -> [B, cout, 2H, 2W]."""
        x, w = self._operands(x, p["kernel"])
        return F.conv_transpose2d(x, w.transpose(0, 1), p["bias"], stride=2,
                                  padding=w.shape[-1] // 2, output_padding=1)

    def bottleneck(self, x, p):
        h = torch.relu(self.conv(x, p["a"]))
        h = torch.relu(self.conv(h, p["b"]))
        return x + self.conv(h, p["c"])

    def attention(self, x, p):
        t = b = x
        for i in range(3):
            t = self.bottleneck(t, p[f"trunk_{i}"])
            b = self.bottleneck(b, p[f"branch_{i}"])
        return x + t * torch.sigmoid(self.conv(b, p["gate"]))

    def res3(self, x, p, first):
        for i in range(first, first + 3):
            x = self.bottleneck(x, p[f"res_{i}"])
        return x

    # -- transforms -----------------------------------------------------
    def g_a(self, x):
        p = self.p["g_a"]
        x = self.res3(self.conv(x, p["conv_0"], 2), p, 0)
        x = self.res3(self.conv(x, p["conv_1"], 2), p, 3)
        x = self.attention(x, p["att_0"])
        x = self.res3(self.conv(x, p["conv_2"], 2), p, 6)
        return self.attention(self.conv(x, p["conv_3"], 2), p["att_1"])

    def g_s(self, y):
        p = self.p["g_s"]
        x = self.attention(y, p["att_0"])
        x = self.res3(self.tconv(x, p["up_0"]), p, 0)
        x = self.attention(self.tconv(x, p["up_1"]), p["att_1"])
        x = self.res3(x, p, 3)
        x = self.res3(self.tconv(x, p["up_2"]), p, 6)
        return self.tconv(x, p["up_3"])

    def h_a(self, y):
        p = self.p["h_a"]
        h = torch.relu(self.conv(y, p["conv_0"]))
        h = torch.relu(self.conv(h, p["conv_1"], 2))
        return self.conv(h, p["conv_2"], 2)

    def h_s(self, z):
        p = self.p["h_s"]
        h = torch.relu(self.tconv(z, p["up_0"]))
        h = torch.relu(self.tconv(h, p["up_1"]))
        return self.conv(h, p["conv_0"])

    # -- the context model ------------------------------------------------
    def channel_context(self, k: int, done: List[torch.Tensor]):
        if not k:
            return None
        p = self.p[f"group_{k}"]["cc"]
        h = torch.relu(self.conv(torch.cat(done, 1), p["conv_0"]))
        h = torch.relu(self.conv(h, p["conv_1"]))
        return self.conv(h, p["conv_2"])

    def spatial_context(self, k: int, anchors):
        taps = (~anchor_mask(5, 5, anchors.device)).float()
        return self.conv(anchors, self.p[f"group_{k}"]["sc"], mask=taps)

    def params(self, k: int, hyper, cc, sc):
        """-> (mu, sigma) of group k."""
        p = self.p[f"group_{k}"]["pa"]
        h = torch.cat([hyper] + ([cc] if cc is not None else []) + [sc], 1)
        h = torch.relu(self.conv(h, p["conv_0"]))
        h = torch.relu(self.conv(h, p["conv_1"]))
        out = self.conv(h, p["conv_2"])
        g = self.groups[k]
        return out[:, :g], torch.clamp_min(out[:, g:], SCALE_MIN)

    def quantize(self, v):
        return torch.clamp(torch.round(v), -self.ac_max, self.ac_max - 1)


# ---------------------------------------------------------------------------
# Frames, cast and DC offsets
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


@torch.no_grad()
def code_frame(net: RefElic, orig, z_syms=None,
               step_syms: Optional[List[torch.Tensor]] = None) -> Dict:
    """One frame through the reference: the analysis of ``orig`` (uint8
    plane dicts [B, ...]), the hyperprior, the ten context steps and the
    synthesis.  The symbols are the reference's own roundings unless
    ``z_syms`` / ``step_syms`` (per step a float map [B, g_k, hy, wy]
    holding the step's symbols at its positions) give those of a stream,
    which then set mu and sigma and feed the synthesis.  -> {"y", "z"
    (unrounded), "zq", "steps": per step {"mask" (bool [hy, wy]), "r"
    (y_k - mu), "q" (the symbols used), "bins" (sigma bins)}, "y_hat",
    "pre_dc" (planes before DC), "dc" (the offsets of this
    reconstruction)}."""
    with arithmetic(net.precision):
        return _code_frame(net, orig, z_syms, step_syms)


def _code_frame(net: RefElic, orig, z_syms, step_syms) -> Dict:
    h, w = orig["y"].shape[1:]
    x = to_444(orig)
    y = net.g_a(x)
    z = net.h_a(y)
    zq = net.quantize(z) if z_syms is None else z_syms
    hyper = net.h_s(zq)
    anchors = anchor_mask(y.shape[2], y.shape[3], y.device)
    masks = (anchors, ~anchors)
    done, steps, c0 = [], [], 0
    for k, g in enumerate(net.groups):
        yk = y[:, c0:c0 + g]
        cc = net.channel_context(k, done)
        cur = torch.zeros_like(yk)
        for p in (0, 1):
            sc = (torch.zeros((y.shape[0], 2 * g) + y.shape[2:],
                              device=y.device) if p == 0
                  else net.spatial_context(k, cur))
            mu, sigma = net.params(k, hyper, cc, sc)
            r = yk - mu
            q = (net.quantize(r) if step_syms is None
                 else step_syms[len(steps)])
            cur = torch.where(masks[p], q + mu, cur)
            steps.append({"mask": masks[p], "r": r, "q": q,
                          "bins": sigma_bin(sigma)})
        done.append(cur)
        c0 += g
    y_hat = torch.cat(done, 1)
    pre = cast_planes(net.g_s(y_hat), h, w)
    return {"y": y, "z": z, "zq": zq, "steps": steps, "y_hat": y_hat,
            "pre_dc": pre, "dc": dc_offsets(pre, orig)}
