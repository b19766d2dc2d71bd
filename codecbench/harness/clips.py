"""The held-out clip families of the program's evaluation set
(aivc_tpu_torch/eval/clips.py: wheel, bounce, zoom, glyphs, plasma,
sinusoid and the five photographic families), frozen here and written in
torch so that a clip is made on the card in milliseconds.  A family
takes the clip's first time step ``t0`` and a ``torch.Generator`` for
its film grain, both drawn from the run's seed, so every seed gives the
same families at the same size, at other moments and with other grain.
The photographs are a frozen copy of the program's held-out pool
(data/heldout_photos.npz).

A frame is float [3, H, W] in [0, 1], channel 0 luma, 1 and 2 chroma;
``to_planes`` rounds it to uint8 4:2:0 as the evaluation set does
(chroma sampled at even rows and columns).
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

DATA = Path(__file__).resolve().parents[1] / "data"


def load_photos(device) -> List[torch.Tensor]:
    """The held-out photographs as float [H, W, 3] in [0, 1]."""
    with np.load(DATA / "heldout_photos.npz") as npz:
        keys = sorted(npz.files)
        return [torch.from_numpy(npz[k].astype(np.float32) / 255.0)
                .to(device) for k in keys]


def _grid(h, w, dev):
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    return yy, xx


def _bilerp(img, sy, sx):
    """img [H, W, 3] sampled bilinearly at (sy, sx) [h, w] -> [h, w, 3]."""
    H, W, _ = img.shape
    sy = torch.clamp(sy, 0, H - 1.001)
    sx = torch.clamp(sx, 0, W - 1.001)
    iy, ix = sy.long(), sx.long()
    fy, fx = (sy - iy)[..., None], (sx - ix)[..., None]
    iy1, ix1 = torch.clamp_max(iy + 1, H - 1), torch.clamp_max(ix + 1, W - 1)
    return (img[iy, ix] * (1 - fy) * (1 - fx) + img[iy, ix1] * (1 - fy) * fx
            + img[iy1, ix] * fy * (1 - fx) + img[iy1, ix1] * fy * fx)


def _stack(frames):
    """[H, W, 3] frames -> [n, 3, H, W] clipped to [0, 1]."""
    return torch.clamp(torch.stack(frames).permute(0, 3, 1, 2), 0, 1)


def _grain(f, gen, std):
    return f + std * torch.randn(f.shape, generator=gen, device=f.device)


def wheel(n, h, w, t0, gen, photos):
    yy, xx = _grid(h, w, gen.device)
    r = torch.sqrt((yy - h / 2) ** 2 + (xx - w / 2) ** 2)
    th = torch.atan2(yy - h / 2, xx - w / 2)
    out = []
    for t in range(t0, t0 + n):
        spokes = 0.5 + 0.5 * torch.sign(torch.sin(8 * th + 0.15 * t))
        ring = 0.5 + 0.4 * torch.sin(r / 9.0 - 0.3 * t)
        out.append(torch.stack([spokes * (r < 0.45 * min(h, w)) + 0.2, ring,
                                1.0 - spokes * ring], dim=-1))
    return _stack(out)


def bounce(n, h, w, t0, gen, photos):
    rng = np.random.default_rng(4)
    dev = gen.device
    bg = torch.linspace(0.2, 0.8, w, device=dev)[None, :, None].expand(
        h, w, 3)
    boxes = [{"p": rng.uniform(0.2, 0.6, 2) * [h, w],
              "v": rng.uniform(2.0, 5.0, 2) * rng.choice([-1, 1], 2),
              "s": rng.uniform(0.08, 0.2) * min(h, w),
              "c": torch.tensor(rng.uniform(0, 1, 3), dtype=torch.float32,
                                device=dev)} for _ in range(3)]
    out = []
    for t in range(t0 + n):
        if t >= t0:
            f = bg.clone()
        for b in boxes:
            y0, x0 = b["p"]
            s = b["s"]
            if t >= t0:
                f[int(max(0, y0 - s)):int(min(h, y0 + s)),
                  int(max(0, x0 - s)):int(min(w, x0 + s))] = b["c"]
            b["p"] = b["p"] + b["v"]
            for ax, lim in ((0, h), (1, w)):
                if b["p"][ax] < s or b["p"][ax] > lim - s:
                    b["v"][ax] *= -1.0
                    b["p"][ax] = np.clip(b["p"][ax], s, lim - s)
        if t >= t0:
            out.append(f)
    return _stack(out)


def zoom(n, h, w, t0, gen, photos):
    yy, xx = _grid(h, w, gen.device)
    out = []
    for t in range(t0, t0 + n):
        sc = 1.0 / (1.0 + 0.03 * t)
        u, v = (xx - w / 2) * sc / 6.0, (yy - h / 2) * sc / 6.0
        check = 0.5 + 0.5 * torch.sign(torch.sin(u * 3.14)
                                       * torch.sin(v * 3.14))
        out.append(torch.stack([check, 0.5 + 0.3 * torch.sin(u),
                                0.5 + 0.3 * torch.cos(v)], dim=-1))
    return _stack(out)


def glyphs(n, h, w, t0, gen, photos):
    rng = np.random.default_rng(9)
    cell = 8
    gh, gw = h // cell, w + 2 * h
    grid = torch.from_numpy((rng.random((gh, gw // cell)) < 0.45)
                            .astype(np.float32)).to(gen.device)
    band = grid.repeat_interleave(cell, 0).repeat_interleave(cell, 1)[:h]
    out = []
    for t in range(t0, t0 + n):
        sl = band[:, 3 * t:3 * t + w]
        if sl.shape[1] < w:
            sl = torch.nn.functional.pad(sl, (0, w - sl.shape[1]))
        if sl.shape[0] < h:
            sl = torch.nn.functional.pad(sl, (0, 0, 0, h - sl.shape[0]))
        out.append(torch.stack([0.9 - 0.8 * sl, 0.9 - 0.8 * sl,
                                0.85 - 0.6 * sl], dim=-1))
    return _stack(out)


def plasma(n, h, w, t0, gen, photos):
    yy, xx = _grid(h, w, gen.device)
    out = []
    for t in range(t0, t0 + n):
        a = torch.sin(xx / 16.0 + 0.5 * t) + torch.sin(yy / 23.0 - 0.3 * t)
        b = torch.sin((xx + yy) / 29.0 + 0.2 * t) + torch.sin(torch.sqrt(
            (xx - w / 2) ** 2 + (yy - h / 2) ** 2) / 13.0 - 0.4 * t)
        out.append(torch.stack([0.5 + 0.25 * a, 0.5 + 0.25 * b,
                                0.5 + 0.125 * (a - b)], dim=-1))
    return _stack(out)


def sinusoid(n, h, w, t0, gen, photos):
    """The bench sinusoids (pipeline/video.py:synthetic_frames, seed 777)."""
    phase = np.random.default_rng(777).uniform(0, 6.28, size=3)
    yy, xx = _grid(h, w, gen.device)
    out = []
    for t in range(t0, t0 + n):
        y = (128 + 60 * torch.sin(xx / 37.0 + 0.12 * t + phase[0])
             + 50 * torch.cos(yy / 23.0 - 0.07 * t + phase[1])) / 255.0
        u = (128 + 30 * torch.sin((xx + yy) / 51.0 + 0.05 * t + phase[2])
             ) / 255.0
        out.append(torch.stack([y, u, 1.0 - u], dim=-1))
    return _stack(out)


def photowarp(n, h, w, t0, gen, photos):
    bg, patch_src = photos[0], photos[1 % len(photos)]
    margin = 32
    Hb, Wb, _ = bg.shape
    yy, xx = _grid(h, w, gen.device)
    ph, pw = max(16, h // 4), max(16, w // 4)
    patch = _bilerp(patch_src, *_grid(ph, pw, gen.device))
    pv = np.array([2.4, 1.7])
    ppos = np.array([h * 0.3, w * 0.25]) + pv * min(t0, n // 2)
    out = []
    for i, t in enumerate(range(t0, t0 + n)):
        zm = 1.0 + 0.002 * t
        # the photograph scaled to cover the frame with its margin
        sy = ((yy - h / 2) * zm + h / 2 + margin + 1.3 * t) * Hb / (
            h + 2 * margin + 2 * n + 2 * t0)
        sx = ((xx - w / 2) * zm + w / 2 + margin - 2.1 * t) * Wb / (
            w + 2 * margin + 3 * n + 3 * t0) + Wb / 4
        f = _bilerp(bg, sy, sx)
        py = int(np.clip(ppos[0], 0, h - ph))
        px = int(np.clip(ppos[1], 0, w - pw))
        f[py:py + ph, px:px + pw] = patch
        ppos = ppos + (pv if i < n // 2 else -pv)
        out.append(_grain(f, gen, 0.004))
    return _stack(out)


def zoomgrain(n, h, w, t0, gen, photos):
    bg = photos[2 % len(photos)]
    Hb, Wb, _ = bg.shape
    yy, xx = _grid(h, w, gen.device)
    fit = min(Hb / h, Wb / w)
    out = []
    for i in range(n):
        te = t0 + (i if i < n // 2 else n - 1 - i)
        sc = fit / (1.0 + 0.015 * te)
        f = _bilerp(bg, (yy - h / 2) * sc + Hb / 2, (xx - w / 2) * sc + Wb / 2)
        out.append(_grain(f, gen, 0.006))
    return _stack(out)


def parallax(n, h, w, t0, gen, photos):
    bg, fg = photos[-1], photos[-2]
    margin = 40
    yy, xx = _grid(h, w, gen.device)
    fb = min(bg.shape[0] / (h + 2 * margin + 4 * (t0 + n)),
             bg.shape[1] / (w + 2 * margin + 4 * (t0 + n)))
    ff = min(fg.shape[0] / (h + 2 * margin + 4 * (t0 + n)),
             fg.shape[1] / (w + 2 * margin + 4 * (t0 + n)))
    my = [h * 0.35, h * 0.6, h * 0.5]
    mx = [w * 0.4, w * 0.55, w * 0.7]
    rr = [min(h, w) * r for r in (0.22, 0.17, 0.14)]
    out = []
    for t in range(t0, t0 + n):
        b = _bilerp(bg, (yy + margin + 0.9 * t) * fb,
                    (xx + margin + 1.1 * t) * fb)
        f = _bilerp(fg, (yy + margin + 2 * n + 2 * t0 - 0.7 * t) * ff,
                    (xx + margin + 4 * n + 4 * t0 - 3.2 * t) * ff)
        m = torch.zeros((h, w), device=gen.device)
        for cy, cx, r in zip(my, mx, rr):
            d = torch.sqrt((yy - cy + 0.7 * t) ** 2 + (xx - cx + 3.2 * t) ** 2)
            m = torch.maximum(m, torch.clamp(1.6 - d / r, 0, 1))
        m = torch.clamp_max(m, 1.0)[..., None]
        out.append(_grain(f * m + b * (1 - m), gen, 0.004))
    return _stack(out)


def rotpan(n, h, w, t0, gen, photos):
    img = photos[len(photos) // 2]
    Hb, Wb, _ = img.shape
    yy, xx = _grid(h, w, gen.device)
    fit = 0.7 * min(Hb / h, Wb / w)
    out = []
    for t in range(t0, t0 + n):
        ang = 0.007 * t
        ca, sa = math.cos(ang), math.sin(ang)
        cy, cx = Hb / 2.0 + 0.8 * t, Wb / 2.0 - 0.6 * t
        dy, dx = (yy - h / 2) * fit, (xx - w / 2) * fit
        f = _bilerp(img, ca * dy - sa * dx + cy, sa * dy + ca * dx + cx)
        out.append(_grain(f, gen, 0.004))
    return _stack(out)


def staticcam(n, h, w, t0, gen, photos):
    img = photos[2 % len(photos)]
    Hb, Wb, _ = img.shape
    yy, xx = _grid(h, w, gen.device)
    fit = min(Hb / h, Wb / w)
    crop = _bilerp(img, yy * fit, xx * fit)
    return _stack([_grain(crop, gen, 0.003) for _ in range(n)])


FAMILIES = {f.__name__: f for f in (wheel, bounce, zoom, glyphs, plasma,
                                    sinusoid, photowarp, zoomgrain, parallax,
                                    rotpan, staticcam)}


def to_planes(clip: torch.Tensor) -> Dict[str, np.ndarray]:
    """[n, 3, H, W] float -> host uint8 planes {"y": [n, H, W], "u", "v":
    [n, ceil(H/2), ceil(W/2)]}."""
    q = torch.clamp(torch.round(clip * 255), 0, 255).to(torch.uint8)
    return {"y": q[:, 0].cpu().numpy(), "u": q[:, 1, ::2, ::2].cpu().numpy(),
            "v": q[:, 2, ::2, ::2].cpu().numpy()}


def frames_of(planes: Dict[str, np.ndarray]) -> List[Dict[str, np.ndarray]]:
    """Clip planes -> the list of per-frame plane dicts the codec takes."""
    return [{k: planes[k][i] for k in ("y", "u", "v")}
            for i in range(planes["y"].shape[0])]
