"""Held-out evaluation clips: the port's copy of scripts/eval_data.py
(its 11 ``FAMILIES`` and ``heldout_clips``), byte for byte the same
frames for the same (name, n_frames, h, w).

The families lie outside what the training clip generator produces
(train/data.py): a rotating wheel, bouncing squares that reverse, a fast
zoom, scrolling glyphs, plasma, the bench sinusoids, and five
natural-composite families over the held-out photographs
(eval/photos.py:heldout_pool, disjoint from the training pool).

One departure: where the reference falls back to a synthetic family when
its photographs are missing (``_photowarp`` and ``_staticcam`` to
plasma, ``_zoomgrain`` to zoom, ``_parallax`` to bounce, ``_rotpan`` to
wheel), a photo family here raises if the pool is short.  A clip that
silently changed family would be compared with a pin made on the other
one.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from aivc_tpu_torch.eval.photos import heldout_pool
from aivc_tpu_torch.pipeline.video import synthetic_frames


def _photos(need: int, family: str) -> List[np.ndarray]:
    """The held-out pool, which must hold at least ``need`` photographs."""
    pool = heldout_pool()
    if len(pool) < need:
        raise ValueError(f"{family} needs {need} held-out photographs, the "
                         f"pool has {len(pool)}")
    return pool


def _to_yuv(rgbish: np.ndarray) -> Dict[str, np.ndarray]:
    """[H, W, 3] float [0,1] -> YUV420 uint8 frame dict (channel 0 = Y)."""
    h, w, _ = rgbish.shape
    y = np.clip(np.round(rgbish[..., 0] * 255), 0, 255).astype(np.uint8)
    u = np.clip(np.round(rgbish[::2, ::2, 1] * 255), 0, 255).astype(np.uint8)
    v = np.clip(np.round(rgbish[::2, ::2, 2] * 255), 0, 255).astype(np.uint8)
    return {"y": y, "u": u[: (h + 1) // 2, : (w + 1) // 2],
            "v": v[: (h + 1) // 2, : (w + 1) // 2]}


def _wheel(n, h, w):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cy, cx = h / 2.0, w / 2.0
    r = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
    th = np.arctan2(yy - cy, xx - cx)
    out = []
    for t in range(n):
        spokes = 0.5 + 0.5 * np.sign(np.sin(8 * th + 0.15 * t))
        ring = 0.5 + 0.4 * np.sin(r / 9.0 - 0.3 * t)
        f = np.stack([spokes * (r < 0.45 * min(h, w)) + 0.2,
                      ring, 1.0 - spokes * ring], axis=-1)
        out.append(_to_yuv(np.clip(f, 0, 1)))
    return out


def _bounce(n, h, w):
    rng = np.random.default_rng(4)
    bg = np.linspace(0.2, 0.8, w, dtype=np.float32)[None, :, None]
    bg = np.repeat(np.repeat(bg, h, axis=0), 3, axis=2)
    boxes = [{"p": rng.uniform(0.2, 0.6, 2) * [h, w],
              "v": rng.uniform(2.0, 5.0, 2) * rng.choice([-1, 1], 2),
              "s": rng.uniform(0.08, 0.2) * min(h, w),
              "c": rng.uniform(0, 1, 3)} for _ in range(3)]
    out = []
    for _t in range(n):
        f = bg.copy()
        for b in boxes:
            y0, x0 = b["p"]
            s = b["s"]
            ys, xs = int(max(0, y0 - s)), int(max(0, x0 - s))
            ye, xe = int(min(h, y0 + s)), int(min(w, x0 + s))
            f[ys:ye, xs:xe] = b["c"]
            b["p"] += b["v"]
            for ax, lim in ((0, h), (1, w)):
                if b["p"][ax] < s or b["p"][ax] > lim - s:
                    b["v"][ax] *= -1.0
                    b["p"][ax] = np.clip(b["p"][ax], s, lim - s)
        out.append(_to_yuv(f))
    return out


def _zoom(n, h, w):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cy, cx = h / 2.0, w / 2.0
    out = []
    for t in range(n):
        sc = 1.0 / (1.0 + 0.03 * t)  # ~8x training's zoom rate
        u = (xx - cx) * sc / 6.0
        v = (yy - cy) * sc / 6.0
        check = 0.5 + 0.5 * np.sign(np.sin(u * 3.14) * np.sin(v * 3.14))
        f = np.stack([check, 0.5 + 0.3 * np.sin(u),
                      0.5 + 0.3 * np.cos(v)], axis=-1)
        out.append(_to_yuv(np.clip(f, 0, 1)))
    return out


def _glyphs(n, h, w):
    rng = np.random.default_rng(9)
    cell = 8
    gh, gw = h // cell, w + 2 * h  # wide band that scrolls horizontally
    grid = (rng.random((gh, gw // cell)) < 0.45).astype(np.float32)
    band = np.kron(grid, np.ones((cell, cell), np.float32))[:h]
    out = []
    for t in range(n):
        off = 3 * t
        sl = band[:, off:off + w]
        if sl.shape[1] < w:
            sl = np.pad(sl, ((0, 0), (0, w - sl.shape[1])))
        f = np.stack([0.9 - 0.8 * sl, 0.9 - 0.8 * sl, 0.85 - 0.6 * sl],
                     axis=-1)
        out.append(_to_yuv(f[:h, :w]))
    return out


def _plasma(n, h, w):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for t in range(n):
        a = np.sin(xx / 16.0 + 0.5 * t) + np.sin(yy / 23.0 - 0.3 * t)
        b = np.sin((xx + yy) / 29.0 + 0.2 * t) + np.sin(
            np.sqrt((xx - w / 2) ** 2 + (yy - h / 2) ** 2) / 13.0 - 0.4 * t)
        f = np.stack([0.5 + 0.25 * a, 0.5 + 0.25 * b,
                      0.5 + 0.125 * (a - b)], axis=-1)
        out.append(_to_yuv(np.clip(f, 0, 1)))
    return out


def _sinusoid(n, h, w):
    return synthetic_frames(n, h, w, seed=777)


def _photowarp(n, h, w):
    """Natural-composite family: HELD-OUT photographic textures (disjoint
    from every training texture) under global affine pan/zoom with a
    locally-moving photographic patch that reverses velocity mid-clip,
    plus film grain.  Results on it are not comparable to CLIC21/HEVC
    numbers."""
    pool = _photos(1, "photowarp")
    rng = np.random.default_rng(1234)
    bg = pool[0]
    patch_src = pool[1 % len(pool)]
    margin = 32
    # background crop large enough to pan inside
    Hb, Wb, _ = bg.shape
    ch, cw = min(Hb, h + 2 * margin), min(Wb, w + 2 * margin)
    y0 = (Hb - ch) // 2
    x0 = (Wb - cw) // 2
    bgc = bg[y0:y0 + ch, x0:x0 + cw]
    ph, pw = max(16, h // 4), max(16, w // 4)
    patch = patch_src[:ph, :pw]
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    vy, vx = 1.3, -2.1          # global pan
    pv = np.array([2.4, 1.7])   # patch velocity (reverses at n // 2)
    ppos = np.array([h * 0.3, w * 0.25])
    out = []
    for t in range(n):
        zoom = 1.0 + 0.002 * t
        sy = np.clip((yy - h / 2) * zoom + h / 2 + margin + vy * t,
                     0, ch - 1.001)
        sx = np.clip((xx - w / 2) * zoom + w / 2 + margin + vx * t,
                     0, cw - 1.001)
        iy, ix = sy.astype(np.int32), sx.astype(np.int32)
        fy, fx = (sy - iy)[..., None], (sx - ix)[..., None]
        iy1 = np.minimum(iy + 1, ch - 1)
        ix1 = np.minimum(ix + 1, cw - 1)
        f = (bgc[iy, ix] * (1 - fy) * (1 - fx) + bgc[iy, ix1] * (1 - fy) * fx
             + bgc[iy1, ix] * fy * (1 - fx) + bgc[iy1, ix1] * fy * fx)
        py = int(np.clip(ppos[0], 0, h - ph))
        px = int(np.clip(ppos[1], 0, w - pw))
        f[py:py + ph, px:px + pw] = patch
        step = pv if t < n // 2 else -pv
        ppos = ppos + step
        f = f + rng.normal(scale=0.004, size=f.shape)
        out.append(_to_yuv(np.clip(f, 0, 1).astype(np.float32)))
    return out


def _zoomgrain(n, h, w):
    """Second natural-composite family: a reversing ZOOM on a HELD-OUT
    photographic texture under film grain — training zooms are tiny
    (+-0.004/frame) and never reverse, and the zoom eval family is a
    synthetic checkerboard.  Textures come only from the held-out
    pool."""
    pool = _photos(3, "zoomgrain")
    rng = np.random.default_rng(4321)
    bg = pool[2]
    Hb, Wb, _ = bg.shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cy, cx = Hb / 2.0, Wb / 2.0
    out = []
    for t in range(n):
        te = t if t < n // 2 else (n - 1 - t)        # zoom in, then back
        sc = 1.0 / (1.0 + 0.015 * te)
        sy = np.clip((yy - h / 2) * sc + cy, 0, Hb - 1.001)
        sx = np.clip((xx - w / 2) * sc + cx, 0, Wb - 1.001)
        iy, ix = sy.astype(np.int32), sx.astype(np.int32)
        fy, fx = (sy - iy)[..., None], (sx - ix)[..., None]
        iy1 = np.minimum(iy + 1, Hb - 1)
        ix1 = np.minimum(ix + 1, Wb - 1)
        f = (bg[iy, ix] * (1 - fy) * (1 - fx) + bg[iy, ix1] * (1 - fy) * fx
             + bg[iy1, ix] * fy * (1 - fx) + bg[iy1, ix1] * fy * fx)
        f = f + rng.normal(scale=0.006, size=f.shape)
        out.append(_to_yuv(np.clip(f, 0, 1).astype(np.float32)))
    return out


def _bilerp(img, sy, sx):
    """Bilinear sample img [H, W, 3] at float coords (sy, sx) [h, w]."""
    H, W, _ = img.shape
    sy = np.clip(sy, 0, H - 1.001)
    sx = np.clip(sx, 0, W - 1.001)
    iy, ix = sy.astype(np.int32), sx.astype(np.int32)
    fy, fx = (sy - iy)[..., None], (sx - ix)[..., None]
    iy1 = np.minimum(iy + 1, H - 1)
    ix1 = np.minimum(ix + 1, W - 1)
    return (img[iy, ix] * (1 - fy) * (1 - fx) + img[iy, ix1] * (1 - fy) * fx
            + img[iy1, ix] * fy * (1 - fx) + img[iy1, ix1] * fy * fx)


def _parallax(n, h, w):
    """Third natural-composite family: two HELD-OUT photographic layers
    panning at different velocities with an irregular foreground mask —
    every frame DISOCCLUDES background content no reference frame fully
    shows, the motion class hierarchical-B codecs find hardest (neither
    warp can synthesize revealed pixels; alpha must hand them to the
    conditional coder).  No training clip has occlusion layers."""
    pool = _photos(2, "parallax")
    rng = np.random.default_rng(9876)
    bg, fg = pool[-1], pool[-2]
    margin = 40
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    # irregular foreground mask: soft union of blobs, fixed in fg space
    my = h * np.array([0.35, 0.6, 0.5])
    mx = w * np.array([0.4, 0.55, 0.7])
    rr = min(h, w) * np.array([0.22, 0.17, 0.14])
    out = []
    for t in range(n):
        b = _bilerp(bg, yy + margin + 0.9 * t, xx + margin + 1.1 * t)
        f = _bilerp(fg, yy + margin - 0.7 * t, xx + margin - 3.2 * t)
        m = np.zeros((h, w), np.float32)
        for cy, cx, r in zip(my, mx, rr):
            d2 = ((yy - cy + 0.7 * t) ** 2 + (xx - cx + 3.2 * t) ** 2)
            m = np.maximum(m, np.clip(1.6 - np.sqrt(d2) / r, 0, 1))
        m = np.minimum(m, 1.0)[..., None]
        fr = f * m + b * (1 - m)
        fr = fr + rng.normal(scale=0.004, size=fr.shape)
        out.append(_to_yuv(np.clip(fr, 0, 1).astype(np.float32)))
    return out


def _rotpan(n, h, w):
    """Fourth natural-composite family: slow ROTATION about a moving
    center over a HELD-OUT photograph — rotational flow is nowhere in
    the training generator (pans and zooms only) and cannot be matched
    by a single global translation, so the flow field must vary
    per-pixel."""
    pool = _photos(1, "rotpan")
    rng = np.random.default_rng(6543)
    img = pool[len(pool) // 2]
    Hb, Wb, _ = img.shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for t in range(n):
        ang = 0.007 * t                      # ~0.4 deg/frame
        ca, sa = np.cos(ang), np.sin(ang)
        cy, cx = Hb / 2.0 + 0.8 * t, Wb / 2.0 - 0.6 * t
        dy, dx = yy - h / 2, xx - w / 2
        fr = _bilerp(img, ca * dy - sa * dx + cy, sa * dy + ca * dx + cx)
        fr = fr + rng.normal(scale=0.004, size=fr.shape)
        out.append(_to_yuv(np.clip(fr, 0, 1).astype(np.float32)))
    return out


def _staticcam(n, h, w):
    """Static-camera family (the skip/coding-mode capability check).  A HELD-OUT photographic scene with NO motion at all and
    mild per-frame sensor noise — the content where the reference's
    per-pixel skip mode pays: x_warp reconstructs the scene for free and
    only the noise (or nothing) needs coding."""
    pool = _photos(1, "staticcam")
    rng = np.random.default_rng(4321)
    img = pool[2 % len(pool)]
    Hb, Wb, _ = img.shape
    y0, x0 = max(0, (Hb - h) // 2), max(0, (Wb - w) // 2)
    crop = img[y0:y0 + h, x0:x0 + w]
    if crop.shape[:2] != (h, w):  # photo smaller than target: tile
        crop = np.tile(crop, (h // crop.shape[0] + 1,
                              w // crop.shape[1] + 1, 1))[:h, :w]
    out = []
    for _ in range(n):
        f = crop + rng.normal(scale=0.003, size=crop.shape)
        out.append(_to_yuv(np.clip(f, 0, 1).astype(np.float32)))
    return out


FAMILIES = {
    "wheel": _wheel,
    "bounce": _bounce,
    "zoom": _zoom,
    "glyphs": _glyphs,
    "plasma": _plasma,
    "sinusoid": _sinusoid,
    "photowarp": _photowarp,
    "zoomgrain": _zoomgrain,
    "parallax": _parallax,
    "rotpan": _rotpan,
    "staticcam": _staticcam,
}


def heldout_clips(n_frames: int, h: int, w: int,
                  names=None) -> List[List[Dict[str, np.ndarray]]]:
    names = names or list(FAMILIES)
    return [FAMILIES[nm](n_frames, h, w) for nm in names]
