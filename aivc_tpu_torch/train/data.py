"""Synthetic training clips (the port's copy of the clip generator of
scripts/train_toy.py:33-273): procedurally generated moving textures,
pure numpy, driven by one ``np.random.Generator``, so the same seed gives
the same clips as the JAX package's generator.

The natural-photo family crops photographs: the training half of the
reference's photo pool (scripts/photo_pool.py:train_pool: sklearn's
sample images, matplotlib's grace_hopper and the material textures of
simulation-asset packages), which the port reads from its committed
pool file (``photo_pool`` -> eval/photos.py:train_pool), so the card's
machine draws the family as the host does.  The generator takes the pool
as an argument and the training entry point prints its size.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from aivc_tpu_torch.eval.photos import train_pool


def photo_pool() -> List[np.ndarray]:
    """The training photographs, float32 RGB in [0, 1], in
    scripts/photo_pool.py:train_pool's order (eval/photos.py; raises if
    the committed pool file is missing or damaged)."""
    return train_pool()


def _texture_1f(rng: np.random.Generator, s2: int):
    """One static RGB texture [s2, s2, 3]: 1/f-ish filtered noise,
    per-channel correlated like natural images."""
    # spectral shaping: white noise -> 1/f amplitude falloff
    noise = rng.normal(size=(s2, s2))
    f = np.fft.fftfreq(s2)
    rad = np.sqrt(f[:, None] ** 2 + f[None, :] ** 2) + 1.0 / s2
    spec = np.fft.fft2(noise) / (rad ** rng.uniform(0.8, 1.6))
    luma = np.real(np.fft.ifft2(spec))
    luma = (luma - luma.min()) / max(float(np.ptp(luma)), 1e-6)
    # mild chroma variation around the luma (natural-video-like)
    tex = np.stack([
        luma,
        np.clip(luma * rng.uniform(0.6, 1.0) + rng.uniform(0.0, 0.3), 0, 1),
        np.clip(luma * rng.uniform(0.6, 1.0) + rng.uniform(0.0, 0.3), 0, 1),
    ], axis=-1).astype(np.float32)
    return tex


def _texture_cartoon(rng: np.random.Generator, s2: int):
    """Piecewise-constant Voronoi 'cartoon': flat colored cells with hard
    edges — the low-rate-friendly content family (screen content, graphics)
    that 1/f noise and photos never produce."""
    k = int(rng.integers(4, 14))
    sites = rng.uniform(0, s2, size=(k, 2)).astype(np.float32)
    colors = rng.uniform(0, 1, size=(k, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:s2, 0:s2].astype(np.float32)
    d = ((yy[..., None] - sites[:, 0]) ** 2
         + (xx[..., None] - sites[:, 1]) ** 2)
    return colors[np.argmin(d, axis=-1)]


def _texture_grating(rng: np.random.Generator, s2: int):
    """Oriented sinusoid grating or circular zone plate."""
    yy, xx = np.mgrid[0:s2, 0:s2].astype(np.float32)
    base = rng.uniform(0, 1, 3).astype(np.float32)
    amp = rng.uniform(0.15, 0.5)
    if rng.random() < 0.5:
        fy, fx = rng.uniform(-0.35, 0.35, 2)
        wave = np.sin(fy * yy + fx * xx + rng.uniform(0, 6.28))
    else:  # zone plate: radially increasing frequency
        cy, cx = rng.uniform(0, s2, 2)
        r2 = (yy - cy) ** 2 + (xx - cx) ** 2
        wave = np.sin(r2 * rng.uniform(0.0005, 0.004))
    tex = base[None, None] + amp * wave[..., None] * rng.uniform(0.5, 1.0, 3)
    return np.clip(tex, 0, 1).astype(np.float32)


def _texture_checker(rng: np.random.Generator, s2: int):
    """Rotated checkerboard / stripes: hard periodic edges."""
    yy, xx = np.mgrid[0:s2, 0:s2].astype(np.float32)
    th = rng.uniform(0, 3.14)
    u = np.cos(th) * xx + np.sin(th) * yy
    v = -np.sin(th) * xx + np.cos(th) * yy
    p = rng.uniform(6, 28)
    sq = np.sign(np.sin(u * 6.28 / p))
    if rng.random() < 0.5:
        sq = sq * np.sign(np.sin(v * 6.28 / p))
    c0 = rng.uniform(0, 1, 3).astype(np.float32)
    c1 = rng.uniform(0, 1, 3).astype(np.float32)
    return np.where(sq[..., None] > 0, c0, c1).astype(np.float32)


def _texture_ramp(rng: np.random.Generator, s2: int):
    """Smooth gradient ramp + a few soft Gaussian blobs (sky-like)."""
    yy, xx = np.mgrid[0:s2, 0:s2].astype(np.float32)
    gy, gx = rng.uniform(-1, 1, 2) / s2
    tex = np.empty((s2, s2, 3), np.float32)
    for c in range(3):
        tex[..., c] = rng.uniform(0.2, 0.8) + gy * rng.uniform(-1, 1) * yy \
            + gx * rng.uniform(-1, 1) * xx
    for _ in range(int(rng.integers(1, 4))):
        cy, cx = rng.uniform(0, s2, 2)
        sig2 = rng.uniform(6, 40) ** 2
        blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sig2))
        tex += rng.uniform(-0.3, 0.3, 3) * blob[..., None]
    return np.clip(tex, 0, 1).astype(np.float32)


def _texture(rng: np.random.Generator, size: int, margin: int,
             photos: Sequence[np.ndarray] = ()):
    """A texture for the clip generator.  Families: natural-photo crops
    (from ``photos``, 40% of draws where there are any), 1/f noise, flat
    Voronoi cartoons, gratings / zone plates, checkerboards, smooth
    ramps."""
    s2 = size + 2 * margin
    u = rng.random()
    if photos and u < 0.40:
        im = photos[int(rng.integers(len(photos)))]
        H, W, _ = im.shape
        if H >= s2 and W >= s2:
            y0 = int(rng.integers(0, H - s2 + 1))
            x0 = int(rng.integers(0, W - s2 + 1))
            tex = im[y0:y0 + s2, x0:x0 + s2].copy()
            if rng.random() < 0.5:
                tex = tex[:, ::-1]
            if rng.random() < 0.5:
                tex = tex[::-1]
            if rng.random() < 0.3:
                tex = np.roll(tex, int(rng.integers(1, 3)), axis=2)
            # random contrast/brightness jitter
            tex = np.clip(tex * rng.uniform(0.7, 1.2)
                          + rng.uniform(-0.08, 0.08), 0.0, 1.0)
            return np.ascontiguousarray(tex, np.float32)
        u = rng.uniform(0.40, 1.0)  # photo too small: fall through
    if u < 0.55:
        return _texture_cartoon(rng, s2)
    if u < 0.67:
        return _texture_grating(rng, s2)
    if u < 0.78:
        return _texture_checker(rng, s2)
    if u < 0.86:
        return _texture_ramp(rng, s2)
    return _texture_1f(rng, s2)


def _sample_bilinear(tex: np.ndarray, sy: np.ndarray, sx: np.ndarray):
    """Bilinear sample tex [Ht, Wt, 3] at float coords (border-clamped)."""
    Ht, Wt, _ = tex.shape
    sy = np.clip(sy, 0.0, Ht - 1.0)
    sx = np.clip(sx, 0.0, Wt - 1.0)
    y0 = np.floor(sy).astype(np.int32)
    x0 = np.floor(sx).astype(np.int32)
    y1 = np.minimum(y0 + 1, Ht - 1)
    x1 = np.minimum(x0 + 1, Wt - 1)
    wy = (sy - y0)[..., None]
    wx = (sx - x0)[..., None]
    top = tex[y0, x0] * (1 - wx) + tex[y0, x1] * wx
    bot = tex[y1, x0] * (1 - wx) + tex[y1, x1] * wx
    return top * (1 - wy) + bot * wy


def _new_scene(rng: np.random.Generator, size: int, margin: int,
               photos: Sequence[np.ndarray] = ()):
    """Sample one scene: background affine motion + 0-2 foreground
    ellipses with independent translation (occlusion/disocclusion)."""
    # 20% TRULY static scenes (zero translation AND zoom/rot) so the skip
    # path sees content where x_warp reconstructs exactly for free: the
    # old "static" draw zeroed only vbg, so residual zoom/rot still made
    # skip lossy everywhere and alpha=1 stayed RD-optimal (VERDICT r3
    # item 2 — the coding-mode mask never fired).
    static = rng.random() < 0.20
    scene = {
        "bg": _texture(rng, size, margin, photos),
        "vbg": np.zeros(2) if static else rng.uniform(-2.5, 2.5, 2),
        "zoom": 0.0 if static else rng.uniform(-0.004, 0.004),
        "rot": 0.0 if static else rng.uniform(-0.004, 0.004),
        # 20% of scenes reverse all motion at a random time (bounce-like;
        # without this, training motion is strictly linear in t and the
        # held-out velocity-reversal family is fully out-of-distribution)
        "t_rev": (int(rng.integers(1, 6)) if rng.random() < 0.2 else -1),
        "fgs": [],
    }
    for _ in range(int(rng.integers(0, 3))):
        scene["fgs"].append({
            "tex": _texture(rng, size, margin, photos),
            "c": rng.uniform(0.2, 0.8, 2) * size,
            "r": rng.uniform(0.08, 0.3, 2) * size,
            # static scenes freeze the foregrounds too, else the moving
            # ellipses keep skip lossy over most of the frame
            "v": np.zeros(2) if static else rng.uniform(-3.5, 3.5, 2),
        })
    # illumination drift: slow global gain oscillation (50% of moving
    # scenes; static scenes stay exactly repeatable so skip is free)
    if not static and rng.random() < 0.5:
        scene["illum"] = (rng.uniform(0.03, 0.15),
                          rng.uniform(0.15, 0.8), rng.uniform(0, 6.28))
    else:
        scene["illum"] = None
    return scene


def _render_scene(scene, t: int, size: int, margin: int,
                  yy: np.ndarray, xx: np.ndarray):
    t_rev = scene.get("t_rev", -1)
    if t_rev > 0 and t > t_rev:  # motion retraces after the reversal
        t = 2 * t_rev - t
    cy0 = cx0 = (size - 1) / 2.0
    s = np.sin(scene["rot"] * t)
    c = np.cos(scene["rot"] * t) * (1.0 + scene["zoom"] * t)
    dy, dx = yy - cy0, xx - cx0
    sy = cy0 + c * dy + s * dx + margin + scene["vbg"][0] * t
    sx = cx0 - s * dy + c * dx + margin + scene["vbg"][1] * t
    frame = _sample_bilinear(scene["bg"], sy, sx)
    for fg in scene["fgs"]:
        jy = yy + margin + fg["v"][0] * t
        jx = xx + margin + fg["v"][1] * t
        mask = ((((yy - fg["c"][0] - fg["v"][0] * t) / fg["r"][0]) ** 2
                 + ((xx - fg["c"][1] - fg["v"][1] * t) / fg["r"][1]) ** 2)
                < 1.0)[..., None]
        frame = np.where(mask, _sample_bilinear(fg["tex"], jy, jx), frame)
    if scene["illum"] is not None:
        amp, w, phi = scene["illum"]
        frame = frame * (1.0 + amp * np.sin(w * t + phi))
    return frame


def make_batch(rng: np.random.Generator, n_frames: int, batch: int, size: int,
               photos: Sequence[np.ndarray] = ()):
    """[n_frames, B, size, size, 3] float32 clips: textured backgrounds
    under SUBPIXEL affine motion (translation + slight zoom/rotation) with
    0-2 foreground ellipses moving independently (occlusion/disocclusion),
    so MOFNet's flows train at the bilinear warp's actual precision and
    alpha/beta get masking signal.  Texture families span photos, noise,
    cartoons, gratings, checkers, ramps (_texture); 15% of clips contain a
    scene cut (alpha must fall back to intra coding), 50% have slow
    illumination drift, and sensor noise varies per clip (30% noiseless).
    ``photos`` is the pool of natural photographs (``photo_pool``), float32
    [H, W, 3] in [0, 1]; with none the photo family is never drawn.
    """
    margin = 24
    out = np.empty((n_frames, batch, size, size, 3), np.float32)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    for b in range(batch):
        scene = _new_scene(rng, size, margin, photos)
        t_cut = (int(rng.integers(1, n_frames))
                 if n_frames > 1 and rng.random() < 0.15 else -1)
        t0 = 0
        for t in range(n_frames):
            if t == t_cut:
                scene = _new_scene(rng, size, margin, photos)
                t0 = t
            out[t, b] = _render_scene(scene, t - t0, size, margin, yy, xx)
        noise = 0.0 if rng.random() < 0.3 else rng.uniform(0.001, 0.006)
        if noise:
            out[:, b] += rng.normal(scale=noise,
                                    size=out[:, b].shape).astype(np.float32)
    return np.clip(out, 0.0, 1.0).astype(np.float32)
