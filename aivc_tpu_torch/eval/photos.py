"""The photo pools, read from the committed file
``aivc_tpu_torch/assets/photo_pool.npz`` (the port's counterpart of
scripts/photo_pool.py, which reads the assets of installed packages).

``train_pool()`` feeds the clip generator's natural-photo family
(train/data.py) and ``heldout_pool()`` the photo families of the
held-out clips (eval/clips.py); the two are disjoint.  Both return
float32 RGB [H, W, 3] in [0, 1], ``uint8 / 255`` as the reference's
loaders give them, in the reference's order.  The file is part of the
package, so the card's machine draws the same photographs as the host:
a missing or damaged file, or one that disagrees with its manifest,
raises instead of giving a shorter pool.
"""

from __future__ import annotations

import functools
import json
from pathlib import Path
from typing import List, Tuple

import numpy as np

ASSETS = Path(__file__).resolve().parent.parent / "assets"
POOL_FILE = ASSETS / "photo_pool.npz"
MANIFEST_FILE = ASSETS / "photo_pool.json"


@functools.lru_cache(maxsize=None)
def _load(pool: str) -> Tuple[np.ndarray, ...]:
    """The uint8 images of ``pool`` ("train" | "heldout"), checked
    against the manifest (count, keys, shapes; the zip's CRCs on read)."""
    try:
        manifest = json.loads(MANIFEST_FILE.read_text())
        rows = [r for r in manifest["images"] if r["pool"] == pool]
        if len(rows) != manifest["counts"][pool]:
            raise ValueError(f"{len(rows)} {pool} rows, counts say "
                             f"{manifest['counts'][pool]}")
        with np.load(POOL_FILE, allow_pickle=False) as npz:
            ims = tuple(npz[r["key"]] for r in rows)
    except Exception as e:
        raise RuntimeError(f"photo pool {POOL_FILE} unreadable ({e}); "
                           f"rebuild it with python -m "
                           f"aivc_tpu_torch.eval.make_photo_pool") from e
    for r, im in zip(rows, ims):
        if im.dtype != np.uint8 or list(im.shape) != r["shape"]:
            raise RuntimeError(f"photo pool {POOL_FILE}: {r['key']} is "
                               f"{im.dtype} {list(im.shape)}, the manifest "
                               f"says uint8 {r['shape']}")
    if not ims:
        raise RuntimeError(f"photo pool {POOL_FILE}: no {pool} images")
    return ims


def _float(ims) -> List[np.ndarray]:
    return [np.asarray(im, np.float32) / 255.0 for im in ims]


def train_pool() -> List[np.ndarray]:
    """Training photographs (scripts/photo_pool.py:train_pool)."""
    return _float(_load("train"))


def heldout_pool() -> List[np.ndarray]:
    """Held-out photographs (scripts/photo_pool.py:heldout_pool)."""
    return _float(_load("heldout"))
