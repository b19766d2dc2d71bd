"""Rebuild ``aivc_tpu_torch/assets/photo_pool.npz`` and its manifest from
the photographs that ship inside installed packages (host only).

    python -m aivc_tpu_torch.eval.make_photo_pool [--out DIR]

Reads the same assets in the same order as scripts/photo_pool.py's
``train_pool`` (sklearn's two sample photos, matplotlib's grace_hopper,
then TRAIN_TEXTURES) and ``heldout_pool`` (HELDOUT_TEXTURES), each as
PIL's ``convert("RGB")`` gives it, and writes them as uint8 arrays
``train_000``, ... and ``heldout_000``, ... to one compressed npz.  The
manifest beside it (``photo_pool.json``) gives each image's pool, source,
shape and licence, and the images left out with the reason.  Every asset
must be present: a missing one raises, so the file never holds a
shorter pool than the reference's.

Run it again only when the reference's asset lists change: the readers
(``eval/photos.py``) take the file as it is committed.
"""

from __future__ import annotations

import argparse
import importlib.metadata as md
import json
import sysconfig
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

ASSETS = Path(__file__).resolve().parent.parent / "assets"

_GYM = "gymnasium_robotics/envs/assets/"
_KITCHEN = _GYM + "kitchen_franka/kitchen_assets/textures/"
_HAND = _GYM + "adroit_hand/resources/textures/"
_DMC = "dm_control/"
_SOCCER = _DMC + "locomotion/soccer/assets/"
_LAB = "labmaze/assets/"
# Material photographs, relative to site-packages, in the order of
# scripts/photo_pool.py:TRAIN_TEXTURES and HELDOUT_TEXTURES.
TRAIN_TEXTURES = (
    _KITCHEN + "wood1.png",
    _KITCHEN + "white_marble_tile.png",
    _KITCHEN + "marble1.png",
    _KITCHEN + "metal1.png",
    _HAND + "skin.png",
    _HAND + "silverRaw.png",
    _DMC + "locomotion/arenas/assets/outdoor_natural/OutdoorSkybox2048.png",
    _DMC + "locomotion/arenas/assets/outdoor_natural/OutdoorGrassFloorD.png",
    _DMC + "suite/dog_assets/skin_texture.png",
    _SOCCER + "pitch/pitch_m.png",
    _DMC + "locomotion/walkers/assets/jumping_ball/jumping_ball_body.png",
    _SOCCER + "humanoid/B_01.png",
    _SOCCER + "humanoid/B_05.png",
    _SOCCER + "humanoid/R_03.png",
    _DMC + "suite/dog_assets/tennis_ball.png",
    _DMC + "blender/mujoco_exporter/doc/install_plugin.png",
    _DMC + "blender/mujoco_exporter/doc/limits.png",
    _LAB + "sky_01/up.png",
    _LAB + "style_01/floor_light_m.png",
    _LAB + "style_02/wall_purple_d.png",
    _LAB + "style_05/floor_blue_d.png",
    _LAB + "style_03/floor_orange_d.png",
)
HELDOUT_TEXTURES = (
    _HAND + "darkwood.png",
    _HAND + "foil.png",
    _HAND + "marble.png",
    _KITCHEN + "tile1.png",
    _KITCHEN + "white_marble_tile2.png",
)

# Where each asset's terms are stated, beside its package's licence
# metadata (read from the installed distribution at build time).
_ASSET_NOTES = {
    _HAND: "Apache-2.0, (C) Vikash Kumar "
           "(gymnasium_robotics/envs/assets/LICENSE.md, ShadowHand)",
    _KITCHEN: "Apache-2.0, Copyright 2020 Google LLC (header of "
              "kitchen_franka/kitchen_assets/kitchen_env_model.xml)",
}
_SKLEARN_README = "sklearn/datasets/images/README.txt"
# Licences that allow redistribution of the asset with its notice.
REDISTRIBUTABLE = ("MIT", "Apache", "BSD", "creativecommons.org/licenses/by/",
                   "Python Software Foundation", "matplotlib")
# Images of the reference's pools left out of the file, with the reason
# (none: every licence above allows redistribution).
EXCLUDED: Dict[str, str] = {}


def _package_licence(dist: str) -> str:
    meta = md.metadata(dist)
    lic = meta.get("License-Expression") or ""
    if not lic:
        lic = (meta.get("License") or "").splitlines()[0].strip()
    classifiers = [c.split("::")[-1].strip()
                   for c in meta.get_all("Classifier") or []
                   if c.startswith("License ::")
                   and c.split("::")[-1].strip() != lic]
    return "; ".join([f"{dist} {md.version(dist)}: {lic}"] + classifiers)


def _sklearn_terms(site: Path, name: str) -> str:
    """The licence and attribution lines of ``name`` in sklearn's image
    README."""
    text = (site / _SKLEARN_README).read_text()
    block = text.split(f"Image: {name}", 1)[1].split("Image:", 1)[0]
    return " ".join(ln.strip() for ln in block.strip().splitlines()
                    if ln.strip())


def _rgb(path) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


def collect(site: Path) -> Tuple[List[np.ndarray], List[Dict],
                                 List[np.ndarray], List[Dict]]:
    """(train images, their manifest rows, held-out images, rows)."""
    from sklearn.datasets import load_sample_images

    train, train_rows, held, held_rows = [], [], [], []
    sk = load_sample_images()
    for fn, im in zip(sk.filenames, sk.images):
        name = Path(fn).name
        train.append(np.asarray(im, np.uint8))
        train_rows.append({
            "source": f"sklearn/datasets/images/{name} "
                      f"(sklearn.datasets.load_sample_images)",
            "licence": f"{_sklearn_terms(site, name)} "
                       f"[{_SKLEARN_README}; {_package_licence('scikit-learn')}]"})
    import matplotlib.cbook as cbook

    with cbook.get_sample_data("grace_hopper.jpg") as f:
        train.append(_rgb(f))
    train_rows.append({
        "source": "matplotlib/mpl-data/sample_data/grace_hopper.jpg "
                  "(matplotlib.cbook.get_sample_data)",
        "licence": _package_licence("matplotlib")})
    for rels, ims, rows in ((TRAIN_TEXTURES, train, train_rows),
                            (HELDOUT_TEXTURES, held, held_rows)):
        for rel in rels:
            if rel in EXCLUDED:
                continue
            ims.append(_rgb(site / rel))
            dist = rel.split("/", 1)[0]       # the package's distribution
            note = next((v for k, v in _ASSET_NOTES.items()
                         if rel.startswith(k)), "")
            rows.append({"source": rel, "licence": "; ".join(
                x for x in (note, _package_licence(dist)) if x)})
    return train, train_rows, held, held_rows


def write(out: Path, site: Path) -> Dict:
    train, train_rows, held, held_rows = collect(site)
    arrays, images = {}, []
    for pool, ims, rows in (("train", train, train_rows),
                            ("heldout", held, held_rows)):
        for i, (im, row) in enumerate(zip(ims, rows)):
            key = f"{pool}_{i:03d}"
            if not any(t in row["licence"] for t in REDISTRIBUTABLE):
                raise ValueError(f"{row['source']}: no licence that allows "
                                 f"redistribution ({row['licence']})")
            arrays[key] = im
            images.append({"key": key, "pool": pool, "shape": list(im.shape),
                           **row})
    out.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out / "photo_pool.npz", **arrays)
    manifest = {
        "what": "photographs of the reference's photo pools "
                "(scripts/photo_pool.py: train_pool, heldout_pool), uint8 "
                "RGB as PIL's convert('RGB') gives them",
        "tool": "python -m aivc_tpu_torch.eval.make_photo_pool",
        "counts": {"train": len(train), "heldout": len(held)},
        "excluded": [{"source": k, "reason": v} for k, v in EXCLUDED.items()],
        "images": images,
    }
    (out / "photo_pool.json").write_text(json.dumps(manifest, indent=1)
                                         + "\n")
    return manifest


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ASSETS))
    args = ap.parse_args(argv)
    m = write(Path(args.out), Path(sysconfig.get_paths()["purelib"]))
    size = (Path(args.out) / "photo_pool.npz").stat().st_size
    print(f"photo pool: {m['counts']['train']} training and "
          f"{m['counts']['heldout']} held-out photographs, "
          f"{len(m['excluded'])} left out; {size} bytes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
