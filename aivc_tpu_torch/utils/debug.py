"""Debug tooling: encoder/decoder drift detection via plane hashes (a
copy of aivc_tpu/utils/debug.py; the manifest is the same bytes).

Parity with the reference's md5 machinery
(reference: src/real_life/check_md5sum.py:16-73, decode.py:304-326): the
encoder records a digest per decoded plane; the decoder recomputes and
compares, printing 'Identical reconstruction!' / 'Incorrect
reconstruction!'.  Hashes are computed over raw plane bytes, no temp
files.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Dict

import numpy as np


def plane_md5(plane: np.ndarray) -> str:
    return hashlib.md5(np.ascontiguousarray(plane).tobytes()).hexdigest()


def frame_md5(frame: Dict[str, np.ndarray]) -> Dict[str, str]:
    return {k: plane_md5(frame[k]) for k in ("y", "u", "v")}


def write_md5_manifest(frames: Dict[int, Dict[str, np.ndarray]],
                       path: str | Path) -> None:
    manifest = {str(i): frame_md5(f) for i, f in frames.items()}
    Path(path).write_text(json.dumps(manifest, indent=1))


def check_md5_manifest(frames: Dict[int, Dict[str, np.ndarray]],
                       path: str | Path, verbose: bool = True) -> bool:
    """Compare decoded frames against an encoder-side manifest."""
    manifest = json.loads(Path(path).read_text())
    ok = True
    for i, frame in frames.items():
        expect = manifest.get(str(i))
        if expect is None:
            ok = False
            if verbose:
                print(f"frame {i}: missing from encoder manifest")
            continue
        got = frame_md5(frame)
        for k in ("y", "u", "v"):
            if got[k] != expect[k]:
                ok = False
                if verbose:
                    print(f"frame {i}_{k}: Incorrect reconstruction!")
            elif verbose:
                print(f"frame {i}_{k}: Identical reconstruction!")
    return ok
