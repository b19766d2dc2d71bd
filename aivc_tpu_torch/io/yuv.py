"""Raw YUV420 (8-bit) video I/O.

Direct numpy memory-mapped frame access — no PNG-triplet detour.  The
reference shells out to ``dd`` + PGM + PIL per frame and round-trips
through PNG triplets (reference: src/format_conversion/yuv_to_png.py:21,
script_convert_one_frame/yuv_to_png.sh, img_processing.py:199-218) only
because its loader is PNG-based; here the codec reads frames straight
from the .yuv file.

Conventions match the reference: planar I420, Y then U then V, U/V at
ceil(H/2) x ceil(W/2); filenames ``name_WxH_fps_420.yuv`` carry the
geometry (reference: src/format_conversion/utils.py:44-49,69-72).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

_NAME_RE = re.compile(r"_(\d+)x(\d+)_(\d+)")


def parse_geometry(path: str | Path) -> Tuple[int, int, Optional[int]]:
    """Parse (W, H, fps) from a `name_WxH_fps_420.yuv` filename."""
    m = _NAME_RE.search(Path(path).stem)
    if not m:
        raise ValueError(
            f"cannot parse WxH from {Path(path).name!r}; expected name_WxH_fps_420.yuv")
    return int(m.group(1)), int(m.group(2)), int(m.group(3))


@dataclass
class YuvReader:
    """Memory-mapped reader for 8-bit planar YUV420 files."""

    path: Path
    width: int
    height: int

    def __init__(self, path: str | Path, width: Optional[int] = None,
                 height: Optional[int] = None):
        self.path = Path(path)
        if width is None or height is None:
            width, height, _ = parse_geometry(self.path)
        self.width, self.height = width, height
        self._wc = math.ceil(width / 2)
        self._hc = math.ceil(height / 2)
        self.frame_bytes = width * height + 2 * self._wc * self._hc
        size = self.path.stat().st_size
        self.n_frames = size // self.frame_bytes
        self._mm = np.memmap(self.path, dtype=np.uint8, mode="r")

    def read_frame(self, idx: int) -> Dict[str, np.ndarray]:
        """-> {'y': [H, W], 'u': [Hc, Wc], 'v': [Hc, Wc]} uint8."""
        if not (0 <= idx < self.n_frames):
            raise IndexError(f"frame {idx} out of range [0, {self.n_frames})")
        W, H, Wc, Hc = self.width, self.height, self._wc, self._hc
        off = idx * self.frame_bytes
        y = self._mm[off:off + H * W].reshape(H, W)
        off += H * W
        u = self._mm[off:off + Hc * Wc].reshape(Hc, Wc)
        off += Hc * Wc
        v = self._mm[off:off + Hc * Wc].reshape(Hc, Wc)
        return {"y": np.array(y), "u": np.array(u), "v": np.array(v)}


class YuvWriter:
    """Sequential writer for 8-bit planar YUV420 files."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._f = open(self.path, "wb")

    def write_frame(self, frame: Dict[str, np.ndarray]) -> None:
        for k in ("y", "u", "v"):
            plane = np.ascontiguousarray(frame[k], dtype=np.uint8)
            self._f.write(plane.tobytes())

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def frame_to_float(frame: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """uint8 planes -> float32 [1, H, W, 1] NHWC planes in [0, 1]."""
    return {
        k: (frame[k].astype(np.float32) / 255.0)[None, :, :, None]
        for k in ("y", "u", "v")
    }


def frame_to_uint8(frame: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """float [1, H, W, 1] planes in [0,1] -> uint8 [H, W] planes (round)."""
    return {
        k: np.clip(np.round(np.asarray(frame[k])[0, :, :, 0] * 255.0), 0, 255)
        .astype(np.uint8)
        for k in ("y", "u", "v")
    }
