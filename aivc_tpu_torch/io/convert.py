"""Format conversion: PNG plane triplets and containerized video.

Capability parity with the reference's format_conversion package
(reference: src/format_conversion/yuv_to_png.py:21, png_to_yuv.py:13,
mp4_to_yuv.py:70-74): PNG triplets `<idx>_y.png / <idx>_u.png / <idx>_v.png`
per frame, and mp4 -> raw YUV via ffmpeg.  Unlike the reference, PNG is an
*optional interchange format* here — the codec's hot path reads raw YUV
directly (aivc_tpu_torch.io.yuv) — and plane slicing is plain numpy instead of a
dd + PGM + PIL shell pipeline.

ffmpeg is an optional host-side tool: mp4_to_yuv raises a clear error when
the binary is absent (this image does not ship it).
"""

from __future__ import annotations

import shutil
import subprocess
from pathlib import Path
from typing import Dict

import numpy as np


def save_frame_png(frame: Dict[str, np.ndarray], out_dir: str | Path,
                   idx: int) -> None:
    """Write uint8 planes as `<idx>_{y,u,v}.png`
    (the reference's loader layout, img_processing.py:199-218)."""
    from PIL import Image

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for k in ("y", "u", "v"):
        Image.fromarray(frame[k], mode="L").save(out_dir / f"{idx}_{k}.png")


def load_frame_png(in_dir: str | Path, idx: int) -> Dict[str, np.ndarray]:
    from PIL import Image

    in_dir = Path(in_dir)
    return {
        k: np.asarray(Image.open(in_dir / f"{idx}_{k}.png"), dtype=np.uint8)
        for k in ("y", "u", "v")
    }


def yuv_to_png(yuv_path: str | Path, out_dir: str | Path,
               check_lossless: bool = False) -> int:
    """Explode a raw YUV420 file into per-frame PNG triplets.

    Returns the number of frames written.  check_lossless round-trips each
    frame and compares bit-exactly (the reference's filecmp check,
    yuv_to_png.py:84-124).
    """
    from aivc_tpu_torch.io.yuv import YuvReader

    reader = YuvReader(yuv_path)
    for i in range(reader.n_frames):
        frame = reader.read_frame(i)
        save_frame_png(frame, out_dir, i)
        if check_lossless:
            back = load_frame_png(out_dir, i)
            for k in ("y", "u", "v"):
                if not np.array_equal(frame[k], back[k]):
                    raise AssertionError(
                        f"PNG round-trip not lossless: frame {i} plane {k}")
    return reader.n_frames


def png_to_yuv(in_dir: str | Path, yuv_path: str | Path, n_frames: int) -> None:
    """Mux per-frame PNG triplets back into a raw YUV420 file."""
    from aivc_tpu_torch.io.yuv import YuvWriter

    with YuvWriter(yuv_path) as wr:
        for i in range(n_frames):
            wr.write_frame(load_frame_png(in_dir, i))


def mp4_to_yuv(mp4_path: str | Path, yuv_path: str | Path) -> None:
    """Decode a containerized video to raw YUV420 via ffmpeg (optional
    host tool, reference: mp4_to_yuv.py:70-74)."""
    if shutil.which("ffmpeg") is None:
        raise RuntimeError(
            "ffmpeg not found on PATH; mp4 input needs the optional ffmpeg "
            "host tool — feed raw .yuv (name_WxH_fps_420.yuv) instead")
    subprocess.run(
        ["ffmpeg", "-y", "-i", str(mp4_path), "-pix_fmt", "yuv420p",
         str(yuv_path)],
        check=True, capture_output=True)
