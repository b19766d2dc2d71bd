"""Where the spatial mesh codec's reconstruction differs from one
process's, on the card, for bf16-r5 and for its float32 twin.

    python -m aivc_tpu_torch.check_spatial [--frames 9]

Encodes the synthetic 1080p clip (RA GOP 8, wave batch 8) in this
process and through two ranks over 'spatial' (gloo, bands of 544 rows),
first with bf16-r5 as it is and then with both nets in float32 (TF32
off, the codec's rule), and prints for each: the stream's bytes and
each frame's against one process's, and per frame the share of luma
pixels that differ, the largest difference, the share in the 16-row
blocks on either side of the band seam (rows 528-559), the worst
block and the median block.  A fault of the halo exchange would show
at the seam; rounding that follows the convolutions' shapes spreads
over the frame.  Needs a card.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
CKPT = ROOT / "models_ckpt" / "bf16-r5"
H, W, GOP, WAVE, SEAM = 1080, 1920, 8, 8, 544


def _encode(device, frames, f32: bool, spatial: int) -> dict:
    from aivc_tpu_torch import smoke
    from aivc_tpu_torch.config import ModelConfig
    from aivc_tpu_torch.parallel.mesh import make_mesh
    from aivc_tpu_torch.pipeline.codec import FrameCodec
    from aivc_tpu_torch.pipeline.video import encode_video
    from aivc_tpu_torch.utils.checkpoint import model_from_params, read_params

    cfg = ModelConfig.from_json((CKPT / "config.json").read_text())
    if f32:
        cfg = smoke.f32_config(cfg)
    model = model_from_params(cfg, read_params(CKPT), device)
    mesh = make_mesh(spatial=spatial) if spatial > 1 else None
    codec = FrameCodec(cfg, model, H, W, device=device, mesh=mesh)
    enc = encode_video(codec, frames, smoke.ra_coding(GOP), wave_batch=WAVE)
    return {"bytes": len(enc.bitstream),
            "frames": [r.bytes for r in enc.frame_results],
            "y": np.stack([enc.decoded_frames[i]["y"]
                           for i in range(len(frames))])}


def rank_encode(device, frames, f32: bool) -> dict:
    """On a rank: the clip through a codec over 'spatial' = 2."""
    return _encode(device, frames, f32, 2)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=9)
    n = ap.parse_args().frames
    if not torch.cuda.is_available():
        print("check_spatial: needs a CUDA device", file=sys.stderr)
        return 2
    from aivc_tpu_torch.parallel.launch import run_ranks
    from aivc_tpu_torch.pipeline.video import synthetic_frames

    dev = torch.device("cuda")
    frames = synthetic_frames(n, H, W)
    for f32 in (False, True):
        t0 = time.time()
        one = _encode(dev, frames, f32, 1)
        with tempfile.TemporaryDirectory() as tmp:
            mesh = run_ranks("aivc_tpu_torch.check_spatial:rank_encode", 2,
                             "gloo", tmp, timeout_s=600,
                             kwargs={"frames": frames, "f32": f32})[0]
        print(f"{'float32' if f32 else 'bf16'}: spatial 2 {mesh['bytes']} B "
              f"against one process's {one['bytes']} B; frames "
              f"{mesh['frames']} against {one['frames']}", flush=True)
        diff = mesh["y"].astype(np.int32) != one["y"].astype(np.int32)
        for i in range(n):
            per_row = diff[i].mean(axis=1)
            blocks = [float(per_row[s:s + 16].mean())
                      for s in range(0, H, 16)]
            seam = blocks[SEAM // 16 - 1:SEAM // 16 + 1]
            big = int(np.abs(mesh["y"][i].astype(np.int32)
                             - one["y"][i].astype(np.int32)).max())
            print(f"  frame {i}: {diff[i].mean():.5f} of the pixels differ "
                  f"(at most {big} levels); rows {SEAM - 16}-{SEAM + 15} "
                  f"{seam[0]:.5f}, {seam[1]:.5f}; worst block rows "
                  f"{int(np.argmax(blocks)) * 16}+ {max(blocks):.5f}; "
                  f"median block {float(np.median(blocks)):.5f}", flush=True)
        print(f"  {time.time() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
