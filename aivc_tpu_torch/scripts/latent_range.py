"""Measure a checkpoint's coded-latent range over held-out content (the
port of scripts/latent_range.py).

Decides whether a model can declare a narrower entropy-coding alphabet
(ModelConfig.ac_max_val): where every quantized latent over the held-out
clips and the rate ladder stays well inside +-A, ac_max_val = A shrinks
every CDF table by 512 / (2A) without changing the reconstruction.

Each wave of an RA GOP 8 (wave batch 4) is launched
(FrameCodec.encode_frames_launch) and never finished: the clamped
integer latents are read from the launch's handles (``q_m`` / ``q_c``,
the quantized y of MOFNet and CodecNet, and ``z_m`` / ``z_c``, their
clamped z; the JAX launch calls them y_cqm, y_cqc, z_qm, z_qc), pulled
to the host alone, and the handles dropped.  The codec keeps no state of
an unfinished launch, so its next encode is unaffected.  Prints one JSON
object with the JAX script's keys.

    python -m aivc_tpu_torch.scripts.latent_range \\
        --ckpt models_ckpt/bf16-r5 [--cpu]

It runs on the card; ``--cpu`` runs on the host.  With no card and no
``--cpu`` it exits 2.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from aivc_tpu_torch.scripts import pick_device


def measure(codec, clips, rates):
    """(max |y|, max |z|, counts of |y| >= 2^i for i < 10) over every
    wave of each clip's first RA GOP 8 at each rate."""
    from aivc_tpu_torch.config import CodingConfig
    from aivc_tpu_torch.gop import generate_gop_struct
    from aivc_tpu_torch.pipeline.video import wave_groups

    max_y = max_z = 0
    hist = np.zeros(10, np.int64)
    for r in rates:
        coding = CodingConfig(coding_config="RA", gop_size=8,
                              intra_period=8, idx_rate=r)
        gop = generate_gop_struct(coding.gop_struct_name())
        for frames in clips:
            decoded = {}
            for ftype, specs in wave_groups(gop, 4):
                handles = codec.encode_frames_launch(
                    [frames[s.idx] for s in specs],
                    [decoded.get(s.prev_ref) for s in specs],
                    [decoded.get(s.next_ref) for s in specs],
                    ftype, r)
                for spec, dec in zip(specs, handles["decoded"]):
                    decoded[spec.idx] = dec.ref
                for key in ("q_m", "q_c"):
                    if handles[key] is not None:
                        q = np.abs(handles[key].cpu().numpy())
                        max_y = max(max_y, int(q.max()))
                        for i in range(10):
                            hist[i] += int((q >= (1 << i)).sum())
                for key in ("z_m", "z_c"):
                    if handles[key] is not None:
                        z = np.abs(handles[key].cpu().numpy())
                        max_z = max(max_z, int(z.max()))
    return max_y, max_z, hist


def report(ckpt: str, max_y: int, max_z: int, hist, n_families: int):
    return {
        "ckpt": ckpt,
        "max_abs_y": max_y,
        "max_abs_z": max_z,
        "n_families": n_families,
        "count_ge_pow2": {str(1 << i): int(hist[i]) for i in range(10)},
        "safe_ac_max": int(max(32, 1 << int(np.ceil(np.log2(
            max(max_y, max_z, 16) + 1)) + 1))),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m aivc_tpu_torch.scripts.latent_range",
        description="coded-latent range over the held-out clips")
    ap.add_argument("--ckpt", default="models_ckpt/bf16-r5")
    ap.add_argument("--h", type=int, default=240)
    ap.add_argument("--w", type=int, default=416)
    ap.add_argument("--frames", type=int, default=9)
    ap.add_argument("--rates", default="0,2,4,6")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host instead of the card")
    args = ap.parse_args(argv)
    device = pick_device(args.cpu)
    if device is None:
        return 2

    from aivc_tpu_torch.eval.clips import FAMILIES, heldout_clips
    from aivc_tpu_torch.pipeline.codec import FrameCodec
    from aivc_tpu_torch.utils.checkpoint import load_checkpoint

    cfg, model = load_checkpoint(args.ckpt, device=device)
    codec = FrameCodec(cfg, model, args.h, args.w, device=device)
    clips = heldout_clips(args.frames, args.h, args.w)
    max_y, max_z, hist = measure(codec, clips,
                                 [float(x) for x in args.rates.split(",")])
    print(json.dumps(report(args.ckpt, max_y, max_z, hist, len(FAMILIES))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
