"""Smoke run of the port's main path on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from aivc_tpu_torch/csrc, checks each against its
plain PyTorch version at the 1080p shapes of bf16-r5, then encodes and
decodes a 9-frame 1080p RA clip (GOP 8) of models_ckpt/bf16-r5 through
the port's entry points and checks the decode bit for bit.  Every phase
prints its elapsed seconds.  The last two lines are the kernels' JSON
record and the result; any failed check raises (nonzero exit).  Exits
nonzero, printing no result, when there is no CUDA device.
"""

import json
import sys
import time
from pathlib import Path

import torch

CKPT = "models_ckpt/bf16-r5"
H, W = 1080, 1920
N_FRAMES, GOP, WAVE_BATCH = 9, 8, 8


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from aivc_tpu_torch import kernels, smoke
    from aivc_tpu_torch.pipeline.codec import FrameCodec
    from aivc_tpu_torch.pipeline.video import synthetic_frames
    from aivc_tpu_torch.utils.checkpoint import load_checkpoint

    root = Path(__file__).resolve().parent
    ckpt = str(root / CKPT)
    ph = smoke.Phases(lambda m: print(m, flush=True))
    dev = torch.device("cuda")

    info = smoke.device_info()
    ph.say(f"device: {info['kind']} x{info['count']}")
    ph.say(f"nvidia-smi: {info['smi']}")

    rep = smoke.build_report()
    ph.say(f"build: nvcc {rep['seconds']:.1f}s (cached={rep['cached']})")
    for line in rep["ptxas"]:
        ph.say(f"  ptxas {line}")

    cfg, model = load_checkpoint(ckpt, device=dev)
    codec = FrameCodec(cfg, model, H, W, device=dev)
    ph.say(f"load: {cfg.name} at {W}x{H}, flow_bound {cfg.flow_bound}, "
           f"warp engine {codec.warp_engine}, table "
           f"{codec.table.n_rows}x{codec.table.n_symbols}")

    batch = 4   # the largest wave of an RA GOP of 8 (four B-frames)
    records = smoke.check_rans(codec, batch)
    records += smoke.check_warp(dev, batch, codec.hp, codec.wp,
                                int(-(-cfg.flow_bound // 1)))
    for r in records:
        ph.say(f"kernel {r['name']}: bit-identical to its plain version; "
               f"{r['ms']:.3f} ms (plain {r['plain_ms']:.3f} ms, bound "
               f"{r['bound_ms']:.4f} ms by {r['bound_by']}, library "
               f"{r['library_ms']})")

    frames = synthetic_frames(N_FRAMES, H, W)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    res = smoke.code_clip(codec, frames, wave_batch=WAVE_BATCH, gop=GOP)
    launches = dict(kernels.LAUNCHES)
    ph.say(f"main: {N_FRAMES} frames {W}x{H} RA GOP{GOP}: {res['bytes']} B, "
           f"{res['bpp']:.5f} bpp, PSNR {res['psnr']:.4f} dB, encode "
           f"{res['encode_fps']:.3f} fps, decode {res['decode_fps']:.3f} "
           f"fps, peak memory "
           f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
           f"launches {launches}")
    ph.say(f"main: frame bytes {res['frame_bytes']}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")

    small = smoke.small_agreement(ckpt, dev)
    ph.say(f"small: 64x64 device {small['device']['bytes']} B / "
           f"{small['device']['psnr']:.4f} dB vs host "
           f"{small['host']['bytes']} B / {small['host']['psnr']:.4f} dB")

    print(info["smi"], flush=True)
    print(smoke.kernels_line(records, launches), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    t_start = time.time()
    rc = main()
    print(f"chip_smoke: {time.time() - t_start:.1f}s", file=sys.stderr)
    sys.exit(rc)
