"""Sanity run, the reference's sanity_script.sh (the port of
scripts/sanity.py).

Structural mode (default): a deterministic synthetic clip (9 frames of
240x416, seed 1234) is encoded and decoded end to end by a freshly
initialised tiny model with the debug self-checks on (per-chunk lossless
entropy coding), and the invariants that always hold are checked: the
bitstream is not trivial, the decode reads only the bitstream and
equals the encoder's reconstruction (the md5 manifest of
utils/debug.py), the metrics are finite.  Prints the [SANITY] lines.
Stated departure: the JAX script draws the tiny model from
jax.random.PRNGKey(0), which PyTorch cannot reproduce; here it comes from
models/zoo.py:init_fullnet with torch.Generator seed 0.

``--golden`` and ``--suite`` (with ``--slow``: the 720p and 1080p pins
too) run the golden pins through eval/golden.py, which ports that half
of the script.  The pins are the JAX package's, made on the CPU backend;
the port holds itself to them and does not rewrite them, so
``--update`` is refused.

    python -m aivc_tpu_torch.scripts.sanity [--cpu] [--golden | --suite]

It runs on the card; ``--cpu`` runs on the host.  With no card and no
``--cpu`` it exits 2.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np

from aivc_tpu_torch.scripts import pick_device

H, W, N = 240, 416, 9


def structural(device) -> int:
    import torch

    from aivc_tpu_torch.config import CodingConfig
    from aivc_tpu_torch.models.zoo import TINY, init_fullnet
    from aivc_tpu_torch.pipeline.codec import FrameCodec
    from aivc_tpu_torch.pipeline.video import (
        decode_video,
        encode_video,
        evaluate_frames,
        synthetic_frames,
    )
    from aivc_tpu_torch.utils.debug import (
        check_md5_manifest,
        write_md5_manifest,
    )

    frames = synthetic_frames(N, H, W, seed=1234)
    model = init_fullnet(TINY, torch.Generator().manual_seed(0),
                         device=device)
    codec = FrameCodec(TINY, model, H, W, device=device, debug=True)
    coding = CodingConfig(coding_config="RA", gop_size=8, intra_period=8)
    res = encode_video(codec, frames, coding)
    if res.total_bytes <= 100:
        raise RuntimeError(f"suspiciously small bitstream: "
                           f"{res.total_bytes} B")
    with tempfile.TemporaryDirectory() as td:
        manifest = Path(td) / "m.json"
        write_md5_manifest(res.decoded_frames, manifest)
        decoded = decode_video(codec, res.bitstream)
        if sorted(decoded) != list(range(N)) or not check_md5_manifest(
                decoded, manifest, verbose=False):
            raise RuntimeError("encoder/decoder drift!")
    m = evaluate_frames(frames, decoded, device=device)
    if not (np.isfinite(m["psnr"]) and np.isfinite(m["ms_ssim"])):
        raise RuntimeError(f"metrics not finite: {m}")
    print(f"[SANITY] frames                : {N}")
    print(f"[SANITY] bitstream bytes       : {res.total_bytes}")
    print(f"[SANITY] rate bpp              : "
          f"{res.total_bytes * 8 / (H * W * N):.4f}")
    print(f"[SANITY] psnr                  : {m['psnr']:.5f} dB")
    print(f"[SANITY] ms-ssim               : {m['ms_ssim']:.5f}")
    print("[SANITY] enc/dec               : bit-exact")
    print("[SANITY] OK")
    return 0


def golden_argv(args) -> list:
    """eval/golden.py's command line for --golden / --suite [--slow]."""
    from aivc_tpu_torch.eval import golden

    argv = ["--cpu"] if args.cpu else []
    if args.golden:
        return argv + ["--pins", golden.SANITY]
    if args.slow:
        return argv + ["--pins"] + [n for n in golden.suite_pins()
                                    if n != golden.SANITY]
    return argv


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m aivc_tpu_torch.scripts.sanity",
        description="structural sanity run; --golden / --suite: the pins")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host instead of the card")
    ap.add_argument("--golden", action="store_true",
                    help="the sanity pin (docs/golden_sanity.json)")
    ap.add_argument("--suite", action="store_true",
                    help="multi-config golden suite (docs/golden_suite.json)")
    ap.add_argument("--slow", action="store_true",
                    help="include the slow (720p, 1080p) suite pins")
    ap.add_argument("--update", action="store_true",
                    help="refused: the pins are the JAX package's")
    args = ap.parse_args(argv)
    if args.update:
        print("error: the port does not rewrite the golden pins (the JAX "
              "package makes them on the CPU backend: scripts/sanity.py "
              "--update)", file=sys.stderr)
        return 2
    if args.golden or args.suite:
        from aivc_tpu_torch.eval import golden

        return golden.main(golden_argv(args))
    device = pick_device(args.cpu)
    if device is None:
        return 2
    return structural(device)


if __name__ == "__main__":
    sys.exit(main())
