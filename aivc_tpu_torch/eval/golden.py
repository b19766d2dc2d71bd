"""The golden suite on the port: the counterparts of scripts/sanity.py's
``run_golden_config`` and ``run_suite_config``, and its entry point.

    python -m aivc_tpu_torch.eval.golden [--pins NAME ...] [--sanity] [--cpu]

Each pin of ``docs/golden_suite.json`` (and with ``--sanity`` the pin of
``docs/golden_sanity.json``) names a held-out clip (eval/clips.py), a
coding structure and a checkpoint; the runner encodes the clip through
the port's FrameCodec / encode_video with wave batch 4, decodes the
stream with decode_video, checks the decode against the encoder's
reconstruction bit for bit, and holds bytes, PSNR and MS-SSIM
(evaluate_frames) against the pin within ``HOST_LIMITS`` on the host or
``CARD_LIMITS`` on the card.  The pins were made by the JAX package on
the CPU; floats differ across frameworks and devices, so the port is
held within limits, not to equality.  Without ``--pins`` the runner
takes every suite pin not marked slow (ra_720p and ra_1080p are; name
them to run them).  A pin
whose checkpoint is not on disk is reported as skipped with its reason,
never as passed.

For each pin it prints what it got, the pin, each difference and its
limit; the exit code is 1 if any pin missed or decoded wrong, 2 with no
card and no ``--cpu``, else 0.  The pin files are read as data.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

REPO = Path(__file__).resolve().parents[2]
SUITE_PATH = REPO / "docs" / "golden_suite.json"
SANITY_PATH = REPO / "docs" / "golden_sanity.json"
SANITY = "golden_sanity"
WAVE_BATCH = 4
# Limits of |port - pin|: bytes relative, PSNR in dB, MS-SSIM absolute.
# Host: about 5-7 times the worst the port measured on the CPU (0.073%,
# 0.017 dB, 0.0008 over the five host pins).  Card: bf16 convolutions
# round otherwise on the card than on the host.
HOST_LIMITS = {"bytes": 0.005, "psnr": 0.10, "ms_ssim": 0.004}
CARD_LIMITS = {"bytes": 0.02, "psnr": 0.25, "ms_ssim": 0.01}


def suite_pins() -> Dict[str, Dict]:
    """name -> {"config", "ckpt", "expect"} of every pin, the sanity pin
    last (its clip: photowarp, RA)."""
    suite = json.loads(SUITE_PATH.read_text())
    pins = {name: {"config": p["config"],
                   "ckpt": p["config"].get("ckpt", suite["ckpt"]),
                   "expect": p["expect"]}
            for name, p in suite["pins"].items()}
    sanity = json.loads(SANITY_PATH.read_text())
    cfg = dict(sanity["config"], coding="RA", family="photowarp")
    pins[SANITY] = {"config": cfg, "ckpt": cfg["ckpt"],
                    "expect": sanity["expect"]}
    return pins


def coding_config(cfg: Dict):
    """The pin's CodingConfig, as scripts/sanity.py builds it."""
    from aivc_tpu_torch.config import CodingConfig

    kw = dict(coding_config=cfg["coding"], idx_rate=cfg["idx_rate"])
    if cfg["coding"] == "RA":
        kw.update(gop_size=cfg["gop_size"], intra_period=cfg["intra_period"])
    elif cfg["coding"] == "LDP":
        kw.update(intra_period=cfg["intra_period"])
    return CodingConfig(**kw)


def skip_reason(pin: Dict) -> Optional[str]:
    if not (REPO / pin["ckpt"] / "params.msgpack").is_file():
        return f"{pin['ckpt']} not present"
    return None


def run_pin(pin: Dict, device, keep: bool = False, loaded=None) -> Dict:
    """Encode, decode and evaluate one pin's clip on ``device``: bytes,
    PSNR, MS-SSIM, whether the decode equals the encoder's
    reconstruction, the kernels' launches (counts set to 0 just before
    the encode, read just after the decode) and the seconds.  With
    ``keep`` the clip and the decoded frames come back too; ``loaded``
    is the pin's checkpoint already loaded, (config, model)."""
    from aivc_tpu_torch import kernels
    from aivc_tpu_torch.eval.clips import heldout_clips
    from aivc_tpu_torch.pipeline.codec import FrameCodec
    from aivc_tpu_torch.pipeline.video import (
        decode_video,
        encode_video,
        evaluate_frames,
    )
    from aivc_tpu_torch.utils.checkpoint import load_checkpoint

    cfg = pin["config"]
    frames = heldout_clips(cfg["frames"], cfg["h"], cfg["w"],
                           names=[cfg["family"]])[0]
    mcfg, model = loaded or load_checkpoint(str(REPO / pin["ckpt"]),
                                            device=device)
    codec = FrameCodec(mcfg, model, cfg["h"], cfg["w"], device=device)
    kernels.reset_launches()
    t0 = time.time()
    res = encode_video(codec, frames, coding_config(cfg),
                       wave_batch=WAVE_BATCH)
    t1 = time.time()
    dec = decode_video(codec, res.bitstream)
    t2 = time.time()
    launches = dict(kernels.LAUNCHES)
    exact = sorted(dec) == list(range(len(frames))) and all(
        np.array_equal(dec[i][c], res.decoded_frames[i][c])
        for i in range(len(frames)) for c in ("y", "u", "v"))
    m = evaluate_frames(frames, dec, device=device)
    out = {"bytes": int(res.total_bytes), "psnr": float(m["psnr"]),
           "ms_ssim": float(m["ms_ssim"]), "bit_exact": bool(exact),
           "launches": launches, "encode_s": t1 - t0, "decode_s": t2 - t1,
           "seconds": time.time() - t0}
    if keep:
        out["frames"], out["decoded"] = frames, dec
    return out


def run_golden_config(cfg: Dict, device) -> Dict:
    """scripts/sanity.py:run_golden_config: the sanity pin's clip
    (photowarp, RA) -> {bytes, psnr, ms_ssim}, rounded as the pins are."""
    pin = {"config": dict(cfg, coding="RA", family="photowarp"),
           "ckpt": cfg["ckpt"]}
    return _rounded(run_pin(pin, device))


def run_suite_config(name: str, cfg: Dict, ckpt: str, device) -> Dict:
    """scripts/sanity.py:run_suite_config: one suite pin's clip ->
    {bytes, psnr, ms_ssim}, rounded as the pins are."""
    pin = {"config": cfg, "ckpt": cfg.get("ckpt", ckpt)}
    return _rounded(run_pin(pin, device))


def _rounded(got: Dict) -> Dict:
    return {"bytes": got["bytes"], "psnr": round(got["psnr"], 5),
            "ms_ssim": round(got["ms_ssim"], 5)}


def oracle_ms_ssim(frames, decoded) -> Dict:
    """evaluate_frames' MS-SSIM (per frame and plane, averaged over the
    frames, weighted by the plane's pixel count) computed with the numpy
    oracle (ops/metrics_np.msssim_np, float64) on the host: the check of
    the port's torch MS-SSIM where there is no JAX.  Also the plane
    values, frame by frame."""
    from aivc_tpu_torch.ops.metrics_np import msssim_np

    num, den, planes = 0.0, 0, {}
    for k in ("y", "u", "v"):
        vals = [msssim_np(np.asarray(f[k], np.float64) / 255.0,
                          np.asarray(decoded[i][k], np.float64) / 255.0)
                for i, f in enumerate(frames)]
        planes[k] = vals
        size = np.asarray(frames[0][k]).size
        num += float(np.mean(vals)) * size
        den += size
    return {"ms_ssim": num / den, "planes": planes}


def compare(got: Dict, expect: Dict, limits: Dict) -> Dict:
    """Differences from the pin ({key: (difference, limit)}, bytes
    relative) and whether every one is inside its limit and the decode
    bit-exact."""
    diffs = {"bytes": ((got["bytes"] - expect["bytes"]) / expect["bytes"],
                       limits["bytes"]),
             "psnr": (got["psnr"] - expect["psnr"], limits["psnr"]),
             "ms_ssim": (got["ms_ssim"] - expect["ms_ssim"],
                         limits["ms_ssim"])}
    ok = got["bit_exact"] and all(abs(d) <= lim
                                  for d, lim in diffs.values())
    return {"diffs": diffs, "ok": bool(ok)}


def report_line(name: str, got: Dict, expect: Dict, cmp: Dict) -> str:
    d = cmp["diffs"]
    return (f"[GOLDEN] {name}: {'OK' if cmp['ok'] else 'MISS'}  bytes "
            f"{got['bytes']} (pin {expect['bytes']}, {d['bytes'][0]:+.4%}, "
            f"limit {d['bytes'][1]:.2%})  psnr {got['psnr']:.5f} dB (pin "
            f"{expect['psnr']:.5f}, {d['psnr'][0]:+.5f}, limit "
            f"{d['psnr'][1]})  ms-ssim {got['ms_ssim']:.5f} (pin "
            f"{expect['ms_ssim']:.5f}, {d['ms_ssim'][0]:+.5f}, limit "
            f"{d['ms_ssim'][1]})  decode "
            f"{'bit-exact' if got['bit_exact'] else 'DIFFERS'}  "
            f"{got['seconds']:.1f} s")


def select(names: Optional[List[str]], sanity: bool) -> List[str]:
    pins = suite_pins()
    if names:
        unknown = sorted(set(names) - set(pins))
        if unknown:
            raise ValueError(f"unknown pins {unknown}; known: {list(pins)}")
        chosen = list(names)
    else:
        chosen = [n for n, p in pins.items() if n != SANITY
                  and not p["config"].get("slow")]
    if sanity and SANITY not in chosen:
        chosen.append(SANITY)
    return chosen


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m aivc_tpu_torch.eval.golden",
        description="The golden suite on the port (docs/golden_suite.json, "
                    "docs/golden_sanity.json).")
    ap.add_argument("--pins", nargs="+", metavar="NAME",
                    help="pins to run (default: every pin not marked slow)")
    ap.add_argument("--sanity", action="store_true",
                    help="also the 33-frame pin of docs/golden_sanity.json")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host (host limits) instead of the card")
    args = ap.parse_args(argv)

    import torch

    from aivc_tpu_torch.device import resolve_device

    try:
        device = resolve_device("cpu" if args.cpu else None)
    except RuntimeError:
        print("error: no CUDA device; pass --cpu to run on the host",
              file=sys.stderr)
        return 2
    limits = HOST_LIMITS if device.type == "cpu" else CARD_LIMITS
    where = ("host" if device.type == "cpu"
             else torch.cuda.get_device_name(device))
    pins = suite_pins()
    names = select(args.pins, args.sanity)
    print(f"[GOLDEN] {len(names)} pins on the {where}, limits: bytes "
          f"{limits['bytes']:.2%}, psnr {limits['psnr']} dB, ms-ssim "
          f"{limits['ms_ssim']}", flush=True)
    n_ok = n_miss = n_skip = 0
    for name in names:
        pin = pins[name]
        reason = skip_reason(pin)
        if reason:
            n_skip += 1
            print(f"[GOLDEN] {name}: skipped ({reason})", flush=True)
            continue
        got = run_pin(pin, device)
        cmp = compare(got, pin["expect"], limits)
        n_ok += cmp["ok"]
        n_miss += not cmp["ok"]
        print(report_line(name, got, pin["expect"], cmp), flush=True)
    print(f"[GOLDEN] {n_ok} passed, {n_miss} missed, {n_skip} skipped",
          flush=True)
    return 1 if n_miss else 0


if __name__ == "__main__":
    sys.exit(main())
