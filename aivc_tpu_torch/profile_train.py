"""Where a training step's time goes on the card, run on demand.

    python -m aivc_tpu_torch.profile_train [--dist mse]

The step of the round-5 recipe (chip_smoke.py's train-recipe, its shape
from smoke.recipe_argv: bf16-r5, 192x192, batch 2 per microbatch, accum
4, 1_GOP_4, ms_ssim unless --dist says otherwise, the trainer's own
cuDNN settings, no AIVC_WARP) on clips from train/data.py made before
the timing, so no clip generator runs beside it.  Two steps warm it up;
STEPS steps are timed on the host clock (each ends in a synchronize);
then the parts of a step one at a time: one microbatch's forward and its
backward, and the optimizer's update; then one step under
torch.profiler.  Prints one JSON object: the card's name and power
limit, the seconds of each timed step and of each part, the host's
seconds to make one step's clips, the profiled wall time, the device's
busy time (the union of its kernels' spans) and its share of the mean
unprofiled step (``busy_share``), the number of kernels the step
launched and those that took the most device time.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
STEPS = 3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dist", default="ms_ssim")
    dist = ap.parse_args().dist
    from aivc_tpu_torch import smoke
    from aivc_tpu_torch.device import float32_precision
    from aivc_tpu_torch.gop import generate_gop_struct
    from aivc_tpu_torch.ops.quantizer import GeneratorNoise
    from aivc_tpu_torch.profile_forward import profile_call
    from aivc_tpu_torch.train.data import make_batch
    from aivc_tpu_torch.train.loss import gop_rd_loss
    from aivc_tpu_torch.train.run import build_parser
    from aivc_tpu_torch.train.trainer import make_optimizer, make_train_step
    from aivc_tpu_torch.utils.checkpoint import load_checkpoint

    ckpt = ROOT / "models_ckpt" / "bf16-r5"
    args = build_parser().parse_args(smoke.recipe_argv(str(ckpt), ""))
    dev = torch.device("cuda")
    cfg, model = load_checkpoint(ckpt, device=dev)
    params = [p for _, p in model.named_parameters()]
    opt = make_optimizer(params, args.lr)
    gop = generate_gop_struct(args.gop)
    step = make_train_step(model, cfg, gop, opt, dist_loss=dist,
                           accum=args.accum)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    clips = [make_batch(rng, len(gop), args.batch * args.accum, args.size)
             for _ in range(STEPS + 4)]
    make_s = (time.perf_counter() - t0) / len(clips)
    clips = [torch.from_numpy(c).permute(0, 1, 4, 2, 3).contiguous().to(dev)
             for c in clips]
    noise = GeneratorNoise(1)
    for i in range(2):
        step(clips[i], 3, noise)
    step_s = []
    for i in range(STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(clips[2 + i], 3, noise)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    lam = float(np.float32(cfg.lambda_tradeoff[3]))
    micro = clips[2 + STEPS][:, :args.batch]
    torch.cuda.synchronize()
    with float32_precision(cfg):      # the step's own rule
        t0 = time.perf_counter()
        loss, _ = gop_rd_loss(model, list(micro), gop, 3.0, lam, lam,
                              dist_loss=dist, training=True, noise=noise)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    opt.update([p.grad for p in params])
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    prof = profile_call(step, clips[3 + STEPS], 3, noise, top=10)
    out = {"card": smoke.device_info()["smi"], "size": args.size,
           "batch": args.batch, "accum": args.accum, "gop": args.gop,
           "dist": dist,
           "step_s": step_s, "mean_step_s": sum(step_s) / len(step_s),
           "micro_forward_s": t1 - t0, "micro_backward_s": t2 - t1,
           "update_s": t3 - t2, "clips_host_s": make_s,
           "cudnn": {"benchmark": torch.backends.cudnn.benchmark,
                     "deterministic": torch.backends.cudnn.deterministic,
                     "allow_tf32": torch.backends.cudnn.allow_tf32},
           **prof}
    if "device_busy_ms" in prof:
        out["busy_share"] = prof["device_busy_ms"] / 1e3 / out["mean_step_s"]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
