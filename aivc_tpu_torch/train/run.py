"""The training entry point, ``python -m aivc_tpu_torch.train`` (the port
of scripts/train_toy.py:276-623): RD training of the codec on synthetic
moving-texture clips (``train/data.py``), with the same flags, defaults,
log line and checkpoint files.

    python -m aivc_tpu_torch.train --cpu --model tiny --size 64 \\
        --steps 3 --out tmp/tiny-run

It runs on the card; ``--cpu`` trains on the host instead.  With no card
and no ``--cpu`` it exits 2 and names the flag.  The latents' training
noise is drawn on the training device from a generator seeded with
(--seed, --step0).

Files: ``<out>/params.msgpack``, ``config.json`` and ``opt_state.msgpack``
(flax's layouts: the JAX package loads them, and resumes from them),
``<out>-ema`` with ``--ema``, and with ``--snapshot_every`` the snapshots
``<out>-s<step>`` (with the optimizer state) and ``<out>-ema-s<step>``.
Exit codes: 0 done, 3 aborted by the health window (nothing saved at or
after the abort), 2 no card.
"""

from __future__ import annotations

import argparse
import contextlib
import math
import sys
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

# Rate-index sampling weights of a 7-point ladder: the extremes are
# oversampled so their gain rows keep up (train_toy.py:451-462).
LADDER_RATE_W = (1.6, 1.35, 1.15, 1.0, 1.0, 1.1, 1.35)
# Steps in the health window (train_toy.py:474-487).
HEALTH_WINDOW = 15


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m aivc_tpu_torch.train",
        description="RD training of the codec on synthetic clips (the "
                    "flags of scripts/train_toy.py)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--step0", type=int, default=0,
                    help="resume the LR schedule at this absolute step "
                         "(the cosine ends at --steps): where no optimizer "
                         "state is loaded, the schedule's count is "
                         "fast-forwarded to it and Adam's stays 0")
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--accum", type=int, default=1,
                    help="microbatches per step: the effective batch is "
                         "batch*accum, activation memory stays at --batch")
    ap.add_argument("--model", default="tiny",
                    choices=["tiny", "base", "bf16"])
    ap.add_argument("--gop", default="1_GOP_2",
                    help="GOP structure name, or a comma-separated list "
                         "sampled per step (e.g. '1_GOP_4,LDP_4')")
    ap.add_argument("--gop_w", default="",
                    help="comma-separated sampling weights matching --gop "
                         "(default uniform)")
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--lr_final", type=float, default=0.0,
                    help="cosine-decay the lr to this value over --steps "
                         "(0 = constant lr)")
    ap.add_argument("--warmup", type=int, default=0,
                    help="linear lr warmup steps")
    ap.add_argument("--out", default="")
    ap.add_argument("--resume", default="",
                    help="checkpoint dir to initialize params from; its "
                         "config drives the run, and its "
                         "opt_state.msgpack is loaded where present")
    ap.add_argument("--save_every", type=int, default=0,
                    help="also save a checkpoint every N steps")
    ap.add_argument("--snapshot_every", type=int, default=0,
                    help="save step-stamped snapshot dirs (<out>-s<step>) "
                         "every N steps")
    ap.add_argument("--dist", default="mse")
    ap.add_argument("--workers", type=int, default=4,
                    help="prefetch threads (each with its own rng slot)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log_every", type=int, default=20)
    ap.add_argument("--alpha_penalty", type=float, default=0.0,
                    help="softplus penalty weight on the positive side of "
                         "the alpha logit")
    ap.add_argument("--flow_penalty", type=float, default=0.0,
                    help="L1 penalty weight on the pre-bound flow logits")
    ap.add_argument("--rate_w", default="",
                    help="comma-separated rate-index sampling weights "
                         "(length n_rates); default: the ladder-extreme "
                         "oversampling")
    ap.add_argument("--ema", type=float, default=0.0,
                    help="decay of an exponential moving average of the "
                         "parameters (0 = off), kept in float32 and saved "
                         "as '<out>-ema' twins")
    ap.add_argument("--health_psnr", type=float, default=4.0,
                    help="abort (rc 3) and refuse checkpoints when the "
                         "mean PSNR of the last 15 applied steps falls "
                         "below this")
    ap.add_argument("--cpu", action="store_true",
                    help="train on the host instead of the card")
    return ap


def _weights(text: str, n: int, what: str, default) -> np.ndarray:
    if text:
        w = np.array([float(v) for v in text.split(",")], np.float64)
        if len(w) != n:
            raise SystemExit(f"{what} needs {n} weights")
        return w
    return np.asarray(default, np.float64)


class Health:
    """The divergence window (train_toy.py:471-498): psnr and flow of the
    last HEALTH_WINDOW applied steps; unhealthy once full with a mean
    psnr at or below ``min_psnr``, or a mean flow above 0.6 of the
    model's flow bound."""

    def __init__(self, min_psnr: float, flow_bound: float):
        self.min_psnr = min_psnr
        self.flow_limit = 0.6 * flow_bound if flow_bound > 0 else math.inf
        self.psnr = deque(maxlen=HEALTH_WINDOW)
        self.flow = deque(maxlen=HEALTH_WINDOW)

    def add(self, logs) -> None:
        """Only applied steps with a finite psnr enter the window: a NaN
        would make its mean NaN and abort a run whose bad step was
        rightly skipped."""
        if logs["step_skipped"] or not math.isfinite(logs["psnr"]):
            return
        self.psnr.append(logs["psnr"])
        if math.isfinite(logs["flow_mag"]):
            self.flow.append(logs["flow_mag"])

    def healthy(self) -> bool:
        if len(self.psnr) < self.psnr.maxlen:
            return True
        if self.flow and sum(self.flow) / len(self.flow) > self.flow_limit:
            return False
        return sum(self.psnr) / len(self.psnr) > self.min_psnr


def log_line(step, idx_rate, logs, accum, seconds) -> str:
    """train_toy.py's per-step line."""
    return (f"step {step:5d}  rate_idx {idx_rate}  "
            f"loss {logs['loss']:.4f}  "
            f"psnr {logs['psnr']:.2f}  "
            f"bpp {logs['rate_bpp']:.4f}  "
            f"gnorm {logs['grad_norm']:.2f}  "
            f"flow {logs['flow_mag']:.2f}/{logs['flow_max']:.1f}  "
            f"alpha {logs['alpha_mean']:.2f}  "
            + (f"mskip {int(logs['micro_skipped'])}  " if accum > 1 else "")
            + f"({seconds:.0f}s)")


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def noise_draw_seconds(shapes, dev: torch.device, seed: int,
                       reps: int = 5) -> float:
    """Seconds to draw one step's noise (the shapes ``shapes``) on ``dev``
    with a fresh generator, averaged over ``reps`` rounds after one
    warm-up round."""
    from aivc_tpu_torch.ops.quantizer import GeneratorNoise

    noise = GeneratorNoise(seed)
    like = [torch.empty(s, device=dev) for s in shapes]

    def draw():
        for t in like:
            noise.uniform(t)

    draw()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        draw()
    sync(dev)
    return (time.perf_counter() - t0) / reps


def clip_maker(seed: int, step0: int, workers: int, gop_lens, gop_p,
               rate_p, batch: int, size: int, photos):
    """-> ``make(slot) -> (frames, idx_rate, gop_index)``: a step's clip
    (train/data.py:make_batch), rate index and GOP drawn from the slot's
    own numpy rng, seeded (seed, slot, step0).  A slot's rng must be
    used by one job at a time (prefetch)."""
    from aivc_tpu_torch.train.data import make_batch

    slot_rngs = [np.random.default_rng([seed, w, step0])
                 for w in range(workers)]

    def make(slot):
        r = slot_rngs[slot]
        gi = int(r.choice(len(gop_lens), p=gop_p))
        return (make_batch(r, gop_lens[gi], batch, size, photos),
                int(r.choice(len(rate_p), p=rate_p)), gi)

    return make


def prefetch(make, workers: int, n: int):
    """Yields ``make(i % workers)`` for i in range(n), in order, computed
    up to ``workers`` jobs ahead in as many threads.  Job i runs on slot
    i % workers, and the next job of a slot is submitted only once its
    previous one has been taken, so each slot has one job in flight and
    a slot's jobs run in order: the results do not depend on the
    threads' timing."""
    ex = ThreadPoolExecutor(max_workers=workers)
    try:
        futs = deque(ex.submit(make, i) for i in range(min(workers, n)))
        for i in range(n):
            out = futs.popleft().result()
            if i + workers < n:
                futs.append(ex.submit(make, (i + workers) % workers))
            yield out
    finally:
        ex.shutdown(wait=True, cancel_futures=True)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from aivc_tpu_torch.device import resolve_device

    try:
        dev = resolve_device("cpu" if args.cpu else None)
    except RuntimeError:
        print("error: no CUDA device; pass --cpu to train on the host",
              file=sys.stderr)
        return 2

    from aivc_tpu_torch.gop import generate_gop_struct
    from aivc_tpu_torch.models.zoo import BASE, BASE_BF16, TINY, init_fullnet
    from aivc_tpu_torch.ops.quantizer import GeneratorNoise
    from aivc_tpu_torch.train.data import photo_pool
    from aivc_tpu_torch.train.trainer import make_optimizer, make_train_step
    from aivc_tpu_torch.utils.checkpoint import (
        load_checkpoint,
        read_opt_state,
        save_checkpoint,
        write_opt_state,
    )

    if args.resume:
        # The checkpoint's own config drives the module, the step and
        # every save (train_toy.py:376-386).
        cfg, model = load_checkpoint(args.resume, device=dev)
        print(f"resumed params from {args.resume} ({cfg.name})")
    else:
        cfg = {"tiny": TINY, "base": BASE, "bf16": BASE_BF16}[args.model]
        gen = torch.Generator().manual_seed(args.seed)
        model = init_fullnet(cfg, gen, device=dev)
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    gop_names = [g.strip() for g in args.gop.split(",") if g.strip()]
    gops = [generate_gop_struct(g) for g in gop_names]
    gop_w = _weights(args.gop_w, len(gops), "--gop_w", np.ones(len(gops)))
    gop_p = gop_w / gop_w.sum()
    opt = make_optimizer(
        params, args.lr, lr_final=args.lr_final or None,
        decay_steps=args.steps if args.lr_final else None,
        warmup_steps=args.warmup)
    loaded_opt = False
    if args.resume:
        opt_path = Path(args.resume) / "opt_state.msgpack"
        if opt_path.exists():
            try:
                read_opt_state(opt_path, opt, names)
                loaded_opt = True
                print("resumed optimizer state")
            except ValueError as e:   # a changed tree: fresh state
                print(f"optimizer state not loadable ({e}); fresh init")
    if args.resume and not loaded_opt and not args.warmup:
        print("WARNING: resuming without optimizer state and without "
              "--warmup: fresh Adam mu/nu takes full-size normalized "
              "steps from step one (the 'resume shock'); consider "
              "--warmup 200", flush=True)
    if args.step0 and not loaded_opt:
        # Only the schedule's count: Adam's mu and nu are fresh, and a
        # fast-forwarded bias-correction count would make the first
        # updates ~3x the intended rate (train_toy.py:424-445).
        if opt.schedule_count is not None:
            opt.schedule_count = args.step0
        print(f"schedule fast-forwarded to step {args.step0}")
    step_fns = [make_train_step(model, cfg, g, opt, dist_loss=args.dist,
                                flow_penalty=args.flow_penalty,
                                alpha_penalty=args.alpha_penalty,
                                accum=args.accum) for g in gops]
    seed_seq = np.random.SeedSequence([args.seed, args.step0])
    noise_seed = int(seed_seq.generate_state(1, np.uint64)[0] >> 1)
    noise = GeneratorNoise(noise_seed)
    n_rates = len(cfg.lambda_tradeoff)
    rate_w = _weights(args.rate_w, n_rates, "--rate_w",
                      LADDER_RATE_W if n_rates == 7 else np.ones(n_rates))
    rate_p = rate_w / rate_w.sum()
    photos = photo_pool()
    print(f"photo pool: {len(photos)} photographs", flush=True)

    workers = max(1, args.workers)
    gen = clip_maker(args.seed, args.step0, workers,
                     [len(g) for g in gops], gop_p, rate_p,
                     args.batch * args.accum, args.size, photos)

    health = Health(args.health_psnr, float(cfg.flow_bound or 0.0))
    ema = None
    if args.ema > 0.0:
        d = float(args.ema)
        ema = {n: p.detach().float().clone()
               for n, p in model.named_parameters()}

    def save(path: Path, with_opt: bool) -> None:
        save_checkpoint(path, cfg, model)
        if with_opt:
            write_opt_state(path / "opt_state.msgpack", opt, names)

    out = Path(args.out) if args.out else None
    step_s, wait_s = [], 0.0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    clips = prefetch(gen, workers, max(0, args.steps - args.step0))
    with contextlib.closing(clips):
        for step in range(args.step0, args.steps):
            tw = time.perf_counter()
            frames_np, idx_rate, gop_i = next(clips)
            wait_s += time.perf_counter() - tw
            ts = time.perf_counter()
            frames = torch.from_numpy(frames_np).permute(
                0, 1, 4, 2, 3).contiguous().to(dev)
            noise.shapes.clear()
            logs = step_fns[gop_i](frames, idx_rate, noise)
            if ema is not None:
                with torch.no_grad():
                    for n, p in model.named_parameters():
                        ema[n].copy_(d * ema[n] + (1.0 - d) * p.float())
            sync(dev)
            step_s.append(time.perf_counter() - ts)
            health.add(logs)
            if logs["step_skipped"]:
                print(f"step {step:5d}  skipped by the guard: loss "
                      f"{logs['loss']:.4g}, psnr {logs['psnr']:.4g}, gnorm "
                      f"{logs['grad_norm']:.4g}, mskip "
                      f"{int(logs['micro_skipped'])}", flush=True)
            if step % args.log_every == 0 or step == args.steps - 1:
                print(log_line(step, idx_rate, logs, args.accum,
                               time.time() - t0), flush=True)
            if not health.healthy():
                print(f"DIVERGED @ step {step}: last-{len(health.psnr)}-step "
                      f"mean psnr {sum(health.psnr) / len(health.psnr):.2f} "
                      f"dB, mean flow "
                      f"{sum(health.flow) / max(len(health.flow), 1):.2f} px "
                      f"(limit {health.flow_limit:.1f}); aborting",
                      flush=True)
                return 3
            if out and args.save_every and step and \
                    step % args.save_every == 0:
                save(out, True)
                print(f"checkpoint @ step {step} -> {out}", flush=True)
            if out and args.snapshot_every and step and \
                    step % args.snapshot_every == 0:
                snap = Path(f"{out}-s{step}")
                save(snap, True)
                if ema is not None:
                    save_checkpoint(f"{out}-ema-s{step}", cfg, ema)
                print(f"snapshot @ step {step} -> {snap}", flush=True)

    if step_s:
        warm = step_s[1:]
        draw_s = noise_draw_seconds(noise.shapes, dev, noise_seed)
        per_step = sum(warm) / len(warm) if warm else step_s[0]
        f32 = cfg.full_float32     # the step's TF32 rule
        peak = (f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB"
                if dev.type == "cuda" else "not measured (host)")
        print(f"timing: {len(step_s)} steps on {dev.type}, first "
              f"{step_s[0]:.3f} s, warm {per_step:.3f} s/step over "
              f"{len(warm)} steps, {wait_s:.3f} s waiting for clips in all; "
              f"noise draw {draw_s * 1e3:.3f} ms a step "
              f"({len(noise.shapes)} draws), {draw_s / per_step:.4f} of a "
              f"warm step; peak device memory {peak}; cudnn benchmark "
              f"{torch.backends.cudnn.benchmark}, deterministic "
              f"{torch.backends.cudnn.deterministic}, TF32 convolutions "
              f"{torch.backends.cudnn.allow_tf32 and not f32}, matmuls "
              f"{torch.backends.cuda.matmul.allow_tf32 and not f32}",
              flush=True)
    if out:
        save(out, True)
        if ema is not None:
            save_checkpoint(f"{out}-ema", cfg, ema)
            print(f"saved EMA twin to {out}-ema")
        print(f"saved checkpoint to {out}")
    return 0
