"""The command line: encode / decode / evaluate / full run
(the port's counterpart of aivc_tpu/cli.py, with the same flags and
defaults and the same [RESULT] lines):

  python -m aivc_tpu_torch -i video_1920x1080_30_420.yuv -o decoded.yuv \
      --bitstream_out video.bin --coding_config RA --gop_size 8 \
      --intra_period 8 --model models_ckpt/bf16-r5 --wave_batch 8

It runs on the card; ``--cpu`` runs every stage on the host instead.
With no card and no ``--cpu`` it exits nonzero.  ``--mode
encode|decode|evaluate`` runs one stage, so encode and decode can run in
separate processes.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="aivc_tpu_torch",
        description="learned video codec on one NVIDIA card "
                    "(PyTorch / CUDA port of aivc_tpu)")
    p.add_argument("-i", "--input", help="input .yuv (name_WxH_fps_420.yuv)")
    p.add_argument("-o", "--output", help="decoded output .yuv path")
    p.add_argument("--bitstream_out", default="bitstream.bin")
    p.add_argument("--coding_config", default="RA", choices=["RA", "LDP", "AI"])
    p.add_argument("--gop_size", type=int, default=16)
    p.add_argument("--intra_period", type=int, default=32)
    p.add_argument("--model", default="tpu-aivc-base",
                   help="zoo name or checkpoint directory")
    p.add_argument("--idx_rate", type=float, default=None,
                   help="override the model's rate index (continuous)")
    p.add_argument("--start_frame", type=int, default=0)
    p.add_argument("--end_frame", type=int, default=-1,
                   help="last frame index, inclusive; -1 = whole file")
    p.add_argument("--mode", default="all",
                   choices=["all", "encode", "decode", "evaluate"])
    p.add_argument("--cpu", action="store_true",
                   help="run every stage on the host instead of the card")
    p.add_argument("--rng_seed", type=int, default=None,
                   help="accepted for reference flag parity (src/aivc.py:"
                        "71-73); unused: encoder and decoder run the same "
                        "deterministic code, so no seed is needed")
    p.add_argument("--bitstream_debug", action="store_true",
                   help="per-chunk AC lossless self-check, rate overhead "
                        "report, and encoder/decoder md5 drift manifest")
    p.add_argument("--log_dir", default="",
                   help="write per-frame results (detailed.txt + .jsonl)")
    p.add_argument("--wave_batch", type=int, default=1,
                   help="encode temporal waves as device batches of up to "
                        "N frames; recorded in the video header, so decode "
                        "reads it from the bitstream")
    p.add_argument("--stream_dir", default="",
                   help="crash-salvageable encode: write each finished GOP "
                        "chunk here atomically; rerunning with the same "
                        "directory resumes, re-encoding only missing GOPs")
    p.add_argument("--rate_audit", action="store_true",
                   help="report sequence-level analytic-vs-real rate "
                        "overhead (estimated bits under the coder's own "
                        "CDFs vs bytes written)")
    p.add_argument("--rate_priority", action="store_true",
                   help="favor bitstream size over speed: drop the rANS "
                        "stream-count floor so the per-frame state flush "
                        "stays ~1%% of the payload (RD sweeps)")
    p.add_argument("--entropy_backend", default="device",
                   choices=["device", "host"],
                   help="latent entropy coder for ENCODING: the card's "
                        "interleaved rANS (device) or the host C rANS; "
                        "decoding always honours the bitstream's header")
    return p


def _load_model(name: str, device):
    """-> (cfg, FullNet, default idx_rate).  A directory is a checkpoint;
    a trained-ladder name needs its checkpoint on disk (another model is
    never substituted); other names are random-init zoo configs."""
    import torch

    from aivc_tpu_torch.models import zoo
    from aivc_tpu_torch.utils.checkpoint import load_checkpoint

    if Path(name).is_dir():
        cfg, model = load_checkpoint(name, device=device)
        return cfg, model, 0.0
    if name in zoo.TRAINED_LADDER:
        trained = zoo.load_trained(name, device=device)
        if trained is None:
            raise ValueError(
                f"--model {name} needs {zoo.TRAINED_LADDER[name]['ckpt']}, "
                f"which is not on disk")
        return trained
    cfg, idx_rate = zoo.get_model(name)
    model = zoo.init_fullnet(cfg, torch.Generator().manual_seed(0),
                             device=device)
    return cfg, model, idx_rate


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from aivc_tpu_torch.device import resolve_device

    try:
        dev = resolve_device("cpu" if args.cpu else None)
    except RuntimeError:
        print("error: no CUDA device; pass --cpu to run on the host",
              file=sys.stderr)
        return 2

    from aivc_tpu_torch.config import CodingConfig
    from aivc_tpu_torch.io.yuv import YuvReader, YuvWriter
    from aivc_tpu_torch.pipeline.codec import make_codec
    from aivc_tpu_torch.pipeline.video import (
        decode_video,
        encode_video,
        evaluate_frames,
    )

    try:
        cfg, model, default_rate = _load_model(args.model, dev)
    except (KeyError, ValueError) as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 1
    idx_rate = args.idx_rate if args.idx_rate is not None else default_rate

    if args.mode in ("all", "encode", "evaluate"):
        if not args.input:
            print("error: --input required", file=sys.stderr)
            return 1
        reader = YuvReader(args.input)
        end = reader.n_frames - 1 if args.end_frame < 0 else args.end_frame
        frames = [reader.read_frame(i)
                  for i in range(args.start_frame, end + 1)]
        h, w = reader.height, reader.width
    else:
        frames = None

    coding = CodingConfig(
        coding_config=args.coding_config, gop_size=args.gop_size,
        intra_period=args.intra_period, idx_rate=idx_rate,
        start_frame=args.start_frame, end_frame=args.end_frame)

    decoded = None
    if args.mode in ("all", "encode"):
        codec = make_codec(cfg, model, h, w, device=dev,
                           debug=args.bitstream_debug,
                           entropy_backend=args.entropy_backend,
                           rate_priority=args.rate_priority,
                           audit=args.rate_audit)
        t0 = time.time()
        res = encode_video(codec, frames, coding, wave_batch=args.wave_batch,
                           stream_dir=args.stream_dir or None)
        dt = time.time() - t0
        Path(args.bitstream_out).write_bytes(res.bitstream)
        if args.log_dir:
            from aivc_tpu_torch.utils.logging import FrameResultLogger

            logger = FrameResultLogger(args.log_dir)
            for fr in res.frame_results:
                logger.log(fr)
            logger.close()
        if args.bitstream_debug:
            from aivc_tpu_torch.utils.debug import write_md5_manifest

            write_md5_manifest(res.decoded_frames,
                               args.bitstream_out + ".md5.json")
        if args.rate_audit:
            analytic = sum(fr.analytic_bits for fr in res.frame_results)
            real = sum(fr.bytes for fr in res.frame_results) * 8.0
            over = 100.0 * (real - analytic) / max(analytic, 1e-9)
            print(f"[RESULT] analytic rate bits   : {analytic:.0f}")
            print(f"[RESULT] real rate bits       : {real:.0f}")
            print(f"[RESULT] container overhead   : {over:.2f} %")
        n_pix = h * w
        print(f"[RESULT] bitstream bytes      : {res.total_bytes}")
        print(f"[RESULT] rate bpp             : "
              f"{res.total_bytes * 8 / (n_pix * len(frames)):.4f}")
        print(f"[RESULT] encoding fps         : {len(frames) / dt:.2f}")

    if args.mode in ("all", "decode"):
        data = Path(args.bitstream_out).read_bytes()
        from aivc_tpu_torch.coding.bitstream import VideoHeader

        header = VideoHeader.unpack(data[:VideoHeader.SIZE])
        codec = make_codec(cfg, model, header.h_x, header.w_x, device=dev)
        t0 = time.time()
        decoded = decode_video(codec, data)  # wave_batch from the header
        for i in decoded:
            decoded[i].planes  # the planes reach the host inside the timing
        dt = time.time() - t0
        print(f"[RESULT] decoding fps         : {len(decoded) / dt:.2f}")
        manifest = Path(args.bitstream_out + ".md5.json")
        if args.bitstream_debug and manifest.exists():
            from aivc_tpu_torch.utils.debug import check_md5_manifest

            ok = check_md5_manifest(decoded, manifest)
            print(f"[RESULT] enc/dec drift check  : "
                  f"{'identical' if ok else 'MISMATCH'}")
        if args.output:
            with YuvWriter(args.output) as wr:
                for i in sorted(decoded):
                    wr.write_frame(decoded[i])

    if args.mode in ("all", "evaluate"):
        if decoded is None:
            if not args.output:
                print("error: evaluate needs --output (decoded yuv)",
                      file=sys.stderr)
                return 1
            dec_reader = YuvReader(args.output, reader.width, reader.height)
            decoded = {i: dec_reader.read_frame(i)
                       for i in range(dec_reader.n_frames)}
        metrics = evaluate_frames(frames, decoded, device=dev)
        print(f"[RESULT] psnr                 : {metrics['psnr']:.5f} dB")
        print(f"[RESULT] ms-ssim              : {metrics['ms_ssim']:.5f}")
        print(f"[RESULT] ms-ssim db           : {metrics['ms_ssim_db']:.5f} dB")

    return 0


if __name__ == "__main__":
    sys.exit(main())
