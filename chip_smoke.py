"""Smoke run of the port's paths on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from aivc_tpu_torch/csrc and drives, through the
port's entry points with models_ckpt/bf16-r5:

* the coding path: K1-K3 checked against their plain PyTorch versions at
  the 1080p shapes, then a 9-frame 1080p RA clip (GOP 8) encoded and
  decoded, the decode checked bit for bit, and a 64x64 clip on the card
  against the host;
* the RD forward path: gop_rd_loss in eval mode on a 9-frame 720p GOP
  (edge-padded to 1280x768) with AIVC_WARP=pallas, whose float warps
  launch K5; a 128x128 GOP on the card against the host; then K5 checked
  against its plain version at the forward path's shapes, on random flows
  and on the flows of one B-frame launch captured in the warm-up forward
  (timed warm and with L2 cold), and K4 (the exported gdn_fused, which no
  model calls, as gdn_pallas in JAX) run on the inputs of six CodecNet GDN
  layers captured during the forward and checked against its plain
  version (bf16: on the tensor cores, within 2 bf16 ulps).

The main phase also prints the steps K1 walked in the clip's encode and
K2 in its decode, with their estimated shares of the encode and decode
times; then it encodes the clip once more to capture the inputs of one of
K3's launches (a B-frame wave: the clip's own flows), and checks and times
K3 on them.

The training phases (no kernel lies on their path): train-small, one
make_train_step step of bf16-r5 (128x128, batch 2, accum 2, 1_GOP_2,
ms_ssim) on the card and on the host with the same frames and noise,
whose logs and gradient vectors must agree within smoke.py's limits; then
train-recipe, ``python -m aivc_tpu_torch.train`` with the round-5
continuation recipe at 192x192 for 6 steps in a subprocess (a temporary
--out under tmp/), whose losses must be finite, whose checkpoint,
optimizer state and EMA twin must reload through the port's reader with
moved parameters, and whose checkpoint's eval forward must be finite.

The CLI phase writes the same 9 frames to a temporary
clip_1920x1080_30_420.yuv and runs ``python -m aivc_tpu_torch``'s main
on it (``smoke.cli_runs``): RA with --rate_audit, whose bitstream file
must equal the main phase's stream byte for byte and which a second
process (``python -m aivc_tpu_torch --mode decode --bitstream_debug``)
decodes against the md5 manifest of its encoder's reconstructions
("identical"); RA with --bitstream_debug, decoded here and in a second
process; All-Intra with --wave_batch 8; LDP; --entropy_backend host
(K1 and K2 never launch); --stream_dir (a GOP chunk deleted, the encode
run again: the same bytes); --rate_priority with --rate_audit, whose
deepest K1 launch is captured and K1 and K2 checked against their plain
versions on it and timed per step; ladder name 5 (gain surgery), and
name 7 refused where its checkpoint is absent.  Every run's decode is
held against its encoder's reconstruction, and each prints its bytes,
bpp, PSNR, MS-SSIM, encode and decode fps and the kernels' launches.

The golden phase runs the golden suite's pins (docs/golden_suite.json,
docs/golden_sanity.json; aivc_tpu_torch/eval/golden.py) on the card:
ai_240p, ra_240p, ldp_240p, ra_720p, ra_1080p and the 33-frame sanity pin
on clips made from the committed held-out photographs, each decoded bit
for bit against its encoder's reconstruction, held against its pin's
bytes, PSNR and MS-SSIM within golden.CARD_LIMITS, its MS-SSIM held
against the numpy oracle (ops/metrics_np.msssim_np) on the host, with
K1-K3's launches per pin; ra_240p_lowrate is reported as skipped where
models_ckpt/bf16-lr is not in the checkout.  The formats phase codes the
9-frame 1080p clip as the default v2 stream, as the dense v1 stream
(AIVC_VRANS_ELIDE=0), whose deepest K1 launch and every K2 launch are
held against their plain versions, and under AIVC_GDN_LOWP=0
AIVC_DC_OFFSET=0 (schedule byte 0x0d), each decoded bit-exactly, with
bytes, fps and launches side by side; the v2 stream handed to the 0x0d
codec must raise the schedule error.

Every phase prints its elapsed seconds.  The last lines are the card's
name and power limit, the kernels' JSON record and the result; any failed
check raises (nonzero exit).  Exits nonzero, printing no result, when
there is no CUDA device.
"""

import json
import os
import sys
import tempfile
import time
from pathlib import Path

import torch

CKPT = "models_ckpt/bf16-r5"
H, W = 1080, 1920
N_FRAMES, GOP, WAVE_BATCH = 9, 8, 8
FH, FW = 720, 1280
IDX_RATE = 0.0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # Read when the package's warp module is imported, as in JAX.
    os.environ["AIVC_WARP"] = "pallas"
    from aivc_tpu_torch import kernels, smoke
    from aivc_tpu_torch.eval import golden
    from aivc_tpu_torch.ops import warp as warp_ops
    from aivc_tpu_torch.pipeline.codec import FrameCodec
    from aivc_tpu_torch.pipeline.video import frames_444, synthetic_frames
    from aivc_tpu_torch.utils.checkpoint import load_checkpoint

    if not warp_ops._USE_PALLAS:
        raise RuntimeError("AIVC_WARP=pallas was not read at import")
    root = Path(__file__).resolve().parent
    ckpt = str(root / CKPT)
    ph = smoke.Phases(lambda m: print(m, flush=True))
    dev = torch.device("cuda")

    info = smoke.device_info()
    ph.say(f"device: {info['kind']} x{info['count']}")
    ph.say(f"nvidia-smi: {info['smi']}")

    rep = smoke.build_report()
    ph.say(f"build: nvcc {rep['seconds']:.1f}s (cached={rep['cached']}), "
           f"with the host range coder's g++ beside it "
           f"{rep['both_seconds']:.1f}s")
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
               f"{r['ms']:.4f} ms (plain {r['plain_ms']:.3f} ms, bound "
               f"{r['bound_ms']:.4f} ms by {r['bound_by']}, library "
               f"{r['library_ms']})")
    for r in records[:2]:
        ph.say(f"kernel {r['name']}: {r['steps']} dependent steps per "
               f"launch, {r['us_per_step']:.4f} us per step")

    # -- coding path ------------------------------------------------------
    frames = synthetic_frames(N_FRAMES, H, W)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    res = smoke.code_clip(codec, frames, wave_batch=WAVE_BATCH, gop=GOP)
    main_launches = dict(kernels.LAUNCHES)
    ph.say(f"main: {N_FRAMES} frames {W}x{H} RA GOP{GOP}: {res['bytes']} B, "
           f"{res['bpp']:.5f} bpp, PSNR {res['psnr']:.4f} dB, MS-SSIM "
           f"{res['ms_ssim']:.6f}, encode {res['encode_fps']:.3f} fps, "
           f"decode {res['decode_fps']:.3f} fps, peak memory "
           f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
           f"launches {main_launches}")
    ph.say(f"main: frame bytes {res['frame_bytes']}")
    k1_us = records[0]["us_per_step"]
    ph.say(f"main: rans_encode walked {res['encode_steps']} steps in the "
           f"encode; at {k1_us:.4f} us per step that is "
           f"{res['encode_steps'] * k1_us / 1e3:.3f} ms, an estimated share "
           f"{res['encode_steps'] * k1_us / 1e6 / res['encode_s']:.4f} of "
           f"the {res['encode_s'] * 1e3:.1f} ms encode")
    k2_us = records[1]["us_per_step"]
    ph.say(f"main: rans_decode walked {res['decode_steps']} steps in the "
           f"decode; at {k2_us:.4f} us per step that is "
           f"{res['decode_steps'] * k2_us / 1e3:.3f} ms, an estimated "
           f"{res['decode_steps'] * k2_us / 1e6 / res['decode_s']:.4f} of "
           f"the {res['decode_s'] * 1e3:.1f} ms decode")
    missing = [k for k in ("rans_encode", "rans_decode", "warp_packed")
               if main_launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    cap = smoke.check_warp_on(smoke.capture_encode_warp(
        codec, frames, wave_batch=WAVE_BATCH, gop=GOP))
    ph.say(f"kernel warp_packed on the flows of one encode-side launch "
           f"{cap['shape']} (|flow| <= {cap['max_flow']:.3f}): "
           f"bit-identical to its plain version; {cap['ms']:.4f} ms (bound "
           f"{cap['bound_ms']:.4f} ms; random flows {records[2]['ms']:.4f} "
           f"ms on {batch} frames)")
    del codec

    # -- CLI path ---------------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        runs = smoke.cli_runs(frames, ckpt, tmp, dev, root, res["bitstream"],
                              ph.say)
    for name, r in runs.items():
        if "results" not in r:
            ph.say(f"cli {name}: {r}")
            continue
        q = r["results"]
        ph.say(f"cli {name}: {q.get('bitstream bytes', '-')} B, "
               f"{q.get('rate bpp', '-')} bpp, PSNR {q.get('psnr', '-')}, "
               f"MS-SSIM {q.get('ms-ssim', '-')}, encode "
               f"{q.get('encoding fps', '-')} fps, decode "
               f"{q.get('decoding fps', '-')} fps, {r['checked']} frames "
               f"decoded = encoder reconstruction, {r['seconds']:.2f} s, "
               f"launches {r['launches']}, steps {r['steps']}")
        for key in ("analytic rate bits", "real rate bits",
                    "container overhead"):
            if key in q:
                ph.say(f"cli {name}: {key} {q[key]}")
        sep = r.get("decode_process")
        if sep:
            ph.say(f"cli {name}: decoded in a second process in "
                   f"{sep['seconds']:.2f} s: decoding fps "
                   f"{sep['results']['decoding fps']}, drift check "
                   f"{sep['results']['enc/dec drift check']}")
    if runs["ra"]["results"]["bitstream bytes"] != str(res["bytes"]):
        raise AssertionError("cli RA bytes differ from the main phase's")
    captured = runs["priority"].pop("captured")
    if captured is None:
        raise AssertionError("no rans_encode launch in the rate-priority run")
    rp = smoke.check_rans_on(captured)
    ph.say(f"kernel rans_encode / rans_decode at the rate-priority shape "
           f"{rp['shape']} (K {rp['k']}, {rp['steps']} dependent steps): "
           f"bit-identical to their plain versions on the first "
           f"{rp['checked_steps']} steps (plain {rp['plain_enc_s']:.2f} s / "
           f"{rp['plain_dec_s']:.2f} s); K1 {rp['enc_ms']:.3f} ms = "
           f"{rp['enc_us_per_step']:.4f} us per step, K2 {rp['dec_ms']:.3f} "
           f"ms = {rp['dec_us_per_step']:.4f} us per step")
    del captured

    small = smoke.small_agreement(ckpt, dev)
    ph.say(f"small: 64x64 device {small['device']['bytes']} B / "
           f"{small['device']['psnr']:.4f} dB vs host "
           f"{small['host']['bytes']} B / {small['host']['psnr']:.4f} dB")

    # -- RD forward path --------------------------------------------------
    fcfg, fmodel = load_checkpoint(ckpt, device=dev)
    f444 = frames_444(synthetic_frames(N_FRAMES, FH, FW, seed=3), dev)
    n_warps = smoke.warp_calls(smoke.FORWARD_GOP)
    warm, k5_inputs = smoke.capture_forward_warp(fmodel, fcfg, f444,
                                                 IDX_RATE)
    ph.say(f"forward: warm-up {warm['seconds']:.3f} s (first use of every "
           f"shape; copies the inputs of K5 launch "
           f"{smoke.first_b_warp(smoke.FORWARD_GOP)}, a B-frame's)")
    watch = smoke.GdnWatch(fmodel, capture=smoke.GDN_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    fwd = smoke.rd_forward(fmodel, fcfg, f444, IDX_RATE)
    fwd_launches = dict(kernels.LAUNCHES)
    watch.close()
    ph.say(f"forward: gop_rd_loss eval, {smoke.FORWARD_GOP}, {FW}x{FH} "
           f"padded to {f444[0].shape[3]}x{f444[0].shape[2]}, idx_rate "
           f"{IDX_RATE}, dist {fcfg.dist_loss}: {fwd['fps']:.3f} frames/s "
           f"({fwd['seconds']:.3f} s), peak memory "
           f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
           f"launches {fwd_launches}")
    ph.say(f"forward: logs {json.dumps(fwd['logs'])}")
    if fwd_launches["warp_vclamped"] != n_warps:
        raise AssertionError(f"warp_vclamped launched "
                             f"{fwd_launches['warp_vclamped']} times for "
                             f"{n_warps} float warps")
    if sorted(watch.inputs) != sorted(smoke.GDN_LAYERS):
        raise AssertionError(f"captured GDN inputs: {sorted(watch.inputs)}")

    fsmall = smoke.forward_small(ckpt, dev, IDX_RATE)
    diffs = smoke.compare_logs(fsmall["device"], fsmall["host"],
                               smoke.FORWARD_SMALL_TOL, "forward-small")
    ph.say(f"forward-small: 128x128 device {json.dumps(fsmall['device'])}")
    ph.say(f"forward-small: 128x128 host {json.dumps(fsmall['host'])}")
    ph.say(f"forward-small: differences {diffs}")

    rec5 = smoke.check_warp_vclamped(dev, f444[0].shape[2],
                                     f444[0].shape[3])
    cap5 = smoke.check_warp_vclamped_on(k5_inputs)
    rec4 = smoke.check_gdn(watch.inputs)
    ph.say(f"kernel warp_vclamped: bit-identical to its plain version "
           f"({rec5['clamped_share']:.3f} of the pixels past the vertical "
           f"clamp); {rec5['ms']:.4f} ms (plain {rec5['plain_ms']:.3f} ms, "
           f"bound {rec5['bound_ms']:.4f} ms by {rec5['bound_by']}, library "
           f"{rec5['library_ms']:.4f} ms)")
    ph.say(f"kernel warp_vclamped on the flows of one B-frame launch of the "
           f"forward {cap5['shape']} (max |u| {cap5['max_u']:.3f}, max |v| "
           f"{cap5['max_v']:.3f}, {cap5['clamped_share']:.6f} of the pixels "
           f"past the vertical clamp): bit-identical to its plain version; "
           f"{cap5['ms']:.4f} ms, L2 cold {cap5['cold_ms']:.4f} ms (bound "
           f"{cap5['bound_ms']:.4f} ms)")
    for name, shape, err, ulps, rel in rec4["inputs"]:
        ph.say(f"kernel gdn_fused on {name} {list(shape)}: {err} ({ulps} "
               f"bf16 ulps) from its plain version, {rel:.3e} relative "
               f"from gdn_apply")
    ph.say(f"kernel gdn_fused: against its plain version at most "
           f"{rec4['max_ulps']} bf16 ulps (limit {smoke.GDN_PLAIN_ULPS}), "
           f"{rec4['max_rel_err']:.4e} relative, "
           f"{rec4['differing_share']:.3e} of the outputs differ (limit "
           f"{smoke.GDN_DIFFERING_SHARE})")
    ph.say(f"kernel gdn_fused: {rec4['ms']:.4f} ms on {rec4['timed_on']} "
           f"(plain {rec4['plain_ms']:.3f} ms, bound {rec4['bound_ms']:.4f} "
           f"ms by {rec4['bound_by']}, library {rec4['library_ms']:.4f} ms)")
    if rec4["launches"] != len(smoke.GDN_LAYERS):
        raise AssertionError(f"gdn_fused launched {rec4['launches']} times "
                             f"on {len(smoke.GDN_LAYERS)} GDN inputs")
    records += [rec4, rec5]

    # -- training path ----------------------------------------------------
    # No kernel lies on it: the training forward takes the plain float
    # warp (K5 has no gradient, in JAX as here) and the GDN layers
    # gdn_apply.  Both phases run after the launch counts were read.
    tsm = smoke.train_small(ckpt, dev)
    for prec, t in (("bf16", tsm), ("float32", tsm["f32"])):
        for name in ("device", "host"):
            q = t[name]
            ph.say(f"train-small: 128x128 {prec} {name}: loss "
                   f"{q['loss']:.6f}, rate_bpp {q['rate_bpp']:.6f}, psnr "
                   f"{q['psnr']:.4f}, grad norm {q['grad_norm']:.4f}, "
                   f"micro_skipped {q['micro_skipped']:.0f}, largest "
                   f"parameter change {q['max_param_change']:.3e}, "
                   f"{q['seconds']:.2f} s")
        wr, wc = t["worst_leaf_rel_l2"], t["worst_leaf_cosine"]
        ph.say(f"train-small: {prec} differences {t['diffs']}; gradients "
               f"of {t['n_params']} parameters: cosine {t['cosine']:.6f}, "
               f"relative L2 {t['rel_l2']:.4e}; of {t['n_leaves']} leaves "
               f"the worst: relative L2 {wr[1]:.4e} ({wr[0]}), cosine "
               f"{wc[2]:.6f} ({wc[0]})")
    ph.say(f"train-small: limits: bf16 cosine >= "
           f"{smoke.TRAIN_SMALL_MIN_COSINE} and relative L2 <= "
           f"{smoke.TRAIN_SMALL_MAX_REL_L2} on the whole vector; float32 "
           f"every leaf relative L2 <= "
           f"{smoke.TRAIN_SMALL_F32_LEAF_MAX_REL_L2} and cosine >= "
           f"{smoke.TRAIN_SMALL_F32_LEAF_MIN_COSINE}")
    (root / "tmp").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root / "tmp") as tmp:
        rec = smoke.train_recipe(ckpt, str(Path(tmp) / "r5-port"), root,
                                 dev)
    for line in rec["lines"]:
        ph.say(f"train-recipe: {line}")
    sizes = {k: round(v, 1) for k, v in rec["file_mb"].items()}
    ph.say(f"train-recipe: on {info['smi']}: {rec['timing']}")
    ph.say(f"train-recipe: {len(rec['losses'])} steps in a subprocess "
           f"({rec['wall_s']:.1f} s wall), {rec['skipped']} skipped; "
           f"largest parameter change from {CKPT} "
           f"{rec['max_param_change']:.3e}, EMA twin "
           f"{rec['ema_max_change']:.3e}; optimizer counts "
           f"{rec['opt_count']} / {rec['schedule_count']}; files (MiB) "
           f"{json.dumps(sizes)}")
    ph.say(f"train-recipe: the written checkpoint's eval forward at 128x128 "
           f"{json.dumps(rec['forward_logs'])}")

    # -- golden suite ----------------------------------------------------
    t_phase = time.time()
    gold = smoke.golden_runs(dev, say=ph.say)
    ran = [n for n, r in gold.items() if "skipped" not in r]
    ph.say(f"golden: {len(ran)} pins within the card's limits "
           f"{golden.CARD_LIMITS}, each decode bit-exact, "
           f"{len(gold) - len(ran)} skipped; worst |MS-SSIM - oracle| "
           f"{max(gold[n]['oracle_err'] for n in ran):.2e}; "
           f"{time.time() - t_phase:.1f} s")

    # -- stream formats ---------------------------------------------------
    t_phase = time.time()
    fmt = smoke.formats_runs(ckpt, frames, dev, wave_batch=WAVE_BATCH,
                             gop=GOP)
    for name in ("v2", "v1", "sched"):
        r = fmt[name]
        ph.say(f"formats {name}: schedule {r['sched']:#04x}, "
               f"{'v2 elided' if r['elide'] else 'dense v1'} fused stream, "
               f"{r['bytes']} B, PSNR {r['psnr']:.4f} dB, MS-SSIM "
               f"{r['ms_ssim']:.6f}, encode {r['encode_fps']:.3f} fps, "
               f"decode {r['decode_fps']:.3f} fps, decode bit-exact, "
               f"launches {r['launches']}, K1 steps {r['encode_steps']}, "
               f"K2 steps {r['decode_steps']}")
    v1 = fmt["v1"]
    if v1["launches"]["rans_encode"] == 0 or \
            v1["launches"]["rans_decode"] == 0:
        raise AssertionError(f"the v1 stream launched {v1['launches']}")
    if v1["captured_enc"] is None or not v1["captured_dec"]:
        raise AssertionError("no K1 / K2 launch captured on the v1 path")
    enc1 = smoke.check_encode_launch(v1.pop("captured_enc"))
    dec1 = smoke.check_decode_launches(v1.pop("captured_dec"))
    ph.say(f"formats v1: kernel rans_encode on its deepest launch "
           f"{enc1['shape']} (K {enc1['k']}, segments {enc1['segments']} "
           f"steps): bit-identical to its plain version (plain "
           f"{enc1['plain_s']:.2f} s); kernel rans_decode on all its "
           f"{dec1['launches']} launches (rows, K): bit-identical to its "
           f"plain version: {dec1['shapes']}")
    ph.say(f"formats: a v2 stream handed to the 0x0d codec: {fmt['refused']}")
    ph.say(f"formats: {time.time() - t_phase:.1f} s")

    launches = {k: main_launches[k]
                for k in ("rans_encode", "rans_decode", "warp_packed")}
    launches["warp_vclamped"] = fwd_launches["warp_vclamped"]
    launches["gdn_fused"] = rec4["launches"]
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
