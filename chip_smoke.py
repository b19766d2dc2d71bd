"""Smoke run of the port's paths on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from aivc_tpu_torch/csrc and drives, through the
port's entry points with models_ckpt/bf16-r5:

* the coding path: K1-K3 checked against their plain PyTorch versions at
  the 1080p shapes, then a 9-frame 1080p RA clip (GOP 8) encoded and
  decoded, the decode checked bit for bit, with the share of the GDN
  layers' calls that took K4, and a 64x64 clip on the card against the
  host;
* the RD forward path: gop_rd_loss in eval mode on a 9-frame 720p GOP
  (edge-padded to 1280x768) with AIVC_WARP=pallas, whose float warps
  launch K5; a 128x128 GOP on the card against the host; then K5 checked
  against its plain version at the forward path's shapes, on random flows
  and on the flows of one B-frame launch captured in the warm-up forward
  (timed warm and with L2 cold), and K4 (the exported gdn_fused, which no
  model calls, as gdn_pallas in JAX) run on the inputs of six CodecNet GDN
  layers captured during the forward and checked against its plain
  version (bf16: on the tensor cores, within 2 bf16 ulps); then the GDN
  layers' kernel (gdn_layer_cuda, K4 at gdn_apply's rounding points) with
  the checkpoint's parameters at the codec's largest 1080p shapes, a wave
  of 8, with and without lowp, every image against its plain version,
  timed against its bound and gdn_apply, and on the same input
  channels-last (the bf16 nets' layout), bit for bit as NCHW; then the
  conv stage K6 (ops/layers.py:pad_stage_cuda) at the codec's shapes, bit
  for bit against its plain version, timed against its byte bound, its
  plain version and the library passes it replaced; then K7
  (ops/conv1x1.py, ELIC's 1x1 convs with their bias and epilogue) at
  ELIC-N192-M320's six widths and 1080p shapes, within one bf16 ulp of
  the first rounding of its plain version, timed the same way; then one
  All-Intra wave of ELIC-N192-M320 (seeded weights) coded and decoded
  bit-exactly, with the share of its 1x1 convs that took K7, which must
  be 1.

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

The multidevice phase (``smoke.multidevice_runs``) runs two ranks, one
process each, on the one card over gloo (NCCL refuses two ranks on one
GPU; gloo's gathers go through host copies), started by
aivc_tpu_torch/parallel/launch.py, against this process: (a) the GOP
round-robin (parallel/multihost.py) of a 17-frame 1080p RA clip (GOP 4,
wave batch 4) with AIVC_VRANS_K pinned, equal byte for byte to this
process's pinned encode, and free, whose difference (bytes, the K of
each frame) is printed, both decoded here bit-exactly against the ranks'
reconstructions, with the warm encode seconds of one process and of the
two ranks; (b) the 9-frame clip through FrameCodec(mesh=...) with data 2
(a B wave of 4 split 2 and 2), its own decode bit-exact, its bytes and
PSNR against the main phase's stream, whether this process decodes it
bit-exactly, and the seconds of the host-side gathers; (c) train-small
in float32 over the two ranks against this process, in both layouts of
the step over 'data' (accum 2: a whole microbatch a rank; accum 1: the
microbatch of 2 split a sample a rank), within train-small's float32
limits, with the parameters after the update equal on both ranks, and in the same ranks (d) the spatial
part: the 9-frame clip through FrameCodec(mesh=make_mesh(2, spatial=2))
(bands of 544 rows, 34 at the y level: each rank runs the nets on its
band with hand-written halo exchanges, K3 on its row window), its own
decode bit-exact, its bytes and PSNR against one process's, in how many
frames one process's decode of it differs, and per rank its K1-K3
launches, halo-exchange and row-gather seconds and peak memory; one K3
launch on the second band (row0 544) captured there is held bit for bit
against the plain warp and timed here; train-small's float32 step also
runs over 'spatial' = 2.  Each rank's K1-K3 launches are printed and
must be nonzero.  Last, one process encodes the clip warm at
AIVC_PIPELINE_LOOKAHEAD 0 and 4 in turns (the encode launch/finish
split): the bytes must be equal; the encode fps of each are printed.

The scripts phase (``smoke.scripts_runs``) drives the operational
tools of aivc_tpu_torch/scripts/ at full width: rd_sweep of the 9 frames
(RA GOP 8, rates 0, 2.5 and 6, --rate_audit) with K free and with
AIVC_VRANS_K pinned, each in this process (every stream decoded here
bit-exactly) and over three worker processes on the one card (pinned:
rows equal to the in-process rows; free: the bytes' difference
printed); eval_ckpt at 240x416 (3 held-out families, rates 0, 2, 4 and
6, RA) of bf16-r5 and of the low-rate specialist make_lowrate derives
from it, and bd_from_eval of the two; latent_range and probe_motion at
240x416 (reported); and scripts.aivc's encode, decode and evaluate
processes on the clip's YUV, whose stream must equal the CLI's RA
stream.  The supervisor (scripts.train_supervised) drives only host
processes; its path on the card is the trainer's, which train-recipe
runs.

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
# multidevice: the GOP round-robin's clip, at least four GOPs
MULTI_RR_FRAMES, MULTI_RR_GOP, MULTI_RR_WAVE = 17, 4, 4
# the encode's launch/finish split: AIVC_PIPELINE_LOOKAHEAD settings
LOOKAHEADS = (0, 4)


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
    codec_hp = codec.hp
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
    main_fallbacks = kernels.FALLBACKS["gdn_layer"]
    stage_fallbacks = kernels.FALLBACKS["conv_stage"]
    ph.say(f"main: {N_FRAMES} frames {W}x{H} RA GOP{GOP}: {res['bytes']} B, "
           f"{res['bpp']:.5f} bpp, PSNR {res['psnr']:.4f} dB, MS-SSIM "
           f"{res['ms_ssim']:.6f}, encode {res['encode_fps']:.3f} fps, "
           f"decode {res['decode_fps']:.3f} fps, peak memory "
           f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
           f"launches {main_launches}")
    ph.say(f"main: frame bytes {res['frame_bytes']}")
    gdn_calls = main_launches["gdn_layer"] + main_fallbacks
    ph.say(f"main: the GDN layers took their kernel in "
           f"{main_launches['gdn_layer']} of {gdn_calls} calls (hit share "
           f"{main_launches['gdn_layer'] / max(gdn_calls, 1):.4f})")
    stage_calls = main_launches["conv_stage"] + stage_fallbacks
    ph.say(f"main: the conv blocks took the conv stage in "
           f"{main_launches['conv_stage']} of {stage_calls} calls (hit share "
           f"{main_launches['conv_stage'] / max(stage_calls, 1):.4f})")
    if stage_fallbacks:
        raise AssertionError(f"{stage_fallbacks} conv block calls of the "
                             f"bf16 main path missed the conv stage")
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
    missing = [k for k in ("rans_encode", "rans_decode", "warp_packed",
                           "gdn_layer", "conv_stage")
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
    rec_layer = smoke.check_gdn_layer(dict(fmodel.named_modules()), dev)
    for r in rec_layer["cases"]:
        ph.say(f"kernel gdn_layer with {r['layer']}'s parameters "
               f"{list(r['shape'])} bf16, lowp {r['lowp']}: every image "
               f"within {r['max_rel_err']:.3e} relative of its plain "
               f"version, {r['differing_share']:.3e} of the outputs differ;"
               f" {r['ms']:.4f} ms (plain {r['plain_ms']:.3f} ms, bound "
               f"{r['bound_ms']:.4f} ms by {r['bound_by']}, "
               f"{100 * r['bound_ms'] / r['ms']:.1f}%; gdn_apply "
               f"{r['library_ms']:.4f} ms); channels-last: the same bits, "
               f"{r['ms_channels_last']:.4f} ms")
    if rec_layer["launches"] != 4 * len(smoke.GDN_LAYER_CASES):
        raise AssertionError(f"gdn_layer launched {rec_layer['launches']} "
                             f"times in {4 * len(smoke.GDN_LAYER_CASES)} "
                             f"checks")
    rec_stage = smoke.check_conv_stage(dev)
    for r in rec_stage["cases"]:
        ph.say(f"kernel conv_stage {list(r['shape'])} {r['dtype']} "
               f"{r['fmt']} pad {r['pad']} -> {r['channels']} channels: "
               f"bit-identical to its plain "
               f"version; {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by "
               f"{r['bound_by']}, {100 * r['bound_ms'] / r['ms']:.1f}%; "
               f"plain {r['plain_ms']:.4f} ms; library (pad, cast, "
               f"channels-last copy) {r['library_ms']:.4f} ms)")
    if rec_stage["launches"] != len(smoke.CONV_STAGE_CASES):
        raise AssertionError(f"conv_stage launched {rec_stage['launches']} "
                             f"times in {len(smoke.CONV_STAGE_CASES)} checks")
    rec_c1 = smoke.check_conv1x1(dev)
    for r in rec_c1["cases"]:
        ph.say(f"kernel conv1x1 {r['k']} -> {r['n']} {r['epilogue']} "
               f"{list(r['shape'])}: within one bf16 ulp of the first "
               f"rounding of its plain version, {r['differing']:.3e} of the "
               f"outputs differ; {r['ms']:.4f} ms (bound "
               f"{r['bound_ms']:.4f} ms by {r['bound_by']}, "
               f"{100 * r['bound_ms'] / r['ms']:.1f}%; plain "
               f"{r['plain_ms']:.4f} ms; library (cuDNN's NCHW conv, its "
               f"bias pass and the epilogue's passes) "
               f"{r['library_ms']:.4f} ms)")
    if rec_c1["launches"] != len(smoke.CONV1X1_CASES):
        raise AssertionError(f"conv1x1 launched {rec_c1['launches']} times "
                             f"in {len(smoke.CONV1X1_CASES)} checks")
    wave = smoke.elic_wave(dev)
    c1_calls = wave["launches"] + wave["fallbacks"]
    ph.say(f"elic: one All-Intra wave of {wave['frames']} 1080p frames, "
           f"ELIC-N192-M320 on seeded weights: {wave['bytes']} B, decoded "
           f"bit-exactly; encode {wave['encode_s']:.3f} s, decode "
           f"{wave['decode_s']:.3f} s; the 1x1 convs took K7 in "
           f"{wave['launches']} of {c1_calls} (hit share "
           f"{wave['launches'] / max(c1_calls, 1):.4f})")
    if wave["fallbacks"] or not wave["launches"]:
        raise AssertionError(f"{wave['fallbacks']} of ELIC's 1x1 convs "
                             f"missed K7")
    records += [rec4, rec5, rec_layer, rec_stage, rec_c1]

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

    # -- multidevice -------------------------------------------------------
    t_phase = time.time()
    ph.say(f"multidevice: {smoke.MULTI_WORLD} ranks, one process each, on "
           f"the one card over {smoke.MULTI_BACKEND} (NCCL refuses two "
           f"ranks on one GPU; gloo's collectives take host tensors, so "
           f"every gather goes through host copies)")
    rr_frames = synthetic_frames(MULTI_RR_FRAMES, H, W)
    with tempfile.TemporaryDirectory(dir=root / "tmp") as tmp:
        md = smoke.multidevice_runs(ckpt, dev, tmp, rr_frames, frames,
                                    res["bitstream"], rr_gop=MULTI_RR_GOP,
                                    rr_wave=MULTI_RR_WAVE, mesh_gop=GOP,
                                    mesh_wave=WAVE_BATCH)
    for i, la in enumerate(md["launches"]):
        ph.say(f"multidevice: rank {i} launches (round-robin and mesh "
               f"codec) {la}")
    rr = md["rr"]
    ph.say(f"multidevice round-robin: {MULTI_RR_FRAMES} frames {W}x{H} RA "
           f"GOP{MULTI_RR_GOP}, wave batch {MULTI_RR_WAVE}: with "
           f"AIVC_VRANS_K={smoke.MULTI_PIN_K} both ranks' stream = one "
           f"process's, {rr['pinned']['bytes']} B, decoded here bit-exactly "
           f"against the ranks' reconstructions")
    free = rr["free"]
    ph.say(f"multidevice round-robin: free K: {free['bytes']} B (one "
           f"process {free['one_bytes']} B, "
           f"{'equal' if free['equal'] else 'different'}), decoded "
           f"bit-exactly; K per frame {free['ks']} (one process "
           f"{free['one_ks']})")
    ph.say(f"multidevice round-robin: encode warm on {info['smi']}: one "
           f"process {free['one_seconds']:.3f} s = "
           f"{MULTI_RR_FRAMES / free['one_seconds']:.3f} fps, "
           f"{smoke.MULTI_WORLD} ranks {free['seconds']:.3f} s = "
           f"{MULTI_RR_FRAMES / free['seconds']:.3f} fps")
    mc = md["mesh"]
    ph.say(f"multidevice mesh codec (data={smoke.MULTI_WORLD}): "
           f"{N_FRAMES} frames RA GOP{GOP}, wave batch {WAVE_BATCH}: its own "
           f"decode bit-exact; {mc['bytes']} B against one process's "
           f"{mc['one_bytes']} B ({'equal' if mc['equal'] else 'different'}),"
           f" PSNR {mc['psnr']:.4f} dB against {mc['one_psnr']:.4f} dB; "
           f"one process's decode of the mesh stream differs from the "
           f"mesh codec's in {mc['one_decode_differs']} of {N_FRAMES} frames")
    ph.say(f"multidevice mesh codec: encode {mc['encode_s']} s, decode "
           f"{mc['decode_s']} s, host-side gathers {mc['comm_s']} s per rank")
    for name, (batch, accum, spatial) in smoke.MULTI_TRAIN_CASES.items():
        tr = md["train"][name]
        ph.say(f"multidevice train step {name} (train-small in float32, "
               f"batch {batch}, accum {accum} over data="
               f"{smoke.MULTI_WORLD // spatial}, spatial={spatial})"
               f": differences from one process {tr['diffs']}; worst of "
               f"{tr['n_leaves']} gradient leaves relative L2 "
               f"{tr['worst_leaf_rel_l2'][1]:.3e} "
               f"({tr['worst_leaf_rel_l2'][0]}); limits "
               f"{smoke.TRAIN_SMALL_F32_TOL}, leaf "
               f"{smoke.TRAIN_SMALL_F32_LEAF_MAX_REL_L2}; parameters after "
               f"the update bitwise equal across the ranks")
    sp = md["spatial"]
    ph.say(f"spatial mesh codec (data=1, spatial={smoke.MULTI_SPATIAL}, "
           f"bands of {codec_hp // smoke.MULTI_SPATIAL} rows): {N_FRAMES} "
           f"frames RA GOP{GOP}, wave batch {WAVE_BATCH}: its own decode "
           f"bit-exact; {sp['bytes']} B against one process's "
           f"{sp['one_bytes']} B ({'equal' if sp['equal'] else 'different'})"
           f", PSNR {sp['psnr']:.4f} dB against {sp['one_psnr']:.4f} dB; one "
           f"process's decode of the mesh stream differs from the mesh "
           f"codec's in {sp['one_decode_differs']} of {N_FRAMES} frames")
    for i in range(smoke.MULTI_WORLD):
        ph.say(f"spatial mesh codec rank {i}: launches {sp['launches'][i]}, "
               f"encode {sp['encode_s'][i]:.3f} s, decode "
               f"{sp['decode_s'][i]:.3f} s, collectives "
               f"{sp['comm_s'][i]:.3f} s of which halo exchanges "
               f"{sp['halo_s'][i]:.3f} s and row gathers "
               f"{sp['gather_s'][i]:.3f} s (forward, host copies "
               f"included), peak memory {sp['peak_gib'][i]:.2f} GiB")
    bw = sp["band_warp"]
    ph.say(f"kernel warp_packed on one band launch of the spatial encode "
           f"{bw['shape']} rows {bw['rows'][0]}..{bw['rows'][1] - 1} "
           f"(|flow| <= {bw['max_flow']:.3f}): bit-identical to its plain "
           f"version; {bw['ms']:.4f} ms (plain {bw['plain_ms']:.3f} ms, "
           f"bound {bw['bound_ms']:.4f} ms, library {bw['library_ms']:.4f} "
           f"ms)")
    ph.say(f"multidevice: ranks {md['ranks_s']:.1f} s wall; phase "
           f"{time.time() - t_phase:.1f} s")

    # -- encode lookahead --------------------------------------------------
    t_phase = time.time()
    la = smoke.lookahead_runs(ckpt, frames, dev, depths=LOOKAHEADS,
                              gop=GOP, wave_batch=WAVE_BATCH)
    ph.say(f"lookahead: {N_FRAMES} frames {W}x{H} RA GOP{GOP}, warm, "
           f"AIVC_PIPELINE_LOOKAHEAD {' and '.join(map(str, LOOKAHEADS))} "
           f"in turns: {la['bytes']} B at every depth; encode fps on "
           f"{info['smi']}: " + ", ".join(
               f"lookahead {d} {' / '.join(f'{v:.3f}' for v in fps)}"
               for d, fps in la["fps"].items())
           + f"; {time.time() - t_phase:.1f} s")

    # -- scripts (aivc_tpu_torch/scripts/) -------------------------------
    t_phase = time.time()
    with tempfile.TemporaryDirectory(dir=root / "tmp") as tmp:
        sc = smoke.scripts_runs(ckpt, frames, dev, tmp, root,
                                res["bitstream"], gop=GOP,
                                wave_batch=WAVE_BATCH)
    for name, sw in sc["sweep"].items():
        where = (f"{sw['wall']['procs']} worker processes on the card"
                 if sw["wall"]["procs"] > 1 else "in this process")
        pin = (f"AIVC_VRANS_K={smoke.MULTI_PIN_K}" if "pinned" in name
               else "K free")
        ph.say(f"scripts rd_sweep {name}: {N_FRAMES} frames {W}x{H} RA "
               f"GOP{GOP}, {pin}, {where}: sweep {sw['wall']['sweep_wall_s']}"
               f" s ({sw['seconds']:.1f} s with set-up), launches "
               f"{sw['wall']['kernel_launches']}")
        for r in sw["rows"]:
            ph.say(f"scripts rd_sweep {name} idx_rate {r['idx_rate']}: "
                   f"{r['bytes']} B, {r['bpp']} bpp, PSNR {r['psnr']} dB, "
                   f"MS-SSIM {r['ms_ssim']}, encode {r['enc_fps']} fps, "
                   f"analytic {r['analytic_bits']} bits, container "
                   f"overhead {r['container_overhead_pct']}%")
        if "decode" in sw:
            d = sw["decode"]
            ph.say(f"scripts rd_sweep {name}: all {d['streams']} streams "
                   f"decoded here bit-exactly in {d['seconds']:.2f} s, "
                   f"launches {d['launches']}; K per frame {sw['ks']}")
    diff = sc["sweep"]["free_procs"]["bytes_minus_sequential"]
    ph.say(f"scripts rd_sweep: pinned, {smoke.SWEEP_PROCS} workers' rows = "
           f"the in-process rows; K free, workers' bytes minus the "
           f"sequential rows' {diff}")
    ev = sc["eval"]
    ph.say(f"scripts make_lowrate: {ev['make_lowrate']}")
    for name in ("flagship", "lowrate"):
        e = ev[name]
        for r in e["summary"]:
            ph.say(f"scripts eval_ckpt {name} idx_rate {r['idx_rate']}: "
                   f"{r['bpp']} bpp, PSNR {r['psnr']} dB, MS-SSIM "
                   f"{r['ms_ssim']} (mean of {ev['families']} at "
                   f"{smoke.EVAL_W}x{smoke.EVAL_H}, RA, decodes bit-exact)")
        ph.say(f"scripts eval_ckpt {name}: {json.dumps(e['mean'])}, "
               f"{e['seconds']:.1f} s, launches {e['launches']}")
    ph.say(f"scripts bd_from_eval (ref {CKPT}, test its low-rate "
           f"specialist): {json.dumps(ev['bd'])}")
    for name in ("latents", "motion"):
        for line in sc[name]["lines"]:
            ph.say(f"scripts {name}: {line}")
        ph.say(f"scripts {name}: {sc[name]['seconds']:.1f} s, launches "
               f"{sc[name]['launches']}")
    a = sc["aivc"]
    q = a["results"]
    ph.say(f"scripts aivc: encode, decode, evaluate as three processes in "
           f"{a['seconds']:.1f} s: {a['bytes']} B = the CLI's RA stream, "
           f"{q.get('rate bpp')} bpp, PSNR {q.get('psnr')}, MS-SSIM "
           f"{q.get('ms-ssim')}, encode {q.get('encoding fps')} fps, decode "
           f"{q.get('decoding fps')} fps; the decode stage's frames = this "
           f"process's decode of the stream (launches here "
           f"{a['decode_launches']}; the stages' own launches happen in "
           f"their processes)")
    ph.say(f"scripts: {time.time() - t_phase:.1f} s")

    launches = {k: main_launches[k]
                for k in ("rans_encode", "rans_decode", "warp_packed")}
    launches["warp_vclamped"] = fwd_launches["warp_vclamped"]
    launches["gdn_fused"] = rec4["launches"]
    launches["gdn_layer"] = main_launches["gdn_layer"]
    launches["conv_stage"] = main_launches["conv_stage"]
    launches["conv1x1"] = wave["launches"]
    # K3 on a row window: the spatial mesh codec's launches, both ranks.
    launches["warp_packed_band"] = sum(la["warp_packed"]
                                       for la in sp["launches"])
    records.append(smoke.band_warp_record(bw))
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
