"""Rehearsal of chip_smoke.py's phases on the host at a tiny size (the
kernel wrappers take their plain versions there), and of its refusal to
run without a card or without the package."""

import importlib.util
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from aivc_tpu_torch import smoke
from aivc_tpu_torch.ops import warp as warp_ops
from aivc_tpu_torch.pipeline.codec import FrameCodec
from aivc_tpu_torch.pipeline.video import frames_444, synthetic_frames
from aivc_tpu_torch.utils.checkpoint import load_checkpoint

ROOT = Path(__file__).resolve().parents[1]
CKPT = ROOT / "models_ckpt" / "tiny-toy"
BF16 = ROOT / "models_ckpt" / "bf16-r5"
LOG_KEYS = {"rate_bpp", "mode_rate_bpp", "codec_rate_bpp", "mse", "dist",
            "dist_pure", "psnr", "flow_mag", "flow_max", "alpha_mean",
            "loss"}
KEYS = {"name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Test workers share the host's cores: a small PyTorch pool keeps
    them from oversubscribing it (spinning OpenMP threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def codec():
    cfg, model = load_checkpoint(CKPT, device="cpu")
    return FrameCodec(cfg, model, 128, 128, device="cpu")


def test_phases_rehearsed_on_host(codec):
    records = smoke.check_rans(codec, batch=2, reps=1)
    records += smoke.check_warp(torch.device("cpu"), 2, 64, 128, 32, reps=1)
    assert [r["name"] for r in records] == ["rans_encode", "rans_decode",
                                            "warp_packed"]
    for r in records[:2]:
        assert r["steps"] > 0 and r["us_per_step"] > 0
    res = smoke.code_clip(codec, synthetic_frames(9, 128, 128))
    assert res["bytes"] > 0 and res["psnr"] > 10
    assert res["decode_steps"] == 0           # plain decode: no launches
    assert res["encode_steps"] == 0           # plain encode: no launches
    assert res["decode_s"] > 0 and res["encode_s"] > 0
    assert 0.0 < res["ms_ssim"] < 1.0
    line = json.loads(smoke.kernels_line(records, {"rans_encode": 5,
                                                   "rans_decode": 14,
                                                   "warp_packed": 14}))
    for r in line["kernels"]:
        assert set(r) == KEYS and r["launches"] > 0
        assert r["bound_by"] in ("bytes", "operations")
        assert r["max_abs_err"] == 0.0


def test_warp_watch_captures_an_encode_launch(codec, monkeypatch):
    """capture_encode_warp wraps warp_packed_cuda (here a stand-in that
    runs the plain warp, since the host takes no kernel) with WarpWatch
    through an encode of the clip: it keeps the first launch of the
    largest batch, a B-frame wave of the RA GOP, closes the watch, and
    K3's check on those inputs passes."""
    seen = []

    def stand_in(packed, u, v, row0=0):
        seen.append((packed.clone(), u.clone(), v.clone(), row0))
        return warp_ops.warp_packed(packed, u, v, row0)

    monkeypatch.setattr(warp_ops, "warp_packed_cuda", stand_in)
    real_mc = warp_ops.mc_warp

    def mc_to_stand_in(packed, u, v, engine, row0=0):
        return warp_ops.warp_packed_cuda(packed.contiguous(),
                                         u.contiguous(), v.contiguous(),
                                         row0)

    monkeypatch.setattr("aivc_tpu_torch.models.fullnet.mc_warp",
                        mc_to_stand_in)
    inputs = smoke.capture_encode_warp(codec, synthetic_frames(9, 128, 128))
    assert warp_ops.warp_packed_cuda is stand_in     # closed
    # The B-wave of four frames warps its prev and next references.
    batches = [c[0].shape[0] for c in seen]
    first = seen[batches.index(4)]
    assert max(batches) == 4 and batches.count(4) == 2
    assert all(torch.equal(a, b) for a, b in zip(inputs[:3], first[:3]))
    packed, u, v, row0 = inputs
    assert row0 == first[3] == 0
    assert packed.dtype == torch.int32 and u.shape == packed.shape
    rec = smoke.check_warp_on(inputs, reps=1)
    assert rec["shape"] == list(packed.shape) and rec["ms"] > 0
    assert 0 < rec["max_flow"] <= 32 and rec["bound_ms"] > 0
    assert real_mc is warp_ops.mc_warp


def test_capture_encode_warp_fails_without_a_launch(codec):
    """On the host mc_warp takes the plain warp, so the encode launches no
    K3: capture_encode_warp fails instead of returning nothing, and
    leaves warp_packed_cuda as it was."""
    kernel = warp_ops.warp_packed_cuda
    with pytest.raises(AssertionError, match="no warp_packed launch"):
        smoke.capture_encode_warp(codec, synthetic_frames(9, 128, 128))
    assert warp_ops.warp_packed_cuda is kernel


def test_band_warp_checked_and_recorded():
    """check_warp_on on a band launch (row0 > 0, the band's flows and
    the whole frame) holds it against the plain warp and gives the
    kernels line's record of warp_packed_band, its bound from the band's
    pixels."""
    g = torch.Generator().manual_seed(5)
    packed = torch.randint(0, 1 << 24, (2, 64, 96), generator=g,
                           dtype=torch.int32)
    u = (torch.rand((2, 32, 96), generator=g) * 2 - 1) * 30
    v = (torch.rand((2, 32, 96), generator=g) * 2 - 1) * 30
    rec = smoke.check_warp_on((packed, u, v, 32), reps=1)
    assert rec["rows"] == [32, 64] and rec["shape"] == [2, 64, 96]
    assert rec["bound_bytes"] == 24 * 2 * 32 * 96
    line = json.loads(smoke.kernels_line([smoke.band_warp_record(rec)],
                                         {"warp_packed_band": 3}))
    (r,) = line["kernels"]
    assert set(r) == KEYS and r["launches"] == 3
    assert r["replaces"] == "aivc_tpu/ops/warp_pallas.py:303"
    assert r["bound_by"] == "bytes" and r["library_ms"] > 0


def test_lookahead_runs_rehearsed_on_host():
    out = smoke.lookahead_runs(str(CKPT), synthetic_frames(5, 64, 64),
                               torch.device("cpu"), depths=(0, 2), gop=4,
                               wave_batch=2)
    assert out["bytes"] > 0
    assert {d: len(v) for d, v in out["fps"].items()} == {0: 2, 2: 2}


def test_encode_equal_sees_one_word(codec):
    """smoke.encode_equal, which holds K1 against the plain encode, fails
    on one flipped bit of a chunk's words and ignores the buffer before
    them (unwritten by the kernel)."""
    from aivc_tpu_torch.coding import vrans

    sym, rows, k, segs = smoke.fused_inputs(codec, 2)
    ref = vrans.encode_plain(sym, rows, codec.table, k, segs)
    out = tuple(t.clone() for t in ref)
    assert smoke.encode_equal(out, ref)
    start = int(out[2][1, 0])
    assert start > 0
    out[0][1, 0] ^= 1                       # before chunk 1's words
    assert smoke.encode_equal(out, ref)
    out[0][1, start + 3] ^= 1
    assert not smoke.encode_equal(out, ref)


@pytest.mark.parametrize("fault", ["nan", "one_ulp_often",
                                   "three_ulps_rarely"])
def test_gdn_check_rejects_a_faulty_kernel(monkeypatch, fault):
    """check_gdn fails a K4 whose bf16 output holds a NaN, one that
    stays within GDN_PLAIN_ULPS but differs from the plain version in far
    more outputs than GDN_DIFFERING_SHARE (what fewer bits of gamma or
    of the sum would give), and one three ulps off in a few outputs,
    fewer than GDN_DIFFERING_SHARE."""
    from aivc_tpu_torch.ops import gdn as gdn_ops

    g = torch.Generator().manual_seed(11)
    mod = gdn_ops.GDN(128)
    with torch.no_grad():
        mod.gamma.add_(torch.rand(mod.gamma.shape, generator=g) * 0.1)
    x = (torch.randn((1, 128, 16, 32), generator=g) * 2).to(torch.bfloat16)
    inputs = {"gdn": (x, mod)}
    assert smoke.check_gdn(inputs, reps=1)["differing_share"] == 0.0
    plain = gdn_ops.gdn_fused

    def faulty(x, beta_r, gamma_r, inverse=False):
        out = plain(x, beta_r, gamma_r, inverse).float()
        if fault == "nan":
            out.view(-1)[7] = float("nan")
        else:   # one ulp up on every 50th output, three on every 5000th
            _, e = torch.frexp(out)
            step = torch.ldexp(torch.ones_like(out), e - 8)
            every, n = (50, 1) if fault == "one_ulp_often" else (5000, 3)
            out.view(-1)[::every] += n * step.view(-1)[::every]
        return out.to(x.dtype)

    monkeypatch.setattr(gdn_ops, "gdn_fused", faulty)
    with pytest.raises(AssertionError, match="outputs differ"
                       if fault == "one_ulp_often" else "bf16 ulps"):
        smoke.check_gdn(inputs, reps=1)


def test_gdn_layer_check_rehearsed_on_host():
    """check_gdn_layer at small shapes on the host, with bf16-r5's own
    layers: the layers take gdn_apply there (no launch), every image
    within the route's limits of the plain version, for both channel
    counts with and without lowp; one record for the kernels line, of the
    last case with lowp."""
    _, model = load_checkpoint(ROOT / "models_ckpt" / "bf16-r5",
                               device="cpu")
    cases = (("mofnet.g_s.UpBlock_2.GDN_0", (2, 96, 8, 16)),
             ("codecnet.g_a.ConvBlock_0.GDN_0", (3, 128, 4, 24)))
    rec = smoke.check_gdn_layer(dict(model.named_modules()),
                                torch.device("cpu"), reps=1, cases=cases)
    assert [(r["layer"], r["shape"][1], r["lowp"]) for r in rec["cases"]] \
        == [(cases[0][0], 96, True), (cases[0][0], 96, False),
            (cases[1][0], 128, True), (cases[1][0], 128, False)]
    assert rec["launches"] == 0
    assert (rec["name"], rec["layer"], rec["lowp"]) == (
        "gdn_layer", cases[1][0], True)
    for r in rec["cases"]:
        assert r["max_rel_err"] <= smoke.GDN_LAYER_RTOL[
            torch.bfloat16 if r["lowp"] else torch.float32]
        assert r["differing_share"] <= smoke.GDN_LAYER_DIFFERING_SHARE
        assert r["bound_ms"] > 0 and r["ms"] > 0 and r["library_ms"] > 0
    line = json.loads(smoke.kernels_line([rec], {"gdn_layer": 237}))
    assert line["kernels"][0]["launches"] == 237


@pytest.mark.parametrize("fault", ["nan", "every_image"])
def test_gdn_layer_check_rejects_a_faulty_route(monkeypatch, fault):
    """check_gdn_layer compares every image of the batch: a NaN, or an
    output off by 2^-4 relative in the last image alone, fails it."""
    from aivc_tpu_torch.ops import gdn as gdn_ops

    layers = {"igdn": gdn_ops.GDN(96, inverse=True)}
    plain = gdn_ops.gdn_apply

    def faulty(x, *args):
        out = plain(x, *args).clone()
        if fault == "nan":
            out.view(-1)[5] = float("nan")
        else:
            out[-1, 3, 2, 1] *= 1.0625
        return out

    monkeypatch.setattr(gdn_ops, "gdn_apply", faulty)
    with pytest.raises(AssertionError, match="image 2"
                       if fault == "every_image" else "relative"):
        smoke.check_gdn_layer(layers, torch.device("cpu"), reps=1,
                              cases=(("igdn", (3, 96, 4, 8)),))


STAGE_HOST_CASES = (
    ((2, 16, 6, 10), torch.float32, "channels_last", 2, None),
    ((1, 6, 9, 7), torch.float32, "nchw", 2, 8),
    ((2, 8, 5, 4), torch.bfloat16, "channels_last", 1, None))


def test_conv_stage_check_rehearsed_on_host():
    """check_conv_stage at small shapes on the host (the plain version, no
    launch): every case bit for bit, one record for the kernels line, of
    the first case, bound by bytes (4 B read and 2 written an f32
    element)."""
    rec = smoke.check_conv_stage(torch.device("cpu"), reps=1,
                                 cases=STAGE_HOST_CASES)
    assert rec["launches"] == 0
    assert [(r["shape"], r["fmt"], r["pad"]) for r in rec["cases"]] == [
        (c[0], c[2], c[3]) for c in STAGE_HOST_CASES]
    assert (rec["name"], rec["replaces"], rec["bound_by"]) == (
        "conv_stage", "none", "bytes")
    n_in, n_out = 2 * 16 * 6 * 10, 2 * 16 * 10 * 14
    assert rec["bound_ms"] == pytest.approx(
        (4 * n_in + 2 * n_out) / smoke.HBM_BYTES_PER_S * 1e3)
    for r in rec["cases"]:
        assert r["ms"] > 0 and r["plain_ms"] > 0 and r["library_ms"] > 0
    line = json.loads(smoke.kernels_line([rec], {"conv_stage": 240}))
    assert set(line["kernels"][0]) == KEYS
    assert line["kernels"][0]["launches"] == 240


@pytest.mark.parametrize("fault", ["one_value", "layout"])
def test_conv_stage_check_rejects_a_faulty_stage(monkeypatch, fault):
    """check_conv_stage compares the whole output: one value off by a bf16
    step, or the padding taken from the wrong edge, fails it."""
    from aivc_tpu_torch.ops import layers as layer_ops

    plain = layer_ops.pad_stage_plain

    def faulty(x, pad, channels):
        out = plain(x, pad, channels).clone()
        if fault == "one_value":
            out[-1, 3, 4, 5] = out[-1, 3, 4, 5] * 1.0078125 + 1
        else:
            out = out.flip(3)
        return out

    monkeypatch.setattr(layer_ops, "pad_stage", faulty)
    with pytest.raises(AssertionError, match="differs from its plain"):
        smoke.check_conv_stage(torch.device("cpu"), reps=1,
                               cases=STAGE_HOST_CASES[:1])


def test_small_agreement_rehearsed_on_host():
    out = smoke.small_agreement(str(CKPT), torch.device("cpu"), size=64,
                                n_frames=5)
    assert out["device"]["bytes"] == out["host"]["bytes"]


def test_forward_phases_rehearsed_on_host(monkeypatch):
    """forward and the K4 / K5 checks at 128x128 on a GOP of three frames
    of bf16-r5 (the kernels' plain versions on the host)."""
    monkeypatch.setattr(warp_ops, "_USE_PALLAS", True)
    cpu = torch.device("cpu")
    cfg, model = load_checkpoint(BF16, device=cpu)
    f444 = frames_444(synthetic_frames(3, 120, 128, seed=3), cpu)
    assert f444[0].shape == (1, 3, 128, 128)
    watch = smoke.GdnWatch(model, capture=smoke.GDN_LAYERS)
    fwd = smoke.rd_forward(model, cfg, f444, 0.0, "1_GOP_2")
    watch.close()
    assert set(fwd["logs"]) == LOG_KEYS
    assert sorted(watch.inputs) == sorted(smoke.GDN_LAYERS)
    rec4 = smoke.check_gdn(watch.inputs, reps=1)
    rec5 = smoke.check_warp_vclamped(cpu, 64, 128, reps=1)
    assert rec4["max_abs_err"] == 0.0 and rec5["max_abs_err"] == 0.0
    assert rec4["max_ulps"] == 0.0 and rec4["differing_share"] == 0.0
    assert rec4["bound_by"] == "bytes"    # bf16: the tensor-core rate
    assert rec4["launches"] == 0          # plain versions on the host
    assert [s[0] for s in rec4["inputs"]] == list(watch.inputs)
    assert rec5["clamped_share"] > 0.0
    assert smoke.warp_calls("1_GOP_2") == 3
    assert smoke.warp_calls(smoke.FORWARD_GOP) == 15
    line = json.loads(smoke.kernels_line(
        [rec4, rec5], {"gdn_fused": 6, "warp_vclamped": 3}))
    for r in line["kernels"]:
        assert set(r) == KEYS and r["launches"] > 0
        assert r["bound_by"] in ("bytes", "operations")


@pytest.fixture(scope="module")
def bf16_forward():
    """bf16-r5 on the host and a GOP of three frames at 128x128."""
    cpu = torch.device("cpu")
    cfg, model = load_checkpoint(BF16, device=cpu)
    return cfg, model, frames_444(synthetic_frames(3, 120, 128, seed=3), cpu)


def test_vclamp_watch_captures_a_forward_launch(bf16_forward, monkeypatch):
    """capture_forward_warp wraps warp_vclamped_cuda (here a stand-in that
    runs the plain warp, since the host takes no kernel) with VclampWatch
    through a forward: it keeps the first B-frame launch (launch 1 of
    1_GOP_2, which runs I0, P2, B1), closes the watch, and K5's check on
    those inputs passes."""
    from aivc_tpu_torch.models import fullnet
    from aivc_tpu_torch.profile_kernels import K5_LAUNCH

    cfg, model, f444 = bf16_forward
    seen = []

    def stand_in(x, flow):
        seen.append((x.clone(), flow.clone()))
        return warp_ops.warp_vclamped(x, flow)

    def warp_to_stand_in(x, flow, row0=0):
        assert row0 == 0
        return warp_ops.warp_vclamped_cuda(x.contiguous(), flow.contiguous())

    monkeypatch.setattr(warp_ops, "warp_vclamped_cuda", stand_in)
    monkeypatch.setattr(warp_ops, "warp", warp_to_stand_in)
    monkeypatch.setattr(fullnet, "warp", warp_to_stand_in)
    fwd, inputs = smoke.capture_forward_warp(model, cfg, f444, 0.0,
                                             "1_GOP_2")
    assert warp_ops.warp_vclamped_cuda is stand_in     # closed
    assert set(fwd["logs"]) == LOG_KEYS
    assert len(seen) == smoke.warp_calls("1_GOP_2") == 3
    assert smoke.first_b_warp("1_GOP_2") == 1
    assert smoke.first_b_warp(smoke.FORWARD_GOP) == K5_LAUNCH == 1
    assert all(torch.equal(a, b) for a, b in zip(inputs, seen[1]))
    x, flow = inputs
    assert x.shape == (1, 3, 128, 128) and flow.shape == (1, 2, 128, 128)
    rec = smoke.check_warp_vclamped_on(inputs, reps=1)
    assert rec["shape"] == [1, 3, 128, 128]
    assert rec["ms"] > 0 and rec["cold_ms"] > 0 and rec["bound_ms"] > 0
    # MOFNet's flows are softsign-bounded by flow_bound (32).
    assert 0 < rec["max_u"] < 32 and 0 < rec["max_v"] < 32
    assert 0.0 <= rec["clamped_share"] <= 1.0


def test_capture_forward_warp_fails_without_a_launch(bf16_forward,
                                                     monkeypatch):
    """On the host the float warp takes the plain version, so the forward
    launches no K5: capture_forward_warp fails instead of returning
    nothing, and leaves warp_vclamped_cuda as it was."""
    monkeypatch.setattr(warp_ops, "_USE_PALLAS", True)
    cfg, model, f444 = bf16_forward
    kernel = warp_ops.warp_vclamped_cuda
    with pytest.raises(AssertionError, match="no warp_vclamped launch"):
        smoke.capture_forward_warp(model, cfg, f444, 0.0, "1_GOP_2")
    assert warp_ops.warp_vclamped_cuda is kernel


def test_profile_busy_time_is_the_union_of_spans():
    from aivc_tpu_torch.tracing import union_length

    assert union_length([(0, 10)]) == 10
    assert union_length([(5, 8), (0, 10), (12, 15)]) == 13
    assert union_length([(0, 4), (4, 6), (7, 9)]) == 8
    assert union_length([]) == 0


def test_forward_small_rehearsed_on_host():
    out = smoke.forward_small(str(BF16), torch.device("cpu"), 0.0,
                              size=64, gop_name="1_GOP_2")
    diffs = smoke.compare_logs(out["device"], out["host"],
                               smoke.FORWARD_SMALL_TOL, "forward-small")
    assert all(d == 0.0 for d in diffs.values())


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_refuses_without_card(monkeypatch, capsys):
    mod = _load_chip_smoke()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mod.main() != 0
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin",
                               "HOME": str(tmp_path)})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout

