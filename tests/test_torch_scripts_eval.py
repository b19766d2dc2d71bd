"""Checkpoint evaluation of the port, ``python -m
aivc_tpu_torch.scripts.eval_ckpt``, and ``bd_from_eval``, on the host
against the JAX package.

eval_ckpt on tiny-toy at 48x64 over the first 2 held-out families (5
frames, GOP 4, rates 0 and 2, --per_clip), RA and LDP, against the
library calls of scripts/eval_ckpt.py:110-157 in the same order, rounded
as the script rounds: bpp equal (bytes equal); limits with the largest
difference measured on this host: PSNR 2e-3 dB (measured 0), MS-SSIM
2e-5 (1e-5: one rounding step of the 5th decimal), alpha_mean 2e-4 (0).  Every decode
is bit-exact (the port checks it).  ``--in_dist`` clips equal
scripts/eval_ckpt.py:heldout_clips(in_dist=True)'s byte for byte.
bd_from_eval's line equals the JAX script's on two small JSONL files,
and so do its refusals.
"""

import json
import subprocess
import sys

import numpy as np
import pytest

import torch

from aivc_tpu_torch.scripts import bd_from_eval, eval_ckpt
from torch_scripts_ref import (
    ROOT,
    TINY_TOY,
    json_lines,
    limit_threads,
    run_jax_script,
    run_port,
)

CASE = dict(h=48, w=64, frames=5, gop=4, clips=2, rates=(0.0, 2.0))
ARGV = ["--cpu", "--ckpt", TINY_TOY, "--h", 48, "--w", 64, "--frames", 5,
        "--gop_size", 4, "--clips", 2, "--rates", "0,2", "--per_clip"]
LIMITS = {"psnr": 2e-3, "ms_ssim": 2e-5, "alpha_mean": 2e-4}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = limit_threads()
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_rows():
    """{coding: the rows scripts/eval_ckpt.py prints} for RA and LDP."""
    sys.path.insert(0, str(ROOT / "scripts"))
    import eval_data

    from aivc_tpu.config import CodingConfig
    from aivc_tpu.pipeline.codec import FrameCodec
    from aivc_tpu.pipeline.video import (
        decode_video,
        encode_video,
        evaluate_frames,
    )
    from aivc_tpu.utils.checkpoint import load_checkpoint

    h, w, n = CASE["h"], CASE["w"], CASE["frames"]
    names = list(eval_data.FAMILIES)[:CASE["clips"]]
    clips = eval_data.heldout_clips(n, h, w, names)
    cfg, params = load_checkpoint(TINY_TOY)
    codec = FrameCodec(cfg, params, h, w)
    out = {}
    for kind in ("RA", "LDP"):
        rows, summary = [], []
        for r in CASE["rates"]:
            if kind == "RA":
                coding = CodingConfig(coding_config="RA",
                                      gop_size=CASE["gop"],
                                      intra_period=CASE["gop"], idx_rate=r)
            else:
                coding = CodingConfig(coding_config="LDP",
                                      intra_period=CASE["gop"], idx_rate=r)
            bpps, psnrs, mss = [], [], []
            for cname, frames in zip(names, clips):
                res = encode_video(codec, frames, coding, wave_batch=4)
                m = evaluate_frames(frames,
                                    decode_video(codec, res.bitstream))
                bpps.append(res.total_bytes * 8.0 / (h * w * n))
                psnrs.append(m["psnr"])
                mss.append(m["ms_ssim"])
                inter_a = [fr.alpha_mean for fr in res.frame_results
                           if fr.frame_type != 0]
                rows.append({"ckpt": str(TINY_TOY), "clip": cname,
                             "idx_rate": r,
                             "bpp": round(float(bpps[-1]), 4),
                             "psnr": round(float(m["psnr"]), 3),
                             "ms_ssim": round(float(m["ms_ssim"]), 5),
                             "alpha_mean": round(float(np.mean(inter_a)), 4)})
            row = {"ckpt": str(TINY_TOY), "coding": kind, "idx_rate": r,
                   "bpp": round(float(np.mean(bpps)), 4),
                   "psnr": round(float(np.mean(psnrs)), 3),
                   "ms_ssim": round(float(np.mean(mss)), 5)}
            summary.append(row)
            rows.append(row)
        rows.append({
            "ckpt": str(TINY_TOY),
            "mean_bpp": round(float(np.mean([r["bpp"] for r in summary])), 4),
            "mean_psnr": round(float(np.mean([r["psnr"] for r in summary])),
                               3),
            "mean_ms_ssim": round(float(np.mean(
                [r["ms_ssim"] for r in summary])), 5)})
        out[kind] = rows
    return out


def check_rows(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for k in g:
            lim = LIMITS.get(k.replace("mean_", ""))
            if lim is None:
                assert g[k] == r[k], (k, g, r)
            else:
                assert abs(g[k] - r[k]) <= lim, (k, g, r)


@pytest.mark.parametrize("coding", ["RA", "LDP"])
def test_rows_equal_jax(jax_rows, coding):
    rc, out = run_port(eval_ckpt.main, ARGV + ["--coding", coding])
    assert rc == 0
    check_rows(json_lines(out), jax_rows[coding])


def test_in_dist_clips_equal_jax(tmp_path):
    """--in_dist: one training-generator clip and the sinusoid, as the
    JAX script builds them (run in a process of its own: it imports
    train_toy, which reads the photo pool from the asset packages)."""
    code = (
        "import sys, numpy as np\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'scripts')!r}]\n"
        "import eval_ckpt\n"
        "clips, names = eval_ckpt.heldout_clips(3, 3, 40, 56, in_dist=True)\n"
        "np.savez(sys.argv[1], names=np.array(names), **{f'{i}_{t}_{c}': "
        "f[c] for i, clip in enumerate(clips) for t, f in enumerate(clip) "
        "for c in 'yuv'})\n")
    path = tmp_path / "clips.npz"
    proc = subprocess.run([sys.executable, "-c", code, str(path)],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    ref = np.load(path)
    clips, names = eval_ckpt.heldout_clips(3, 3, 40, 56, in_dist=True)
    assert names == list(ref["names"])
    for i, clip in enumerate(clips):
        for t, f in enumerate(clip):
            for c in "yuv":
                np.testing.assert_array_equal(f[c], ref[f"{i}_{t}_{c}"])


def test_drifting_decode_raises():
    frames = [{"y": np.zeros((2, 2), np.uint8),
               "u": np.zeros((1, 1), np.uint8),
               "v": np.zeros((1, 1), np.uint8)}]
    other = [dict(frames[0], v=np.ones((1, 1), np.uint8))]
    eval_ckpt.check_decode(frames, {0: frames[0]}, {0: frames[0]}, "same")
    with pytest.raises(RuntimeError, match="plane v differs"):
        eval_ckpt.check_decode(frames, {0: other[0]}, {0: frames[0]}, "x")


def test_no_card_exits_2(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert eval_ckpt.main([str(a) for a in ARGV if a != "--cpu"]) == 2
    assert "--cpu" in capsys.readouterr().err


def write_rows(path, ckpt, rows, extra=()):
    path.write_text("".join(json.dumps(r) + "\n" for r in [
        {"ckpt": ckpt, "coding": "RA", "idx_rate": float(i), "bpp": b,
         "psnr": p, "ms_ssim": m} for i, (b, p, m) in enumerate(rows)]
        + list(extra)))


REF = [(0.43, 33.2, 0.981), (0.25, 31.1, 0.972), (0.14, 29.3, 0.958),
       (0.08, 27.6, 0.937), (0.05, 26.1, 0.911)]
TEST = [(0.40, 33.3, 0.982), (0.23, 31.3, 0.974), (0.13, 29.4, 0.960),
        (0.075, 27.8, 0.940), (0.046, 26.2, 0.913)]
FAR = [(0.03, 40.0, 0.99), (0.02, 39.5, 0.989), (0.015, 39.0, 0.988),
       (0.01, 38.5, 0.987)]


@pytest.mark.parametrize("case", ["plain", "mixed", "undefined"])
def test_bd_from_eval_equals_jax(tmp_path, case):
    ref, test = tmp_path / "ref.jsonl", tmp_path / "test.jsonl"
    clip_row = {"ckpt": "r", "clip": "wheel", "idx_rate": 0.0, "bpp": 9.0,
                "psnr": 1.0, "ms_ssim": 0.5}
    write_rows(ref, "ckpts/ref", REF, [clip_row, {"ckpt": "ckpts/ref",
                                                  "mean_bpp": 0.1}])
    argv = ["--ref", ref, "--test", test]
    if case == "plain":
        write_rows(test, "ckpts/test", TEST)
    elif case == "mixed":
        write_rows(test, "ckpts/test", TEST)
        with test.open("a") as f:
            for i, row in enumerate(REF):
                f.write(json.dumps({"ckpt": "other", "idx_rate": float(i),
                                    "bpp": row[0], "psnr": row[1],
                                    "ms_ssim": row[2]}) + "\n")
        argv += ["--test_ckpt", "ckpts/test"]
    else:
        # BD-rate has no integral where the qualities do not overlap
        write_rows(test, "ckpts/far", [(b, p - 12.0, m) for b, p, m in FAR])
        write_rows(ref, "ckpts/ref", [(b, p, m) for b, p, m in FAR[::-1]])
    rc, got = run_port(bd_from_eval.main, argv)
    assert rc == 0
    assert got == run_jax_script("bd_from_eval", argv)


def test_bd_from_eval_refusals_equal_jax(tmp_path):
    path = tmp_path / "mixed.jsonl"
    write_rows(path, "a", REF)
    with path.open("a") as f:
        f.write(json.dumps({"ckpt": "b", "idx_rate": 0.0, "bpp": 0.3,
                            "psnr": 30.0, "ms_ssim": 0.9}) + "\n")
    empty = tmp_path / "empty.jsonl"
    empty.write_text("not json\n")
    for argv in (["--ref", path, "--test", path],
                 ["--ref", path, "--test", path, "--ref_ckpt", "a",
                  "--test_ckpt", "c"],
                 ["--ref", empty, "--test", path]):
        with pytest.raises(SystemExit) as ours:
            run_port(bd_from_eval.main, argv)
        with pytest.raises(SystemExit) as theirs:
            run_jax_script("bd_from_eval", argv)
        assert str(ours.value) == str(theirs.value)
