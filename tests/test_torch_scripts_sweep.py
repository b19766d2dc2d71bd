"""The RD sweep of the port, ``python -m aivc_tpu_torch.scripts.rd_sweep``,
on the host against the JAX package.

The reference is the library calls of scripts/rd_sweep.py:123-175 in the
same order (one FrameCodec with rate_priority and audit, a warm-up GOP
at the first rate, then each rate), on tiny-toy at 48x64: 5 synthetic
frames, RA GOP 4, rates 0, 1.5, 2 (a fractional one among them), with
--rate_audit.  Bytes (and so bpp) must be equal.  Limits on the floats,
with the largest difference measured on this host (the rows' own
rounding): PSNR 1e-3 dB (measured 0 at the row's 4 decimals), MS-SSIM
2e-5 (1e-5, one step of the 5th decimal), MS-SSIM dB 1e-3 (1e-4),
analytic bits 0.2 (0; JAX sums them in float32, the port in float64),
container overhead 0.01 points (1e-3).

``--procs 2`` rows equal the sequential rows (at this size K stays 8, so
every worker's K history gives the same bytes).  ``--compare`` equals
JAX's ``_maybe_compare`` on the same rows.  Without a card and without
--cpu the sweep exits 2; a worker that fails raises with its exit code.
"""

import argparse
import contextlib
import io
import json

import pytest

import torch

from aivc_tpu_torch.scripts import rd_sweep
from torch_scripts_ref import (
    TINY_TOY,
    jax_script,
    json_lines,
    limit_threads,
    run_port,
)

ARGV = ["--cpu", "--ckpt", TINY_TOY, "--h", 48, "--w", 64, "--frames", 5,
        "--gop_size", 4, "--intra_period", 4, "--rates", "0,1.5,2",
        "--rate_audit"]
RATES = (0.0, 1.5, 2.0)
LIMITS = {"psnr": 1e-3, "ms_ssim": 2e-5, "ms_ssim_db": 1e-3,
          "analytic_bits": 0.2, "container_overhead_pct": 0.01}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = limit_threads()
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_rows():
    """scripts/rd_sweep.py:123-175's calls, rows rounded as it rounds."""
    from aivc_tpu.config import CodingConfig
    from aivc_tpu.pipeline.codec import FrameCodec
    from aivc_tpu.pipeline.video import encode_video, evaluate_frames
    from aivc_tpu.utils.checkpoint import load_checkpoint
    from aivc_tpu_torch.pipeline.video import synthetic_frames

    cfg, params = load_checkpoint(TINY_TOY)
    frames = synthetic_frames(5, 48, 64)
    codec = FrameCodec(cfg, params, 48, 64, rate_priority=True, audit=True)

    def coding(r):
        return CodingConfig(coding_config="RA", gop_size=4, intra_period=4,
                            idx_rate=r)

    encode_video(codec, frames[:5], coding(RATES[0]), wave_batch=4)
    rows = []
    for r in RATES:
        res = encode_video(codec, frames, coding(r), wave_batch=4)
        m = evaluate_frames(frames, res.decoded_frames)
        analytic = sum(fr.analytic_bits for fr in res.frame_results)
        real = sum(fr.bytes for fr in res.frame_results) * 8.0
        rows.append({
            "idx_rate": r,
            "bpp": round(res.total_bytes * 8 / (48 * 64 * 5), 5),
            "bytes": res.total_bytes,
            "psnr": round(float(m["psnr"]), 4),
            "ms_ssim": round(float(m["ms_ssim"]), 5),
            "ms_ssim_db": round(float(m["ms_ssim_db"]), 4),
            "analytic_bits": round(float(analytic), 1),
            "container_overhead_pct": round(
                100.0 * (real - analytic) / max(analytic, 1e-9), 3)})
    return rows


@pytest.fixture(scope="module")
def port_out():
    rc, out = run_port(rd_sweep.main, ARGV)
    assert rc == 0
    return json_lines(out)


def sweep_rows(lines):
    return [r for r in lines if "idx_rate" in r]


def test_rows_equal_jax(jax_rows, port_out):
    rows = sweep_rows(port_out)
    assert [r["idx_rate"] for r in rows] == list(RATES)
    keys = {"idx_rate", "bpp", "bytes", "psnr", "ms_ssim", "ms_ssim_db",
            "enc_fps", "analytic_bits", "container_overhead_pct"}
    for got, ref in zip(rows, jax_rows):
        assert set(got) == keys
        assert got["bytes"] == ref["bytes"] and got["bpp"] == ref["bpp"]
        for k, lim in LIMITS.items():
            assert abs(got[k] - ref[k]) <= lim, (k, got, ref)
        assert got["enc_fps"] > 0
    wall = port_out[-1]
    assert wall["procs"] == 1 and wall["sweep_wall_s"] >= 0
    # the host runs the kernels' plain versions: no CUDA launch
    assert wall["kernel_launches"] == dict.fromkeys(rd_sweep.KERNELS, 0)


def test_procs_rows_equal_sequential(port_out, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")    # each worker's pool
    rc, out = run_port(rd_sweep.main, ARGV + ["--procs", 2])
    assert rc == 0
    lines = json_lines(out)
    def drop(rows):
        return [{k: v for k, v in r.items() if k != "enc_fps"} for r in rows]

    assert drop(sweep_rows(lines)) == drop(sweep_rows(port_out))
    assert lines[-1]["procs"] == 2
    assert lines[-1]["kernel_launches"] == dict.fromkeys(rd_sweep.KERNELS, 0)


def test_compare_equals_jax(tmp_path):
    ref = [{"idx_rate": i, "bpp": b, "psnr": p, "ms_ssim_db": m}
           for i, (b, p, m) in enumerate([(0.41, 33.1, 14.2),
                                          (0.22, 31.0, 12.9),
                                          (0.12, 29.2, 11.5),
                                          (0.07, 27.4, 10.1),
                                          (0.04, 25.9, 8.8)])]
    test = [dict(r, bpp=round(r["bpp"] * 0.93, 5),
                 psnr=r["psnr"] + 0.05 * i, ms_ssim_db=r["ms_ssim_db"] + 0.1)
            for i, r in enumerate(ref)]
    path = tmp_path / "ref.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in ref)
                    + '{"sweep_wall_s": 1.0, "procs": 1}\n')
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jax_script("rd_sweep")._maybe_compare(
            argparse.Namespace(compare=str(path)), test)
    assert json.dumps(rd_sweep.compare(str(path), test)) == \
        out.getvalue().strip()


def test_compare_flag_reports_this_sweep(tmp_path, port_out):
    """--compare prints compare() of this sweep's rows after them."""
    path = tmp_path / "ref.jsonl"
    rates = "0,0.5,1,1.5,2"
    argv = [a for a in ARGV if a != "--rate_audit"]
    argv[argv.index("--rates") + 1] = rates
    rc, out = run_port(rd_sweep.main, argv)
    assert rc == 0
    path.write_text(out)
    rc, out = run_port(rd_sweep.main, argv + ["--compare", path])
    assert rc == 0
    lines = json_lines(out)
    assert lines[-1] == rd_sweep.compare(str(path), sweep_rows(lines))
    assert lines[-1] == {"bd_rate_pct_vs_ref": 0.0,
                         "bd_psnr_db_vs_ref": 0.0, "bd_msssim_db_vs_ref": 0.0}


def test_no_card_exits_2(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [str(a) for a in ARGV if a != "--cpu"]
    assert rd_sweep.main(argv) == 2
    assert rd_sweep.main(argv + ["--procs", "2"]) == 2
    assert "--cpu" in capsys.readouterr().err


def test_failed_worker_raises_with_its_rc(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    argv = [str(a) for a in ARGV] + ["--procs", "2"]
    argv[argv.index("--ckpt") + 1] = str(tmp_path / "missing")
    with pytest.raises(RuntimeError, match=r"sweep worker failed \(rc 1\)"):
        run_port(rd_sweep.main, argv)
