"""Checkpoint surgery of the port on the host: ``gain_smooth``,
``make_lowrate`` and ``swa`` write the files the JAX scripts write for
the same arguments, ``config.json`` and ``params.msgpack`` byte for byte.

* gain_smooth: tiny-toy, row 1.
* make_lowrate: shift 3 on a 7-rate tiny checkpoint
  (torch_scripts_ref.tiny7: tiny-toy's tree with 7-row gain matrices and
  bf16-r5's lambda ladder; tiny-toy's own ladder has 3 rows, which
  refuses shift 3 in both packages), and shift 1 with tail_boost 2 on
  tiny-toy.
* swa: tiny-toy with its gain-smoothed twin (the JAX script's refusal
  of two configs too).

The JAX scripts run in this process (tests/torch_scripts_ref.py), their
checkpoint templates memoised.
"""

import numpy as np
import pytest

import torch

from aivc_tpu_torch.scripts import gain_smooth, make_lowrate, swa
from aivc_tpu_torch.utils.checkpoint import read_tree
from torch_scripts_ref import (
    TINY_TOY,
    jax_init_memo,
    limit_threads,
    run_jax_script,
    run_port,
    same_files,
)
from torch_scripts_ref import tiny7 as make_tiny7


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = limit_threads()
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def memo():
    with jax_init_memo():
        yield


@pytest.fixture(scope="module")
def tiny7(tmp_path_factory):
    return make_tiny7(tmp_path_factory.mktemp("tiny7") / "ckpt")


def both(tmp_path, jax_name, port_main, argv, out_flag="--out"):
    """Run the JAX script and the port on ``argv`` (each with its own
    output directory): (JAX's directory, the port's, the port's stdout,
    JAX's stdout)."""
    j, p = tmp_path / "jax", tmp_path / "port"
    jout = run_jax_script(jax_name, argv + [out_flag, j])
    rc, pout = run_port(port_main, argv + [out_flag, p])
    assert rc == 0
    return j, p, pout, jout


def test_gain_smooth_equals_jax(tmp_path, memo):
    j, p, pout, jout = both(tmp_path, "gain_smooth", gain_smooth.main,
                            ["--ckpt", TINY_TOY, "--rows", "1"])
    assert same_files(j, p) == {"config.json": True, "params.msgpack": True}
    assert pout.replace(str(p), "OUT") == jout.replace(str(j), "OUT")


@pytest.mark.parametrize("case", ["shift3", "shift1_tail2"])
def test_make_lowrate_equals_jax(tmp_path, memo, tiny7, case):
    argv = (["--src", tiny7, "--shift", "3"] if case == "shift3" else
            ["--src", TINY_TOY, "--shift", "1", "--tail_boost", "2"])
    j, p, pout, jout = both(tmp_path, "make_lowrate", make_lowrate.main,
                            argv)
    assert same_files(j, p) == {"config.json": True, "params.msgpack": True}
    assert pout.replace(str(p), "OUT") == jout.replace(str(j), "OUT")
    cfg, _ = read_tree(p)
    assert cfg.name == "tpu-aivc-tiny-lr"
    src_lam = read_tree(argv[1])[0].lambda_tradeoff
    shift = int(argv[3])
    assert cfg.lambda_tradeoff[:len(src_lam) - shift] == src_lam[shift:]


def test_swa_equals_jax(tmp_path, memo):
    smoothed = tmp_path / "gs"
    assert run_port(gain_smooth.main, ["--ckpt", TINY_TOY, "--rows", "1",
                                       "--out", smoothed])[0] == 0
    j, p, pout, jout = both(tmp_path, "swa", swa.main,
                            [TINY_TOY, smoothed])
    assert same_files(j, p) == {"config.json": True, "params.msgpack": True}
    assert pout.replace(str(p), "OUT") == jout.replace(str(j), "OUT")
    # the average lies between its two trees, leaf by leaf
    a, b, avg = (read_tree(d)[1]["params"]["codecnet"]["gain_I"]["enc_gain"]
                 for d in (TINY_TOY, smoothed, p))
    assert np.all(avg >= np.minimum(a, b) - 1e-7)
    assert np.all(avg <= np.maximum(a, b) + 1e-7)


def test_swa_refuses_two_configs_as_jax(tmp_path, memo, tiny7):
    argv = [TINY_TOY, tiny7, "--out", tmp_path / "x"]
    with pytest.raises(SystemExit) as ours:
        run_port(swa.main, argv)
    with pytest.raises(SystemExit) as theirs:
        run_jax_script("swa", argv)
    assert "config mismatch" in str(ours.value)
    assert str(ours.value) == str(theirs.value)
    assert not (tmp_path / "x").exists()
