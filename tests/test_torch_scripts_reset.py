"""``reset_flow_head`` of the port on the host against the JAX script, on
tiny-toy with --flow_bound 32 --ac_max 64 (the default --gdn_clamp 16):

* config.json equals JAX's byte for byte;
* every leaf outside mofnet.g_s and mofnet.g_a_ref equals JAX's output
  byte for byte (dtype, shape and data);
* the re-initialised leaves have JAX's shapes and dtypes (float32), their
  biases are zero, and each conv kernel's std is within 10% of the
  truncated lecun-normal's sqrt(1 / fan_in) (JAX draws from PRNGKey(17),
  the port from torch.Generator seed 17: the same distributions, other
  numbers);
* the 16 zeroed flow-head channels of g_s.UpBlock_3.Conv_0 (kernel and
  bias) sit at JAX's indices: the channels that are zero in JAX's output
  are zero in the port's, and no other channel of the port's is.
"""

from pathlib import Path

import numpy as np
import pytest

import torch

from aivc_tpu_torch.scripts import reset_flow_head
from aivc_tpu_torch.utils.checkpoint import read_tree
from torch_scripts_ref import (
    TINY_TOY,
    jax_init_memo,
    limit_threads,
    run_jax_script,
    run_port,
)

ARGV = ["--ckpt", TINY_TOY, "--flow_bound", "32", "--ac_max", "64"]
STD_RTOL = 0.10


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = limit_threads()
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def outs(tmp_path_factory):
    d = tmp_path_factory.mktemp("reset")
    with jax_init_memo():
        jout = run_jax_script("reset_flow_head", ARGV + ["--out", d / "jax"])
    rc, pout = run_port(reset_flow_head.main, ARGV + ["--out", d / "port"])
    assert rc == 0
    return d / "jax", d / "port", jout, pout


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        out.update(flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def is_reset(key: str) -> bool:
    return key.startswith(("params.mofnet.g_s.", "params.mofnet.g_a_ref."))


def test_config_and_message_equal_jax(outs):
    j, p, jout, pout = outs
    assert (Path(j) / "config.json").read_bytes() == \
        (Path(p) / "config.json").read_bytes()
    cfg, _ = read_tree(p)
    assert (cfg.flow_bound, cfg.ac_max_val, cfg.mofnet.gdn_clamp,
            cfg.codecnet.gdn_clamp) == (32.0, 64, 16.0, 16.0)
    assert pout.replace(str(p), "OUT") == jout.replace(str(j), "OUT")


def test_kept_leaves_equal_jax(outs):
    j, p = (flat(read_tree(d)[1]) for d in outs[:2])
    assert set(j) == set(p)
    kept = [k for k in j if not is_reset(k)]
    assert len(kept) > 50
    for k in kept:
        assert j[k].dtype == p[k].dtype and j[k].shape == p[k].shape, k
        assert j[k].tobytes() == p[k].tobytes(), k


def test_fresh_leaves_match_jax_distribution(outs):
    j, p = (flat(read_tree(d)[1]) for d in outs[:2])
    fresh = [k for k in j if is_reset(k)]
    head = "params.mofnet.g_s.UpBlock_3.Conv_0."
    v_idx = reset_flow_head.flow_head_channels(6)
    n_kernels = 0
    for k in fresh:
        assert j[k].dtype == p[k].dtype == np.float32, k
        assert j[k].shape == p[k].shape, k
        if k.endswith(".bias"):
            assert not np.any(p[k]) and not np.any(j[k]), k
        elif k.endswith(".kernel"):
            live = [c for c in range(p[k].shape[-1])
                    if not (k.startswith(head) and c in v_idx)]
            lecun = np.sqrt(1.0 / np.prod(p[k].shape[:3]))
            for tree in (p, j):
                std = float(tree[k][..., live].std())
                assert abs(std / lecun - 1.0) <= STD_RTOL, (k, std, lecun)
            n_kernels += 1
    assert n_kernels >= 8


def test_zeroed_channels_at_jax_indices(outs):
    j, p = (flat(read_tree(d)[1]) for d in outs[:2])
    for leaf in ("kernel", "bias"):
        key = f"params.mofnet.g_s.UpBlock_3.Conv_0.{leaf}"
        axes = tuple(range(j[key].ndim - 1))
        zero_j = np.flatnonzero(~np.any(j[key], axis=axes))
        zero_p = np.flatnonzero(~np.any(p[key], axis=axes))
        expect = reset_flow_head.flow_head_channels(6)
        assert len(expect) == 16
        if leaf == "kernel":
            assert list(zero_j) == list(zero_p) == sorted(expect)
        else:   # the fresh biases are zero everywhere in both
            assert set(expect) <= set(zero_j) and set(expect) <= set(zero_p)
