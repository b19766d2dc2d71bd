"""The frozen FLOP count (the AIVC architecture's ``frame_flops``)
against torch's own counter and the counts it has always given, and the
roofline byte counts."""

import dataclasses
import json
import types

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from harness.bench import HBM_BYTES_S
from harness.manifest import Manifest, load_file
import tinycell

REPO = tinycell.REPO
frame_flops = load_file(REPO / "codecbench/architectures/aivc.py").frame_flops


@pytest.fixture(scope="module")
def f32_fullnet():
    from aivc_tpu_torch.utils.checkpoint import model_from_params, read_tree
    torch.set_num_threads(2)
    cfg, tree = read_tree(REPO / "models_ckpt/bf16-r5")
    rp = dataclasses.replace
    cfg = rp(cfg, mofnet=rp(cfg.mofnet, dtype="float32"),
             codecnet=rp(cfg.codecnet, dtype="float32"))
    return json.loads(cfg.to_json()), model_from_params(cfg, tree, "cpu")


@pytest.mark.parametrize("ftype,published", [(0, 11.116e9), (1, 19.082e9),
                                             (2, 19.904e9)])
def test_flops_equal_the_flop_counter(f32_fullnet, ftype, published):
    model_cfg, model = f32_fullnet
    g = torch.Generator().manual_seed(0)
    x = [torch.rand((1, 3, 128, 128), generator=g) for _ in range(3)]
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        model.forward_frame(x[0], x[1], x[2], 0.0, ftype)
    counted = fc.get_total_flops()
    mine = frame_flops(model_cfg, ftype, 128, 128)
    # torch also counts the hyper-prior's small einsum (rate of z).
    assert abs(mine - counted) <= 1e-5 * counted
    assert round(counted / 1e9, 3) == pytest.approx(published / 1e9)
    # 1080p pads to 1088 rows.
    assert frame_flops(model_cfg, ftype, 1080, 1920) == pytest.approx(
        mine * 1088 * 1920 / 128 / 128, rel=0.02)
    assert (frame_flops(model_cfg, ftype, 1080, 1920, "decode")
            < frame_flops(model_cfg, ftype, 1080, 1920, "encode"))


# FLOPs of a 1080p I, P and B frame as every benchmark run so far counted
# them: the mfu.* readings of the ledger rest on these numbers.
FROZEN_1080P = {"encode": [1417305047040, 2432944081920, 2537701248000],
                "decode": [766364221440, 1404568657920, 1509325824000]}


@pytest.mark.parametrize("config", ["aivc-r5", "aivc-f32"])
@pytest.mark.parametrize("part", ["encode", "decode"])
def test_frozen_1080p_counts(config, part):
    man = Manifest(REPO)
    cfg = man.config(config)
    count = man.architecture(cfg).frame_flops
    assert [count(cfg["model"], t, 1080, 1920, part)
            for t in (0, 1, 2)] == FROZEN_1080P[part]


def test_k3_bytes_give_the_bound():
    k3 = load_file(REPO / "codecbench/rooflines/k3.py")
    calls = types.SimpleNamespace(k3=[((4, 1088, 1920), (4, 1088, 1920))])
    ms = k3.bytes_moved(calls) / HBM_BYTES_S * 1e3
    assert round(ms, 4) == 0.0599


def test_k1_k2_bytes():
    k1 = load_file(REPO / "codecbench/rooflines/k1.py")
    k2 = load_file(REPO / "codecbench/rooflines/k2.py")
    seg0 = torch.tensor([100, 40], dtype=torch.int32)
    calls = types.SimpleNamespace(
        k1=[((2, 1024), 8, seg0)],
        k2=[((2, 1024), 8, torch.tensor([0, 0]), torch.tensor([924, 984]))])
    assert k1.bytes_moved(calls) == 8 * 2048 + 2 * (924 + 984) + 4 * 16
    assert k2.bytes_moved(calls) == 8 * 2048 + 2 * (924 + 984) + 8 * 16


def _ctx(trace):
    return {"trace": trace, "hbm_bytes_s": HBM_BYTES_S,
            "load": lambda rel: load_file(REPO / "codecbench" / rel)}


@pytest.mark.parametrize("metric,side", [("device_idle.encode", "encode"),
                                         ("device_idle.decode", "decode"),
                                         ("device_idle.ldp", "encode")])
def test_idle_readers(metric, side):
    read = Manifest(REPO).reader(metric).read
    part = {"window_s": 2.0, "busy_s": 1.5, "kernels": [], "spans": []}
    other = "decode" if side == "encode" else "encode"
    assert read(_ctx({side: part, other: None})) == pytest.approx(25.0)
    assert read(_ctx({side: None, other: part})) is None
    assert read(_ctx(None)) is None


@pytest.mark.parametrize("metric,side", [("k1_roofline.encode", "encode"),
                                         ("k2_roofline.decode", "decode"),
                                         ("k3_roofline.decode", "decode")])
def test_roofline_readers(metric, side):
    """The share is the bytes' least time over the kernels' traced time;
    a trace without the kernel gives nothing, never 0."""
    read = Manifest(REPO).reader(metric).read
    calls = types.SimpleNamespace(
        k1=[((4, 1024), 8, torch.zeros(4, dtype=torch.int32))],
        k2=[((4, 1024), 8, torch.zeros(4), torch.full((4,), 1000))],
        k3=[((4, 1088, 1920), (4, 1088, 1920))])
    kernel = metric.split("_")[0]
    roof = load_file(REPO / f"codecbench/rooflines/{kernel}.py")
    least_us = roof.bytes_moved(calls) / HBM_BYTES_S * 1e6
    name = {"k1": "rans_encode_lanes_kernel", "k2": "rans_decode_kernel",
            "k3": "warp_packed_kernel"}[kernel]
    part = {"kernels": [(name, 10.0, 10.0 + 4 * least_us),
                        ("other_kernel", 0.0, 5.0)]}
    trace = {side: part, "calls": {side: calls}}
    assert read(_ctx(trace)) == pytest.approx(25.0)
    part["kernels"] = part["kernels"][1:]
    assert read(_ctx(trace)) is None
