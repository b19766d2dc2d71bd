"""The ELIC architecture (architectures/elic.py) on the host: its module's
functions, its FLOP count against torch's counter and a hand derivation
at 1080p, its seeded tree against the program's layout, the ctx_ms
readers, and whole runs of the tiny cell ``tiny.elic`` (tinyelic.py):
correct on sound seeds, not correct under the planted faults and the
float8 control."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from harness.faults import plant
from harness.manifest import Manifest, load_file
import tinycell
import tinyelic

REPO = tinycell.REPO
ARCH = load_file(REPO / "codecbench/architectures/elic.py")
ARCH_FUNCTIONS = ("system", "capture_decode", "judge", "control",
                  "frame_flops", "init_tree", "fault")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return tinyelic.make(tmp_path_factory.mktemp("tinyelic"))


def test_the_cell_finds_its_architecture_and_files():
    man = Manifest(REPO)
    cell = man.workload("elic.ai1080")
    config = man.config(cell["config"])
    arch = man.architecture(config)
    for fn in ARCH_FUNCTIONS:
        assert callable(getattr(arch, fn)), fn
    assert set(man.limits("elic.ai1080")) == {
        "decode_vs_encoder_px", "latent_excess", "latent_mismatch",
        "recon_gap", "scale_mismatch"}
    names = {m["name"] for m in man.metrics("elic.ai1080", traced=True)}
    assert names == {"mfu.encode", "mfu.decode", "k1_roofline.encode",
                     "k2_roofline.decode", "device_idle.encode",
                     "device_idle.decode", "finish_share.encode",
                     "ctx_ms.encode", "ctx_ms.decode"}
    assert {m["name"] for m in man.metrics("elic.ai1080", False)} == {
        "encode_fps", "decode_fps", "setup_s"}
    assert config["model"]["groups"] == [16, 16, 32, 64, 192]
    assert sum(config["model"]["groups"]) == config["model"]["m"] == 320


@torch.no_grad()
def test_flops_equal_the_flop_counter():
    """The count of a tiny frame at 128 x 192 is what torch's counter
    counts running the codec's stages: g_a, h_a, h_s, the ten steps (the
    channel context once a group, the spatial context in the non-anchor
    pass, the aggregation in both), g_s."""
    from aivc_tpu_torch.config import ElicConfig
    from aivc_tpu_torch.models.elic import Elic

    cfg = ElicConfig(**{**tinyelic.MODEL, "groups": (2, 2, 4, 8, 24),
                        "ctx_hidden": (12, 8), "agg_hidden": (24, 16)})
    model = Elic(cfg)
    x = torch.rand((1, 3, 128, 192))
    with FlopCounterMode(display=False) as fc:
        y = model.analyze(x)
        hyper = model.hyper_synthesize(torch.round(model.hyper_analyze(y)))
        done, c0 = [], 0
        for k, g in enumerate(cfg.groups):
            cc = model.channel_context(k, done)
            sc = torch.zeros((1, 2 * g) + y.shape[2:])
            model.params(k, hyper, cc, sc)
            model.params(k, hyper, cc, model.spatial_context(k, y[:, c0:c0
                                                                  + g]))
            done.append(y[:, c0:c0 + g])
            c0 += g
        model.synthesize(y)
    assert fc.get_total_flops() == ARCH.frame_flops(tinyelic.MODEL, 0, 128,
                                                    192)


def test_frozen_1080p_counts():
    """ELIC at 1920 x 1080 (padded to 1088 rows), by hand, in multiply-adds
    (FLOPs are twice): pixels a level 1: 522,240, 2: 130,560, 3: 32,640,
    4 (y): 8,160, 5: 2,040, 6 (z): 510.  A bottleneck of 192 channels
    costs 192*96 + 96*96*9 + 96*192 = 119,808 a pixel, of 320 channels
    332,800; an attention block six of them plus a 1x1 conv (755,712 and
    2,099,200).  g_a = 3*192*25*522,240 + 3*119,808*522,240 +
    192*192*25*130,560 + 3*119,808*130,560 + 755,712*130,560 +
    192*192*25*32,640 + 3*119,808*32,640 + 192*320*25*8,160 +
    2,099,200*8,160 = 532,617,953,280; g_s the same terms (a transposed
    conv counted by its input pixels).  h_a = (320*192*9 + 192*192*25/4 +
    192*192*25/16) * 8,160 = 6,862,233,600; h_s = 192*192*25*510 +
    192*288*25*2,040 + 288*640*9*8,160 = 16,826,572,800.  The context
    steps over the 8,160 positions: channel contexts of 16, 32, 64, 128
    input channels (c*224*25 + 224*128*25 + 128*2g*25 each), spatial
    contexts g*2g*25, aggregations twice a group ((640 + 4g or, first,
    640 + 2g)*640 + 640*512 + 512*2g): 146,122,752,000."""
    model = Manifest(REPO).config("elic-n192m320")["model"]
    parts = ARCH._parts(model, 1088, 1920)
    assert parts == {"g_a": 2 * 532617953280, "g_s": 2 * 532617953280,
                     "h_a": 2 * 6862233600, "h_s": 2 * 16826572800,
                     "ctx": 2 * 146122752000}
    assert ARCH.frame_flops(model, 0, 1080, 1920, "encode") == 2470094929920
    assert ARCH.frame_flops(model, 0, 1080, 1920, "decode") == 1391134556160
    assert ARCH.frame_flops(model, 2, 1080, 1920) == 2470094929920


def test_seeded_tree_is_the_programs_layout():
    """init_tree's leaves are the program's parameters, shape for shape;
    the gain scales g_a's last kernel alone."""
    from aivc_tpu_torch.config import ElicConfig
    from aivc_tpu_torch.models.elic import Elic
    from aivc_tpu_torch.utils.checkpoint import (model_from_params,
                                                 params_to_jax)

    config = {"model": tinyelic.MODEL, "init": {"g_a_gain": 3.0}}
    tree = ARCH.init_tree(config, torch.Generator().manual_seed(7))
    cfg = ElicConfig.from_json(json.dumps(tinyelic.MODEL))
    want = params_to_jax(Elic(cfg).state_dict())["params"]

    def shapes(t, pre=()):
        out = {}
        for k, v in t.items():
            out.update(shapes(v, pre + (k,)) if isinstance(v, dict)
                       else {pre + (k,): tuple(v.shape)})
        return out
    assert shapes(tree) == shapes(want)
    model_from_params(cfg, tree, "cpu")
    plain = ARCH.init_tree({"model": tinyelic.MODEL},
                           torch.Generator().manual_seed(7))
    for path in shapes(tree):
        a, b = tree, plain
        for k in path:
            a, b = a[k], b[k]
        ratio = 3.0 if path[:2] == ("g_a", "conv_3") and path[-1] == \
            "kernel" else 1.0
        assert (a == b * ratio).all() or abs(a - b * ratio).max() < 1e-6


@pytest.mark.parametrize("side", ["encode", "decode"])
def test_ctx_readers(side):
    read = Manifest(REPO).reader(f"ctx_ms.{side}").read
    part = {"spans": [("ctx", 10.0, 2010.0), ("batch", 0.0, 9000.0),
                      ("ctx", 3000.0, 5000.0)]}
    other = "decode" if side == "encode" else "encode"
    assert read({"trace": {side: part, other: None, "frames": 2}}) == 2.0
    assert read({"trace": {side: {"spans": []}, other: None,
                           "frames": 2}}) is None
    assert read({"trace": {side: None, other: part, "frames": 2}}) is None
    assert read({"trace": None}) is None


@pytest.mark.parametrize("seed", [7, 2 ** 31 + 11, 900000000001])
def test_tiny_elic_is_correct(root, capsys, seed):
    rc, res, err = tinycell.run_tiny(root, capsys, seed=seed,
                                     cell=tinyelic.CELL)
    assert rc == 0 and res["correct"] is True, res and res["checks"]
    assert set(res["checks"]) == set(tinyelic.LIMITS)
    assert res["checks"]["decode_vs_encoder_px"]["value"] == 0
    assert res["checks"]["latent_excess"]["value"] < 1e-3
    assert set(res["metrics"]) == {"encode_fps", "decode_fps", "setup_s"}


def test_tiny_elic_traced_result_line(root, capsys):
    rc, res, _ = tinycell.run_tiny(root, capsys, trace=1,
                                   cell=tinyelic.CELL)
    assert rc == 0 and res["correct"] is True
    # On the host there is no device trace: only the host-clock layers.
    assert set(res["metrics"]) == {"mfu.encode", "mfu.decode",
                                   "finish_share.encode"}


@pytest.mark.parametrize("fault", ["nospatial", "token", "unchanged",
                                   "half_batch"])
def test_a_planted_fault_is_not_correct(root, capsys, fault):
    brk = (plant(fault) if fault == "half_batch" else
           (lambda system, arch: arch.fault(fault, system)))
    rc, res, _ = tinycell.run_tiny(root, capsys, break_system=brk,
                                   cell=tinyelic.CELL)
    assert rc == 0
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("precision,correct", [("fp8", False),
                                               ("f32", True)])
def test_the_control_is_judged_by_the_cell_limits(root, precision, correct):
    import control
    res = control.control(tinyelic.CELL, 2 ** 31 + 5, torch.device("cpu"),
                          root=root, precision=precision)
    assert set(res["checks"]) == set(tinyelic.LIMITS)
    assert res["correct"] is correct, res["checks"]


def test_capture_records_every_step(root):
    """capture_decode keeps per batch z and the ten steps' symbols and
    bins, and the DC offsets."""
    from harness import weights
    man = Manifest(root)
    config = man.config(tinyelic.CONFIG)
    traffic = man.traffic("tiny_ai")
    arch = man.architecture(config)
    from aivc_tpu_torch.pipeline.video import synthetic_frames
    frames = synthetic_frames(3, 64, 96)
    with weights.prepared(root, config, arch, "cpu") as d:
        system = arch.system(root, config, traffic, "cpu", d)
        res = system.encode(frames)
        planes, batches = arch.capture_decode(system, res.bitstream)
    assert [len(b["steps"]) for b in batches] == [10, 10]
    assert [b["z"].shape[0] for b in batches] == [2, 1]
    assert all("dc" in b for b in batches)
    assert sorted(planes) == [0, 1, 2]
