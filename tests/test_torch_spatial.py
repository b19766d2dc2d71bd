"""The 'spatial' axis of the port's mesh (aivc_tpu_torch/parallel/mesh.py,
parallel/halo.py) on gloo ranks on the host (parallel/launch.py: one
process a rank, a timeout on the run), against the whole tensor, one
process and aivc_tpu.

* Placements over data 2 x spatial 2: each rank's batch slice and row
  band, gathered back over both axes.
* exchange_rows (through RowBand.pad) equals the rows of
  replication_pad of the whole tensor that the band's conv reads, for
  halos of 1 and 2 rows and 2 and 4 bands (bands of 2 rows with a halo
  of 2: the y level of a 64x64 frame over spatial 2); its gradient
  equals torch.autograd.grad of the same loss through the whole tensor,
  and so does gather_rows's (integer-valued data: every sum is exact,
  so the tensors are equal).
* tiny-toy's g_a and g_s of both nets, split over 2 bands, equal the
  whole-frame outputs bit for bit on the host.
* FrameCodec over spatial 2 and over data 2 x spatial 2 (tiny-toy,
  64x64, RA GOP 4, 5 frames, wave batch 2, as JAX's
  test_combined_data_spatial_mesh_bit_exact): the stream equals one
  process's and aivc_tpu's byte for byte and the mesh codec's own decode
  is bit-exact (each rank checks); bf16-r5 over spatial 2 is held to one
  process's bytes (measured: equal, 595 B).
* make_train_step over spatial 2 and over data 2 x spatial 2 (tiny-toy,
  float32), against one process with the same frames and noise
  (smoke.train_step_on, ms_ssim, 1_GOP_2): loss within 1e-6 relative,
  the logs within 1e-5, each gradient leaf within 1e-4 relative L2 where
  each data rank takes whole microbatches and 1e-3 where it takes a
  sample of a split microbatch (test_torch_parallel.py's limit for that
  layout).
  Measured: loss and logs equal, worst leaf 2.7e-5
  (codecnet.g_s.UpBlock_1.GDN_0.gamma) for spatial 2 alone and for data
  2 x spatial 2 with a microbatch a data rank; with the microbatch split
  a sample a data rank, loss 8.8e-7 and worst leaf 1.1e-4.  The
  parameters after the update are equal on every rank.
* The same step against aivc_tpu's make_train_step (its value_and_grad)
  with JAX's noise fed through FixedNoise, at test_torch_parallel.py's
  setting and limits (compare_with_jax: logs 1e-5 relative, Adam's
  moments 1e-3 relative L2 per leaf, at most 1e-3 of the parameters
  moved apart by more than 1% of lr (2e-3 with ms_ssim, as
  test_torch_parallel.py holds its split ms_ssim step), each with a JAX
  gradient of at most 1e-6).
  Measured (worst log / moments / share moved apart / largest |g|
  moved apart): spatial 2, mse 2.4e-7 / 5.6e-4 / 1.5e-4 / 5.9e-8; data
  2 x spatial 2, a microbatch a data rank, mse 1.4e-6 / 1.6e-4 / 3.3e-4 /
  7.4e-8; spatial 2, ms_ssim 5.0e-6 / 8.1e-4 / 1.33e-3 / 3.8e-7.
* Rows that cannot split raise ValueError naming the sizes, in
  FrameCodec and in the train step (3 bands of a 64-row frame).
"""

from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F

from aivc_tpu.config import CodingConfig as JCodingConfig
from aivc_tpu.pipeline import video as jvideo
from aivc_tpu_torch import smoke
from aivc_tpu_torch.parallel.launch import run_ranks
from aivc_tpu_torch.pipeline import video as tvideo
from aivc_tpu_torch.pipeline.codec import FrameCodec
from aivc_tpu_torch.utils.checkpoint import load_checkpoint
from test_torch_dense_v1 import _jax_codec
from test_torch_train_step import compare_with_jax
from tests.torch_train_ref import (
    frames_nhwc,
    limit_threads,
    tiny_toy,
    to_nchw,
    train_noise,
)

ROOT = Path(__file__).resolve().parents[1]
TINY = ROOT / "models_ckpt" / "tiny-toy"
R5 = ROOT / "models_ckpt" / "bf16-r5"
H = W = 64
N, GOP, WAVE = 5, 4, 2
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = limit_threads()
    yield
    torch.set_num_threads(n)


def ranks(tmp_path, entry, world, **kwargs):
    return run_ranks(entry, world, "gloo", tmp_path, kwargs=kwargs,
                     device="cpu", timeout_s=120)


def test_placements_over_data_and_spatial(tmp_path):
    x = torch.arange(4 * 2 * 8 * 3, dtype=torch.float32).reshape(4, 2, 8, 3)
    res = ranks(tmp_path, "tests.torch_ranks:spatial_placements", 4, x=x,
                spatial=2)
    for r, out in enumerate(res):
        d, s = divmod(r, 2)
        assert out["shape"] == {"data": 2, "spatial": 2}
        assert (out["data_index"], out["spatial_index"]) == (d, s)
        assert torch.equal(out["part"], x[2 * d:2 * d + 2, :,
                                          4 * s:4 * s + 4])
        assert torch.equal(out["stacked"], torch.stack([x, -x])[
            :, 2 * d:2 * d + 2, :, 4 * s:4 * s + 4])
        assert torch.equal(out["back"], x)


@pytest.mark.parametrize("spatial,rows", [(2, 4), (2, 2), (4, 2)])
def test_exchange_rows_matches_whole_tensor(tmp_path, spatial, rows):
    g = torch.Generator().manual_seed(spatial * 10 + rows)
    x = torch.randint(-8, 9, (2, 3, spatial * rows, 5), generator=g).float()
    pads = (1, 2)
    res = ranks(tmp_path, "tests.torch_ranks:halo_exchange", spatial, x=x,
                pads=pads, spatial=spatial)
    assert [r["index"] for r in res] == list(range(spatial))
    for pad in pads:
        whole = x.clone().requires_grad_(True)
        padded = F.pad(whole, (pad, pad, pad, pad), mode="replicate")
        # The band i's conv reads rows i * rows .. (i + 1) * rows + 2 pad
        # of the whole padded tensor.
        bands = [padded[:, :, i * rows:(i + 1) * rows + 2 * pad]
                 for i in range(spatial)]
        weight = res[0][pad]["weight"]
        hp = rows + 2 * pad
        loss = sum((b * weight[:, :, i * hp:(i + 1) * hp]).sum()
                   for i, b in enumerate(bands))
        (grad,) = torch.autograd.grad(loss, whole)
        for i, r in enumerate(res):
            assert torch.equal(r[pad]["weight"], weight)
            assert torch.equal(r[pad]["padded"], bands[i].detach()), pad
        assert torch.equal(torch.cat([r[pad]["grad"] for r in res], dim=2),
                           grad), pad
    gathered = res[0]["gather"]
    assert all(torch.equal(r["gather"]["whole"], x) for r in res)
    whole = x.clone().requires_grad_(True)
    (grad,) = torch.autograd.grad((whole * gathered["weight"]).sum(), whole)
    assert torch.equal(torch.cat([r["gather"]["grad"] for r in res], dim=2),
                       grad)


def test_split_nets_match_whole_frame(tmp_path):
    g = torch.Generator().manual_seed(3)
    x = torch.rand((2, 9, H, W), generator=g)
    y = torch.randn((2, 24, H // 16, W // 16), generator=g)
    res = ranks(tmp_path, "tests.torch_ranks:split_nets", 2, ckpt=str(TINY),
                x=x, y=y, spatial=2)
    for out in res:
        assert out["halo_s"] > 0
        for name in ("mofnet", "codecnet"):
            for whole, split in zip(out[name]["whole"], out[name]["split"]):
                assert whole.shape == split.shape
                assert torch.equal(whole, split), name
    # ... and equal to this process's whole-frame stages
    _, model = load_checkpoint(TINY, device="cpu")
    with torch.no_grad():
        net = model.codecnet
        assert torch.equal(net.g_a(x[:, :6]), res[0]["codecnet"]["whole"][0])


@pytest.fixture(scope="module")
def references():
    """One process's stream and reconstructions of the clip (tiny-toy and
    bf16-r5), and aivc_tpu's tiny-toy stream."""
    frames = tvideo.synthetic_frames(N, H, W)
    out = {"frames": frames}
    for name, ckpt in (("tiny", TINY), ("r5", R5)):
        enc = tvideo.encode_video(
            FrameCodec(*load_checkpoint(ckpt, device="cpu"), H, W,
                       device="cpu"), frames, smoke.ra_coding(GOP),
            wave_batch=WAVE)
        out[name] = (enc.bitstream, smoke.recon_md5(enc.decoded_frames,
                                                    range(N)))
    out["jax"] = jvideo.encode_video(
        _jax_codec(TINY, H, W), frames, JCodingConfig(
            coding_config="RA", gop_size=GOP, intra_period=GOP),
        wave_batch=WAVE).bitstream
    return out


@pytest.mark.parametrize("ckpt,world", [("tiny", 2), ("tiny", 4),
                                        ("r5", 2)],
                         ids=["tiny_spatial", "tiny_data_x_spatial",
                              "r5_spatial"])
def test_spatial_mesh_codec_matches_one_process_and_jax(
        tmp_path, references, ckpt, world):
    res = ranks(tmp_path, "aivc_tpu_torch.smoke:rank_mesh_codec", world,
                ckpt=str(TINY if ckpt == "tiny" else R5),
                frames=references["frames"], gop=GOP, wave_batch=WAVE,
                spatial=2)
    stream, md5 = references[ckpt]
    for out in res:
        assert out["bitstream"] == stream
        assert out["md5"] == md5
        assert out["halo_s"] > 0 and out["gather_s"] > 0
    if ckpt == "tiny":
        assert stream == references["jax"]


TRAIN_CASES = {
    # world, batch, accum, worst leaf, loss rtol
    "spatial": (2, 2, 2, 1e-4, 1e-6),
    "data_x_spatial_microbatch_per_rank": (4, 2, 2, 1e-4, 1e-6),
    "data_x_spatial_split_microbatch": (4, 2, 1, 1e-3, 1e-5),
}


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_spatial_train_step_matches_one_process(tmp_path, case):
    world, batch, accum, leaf_l2, loss_rtol = TRAIN_CASES[case]
    frames = smoke.train_small_inputs(H, batch=batch // accum, accum=accum)
    res = ranks(tmp_path, "aivc_tpu_torch.smoke:rank_train_step", world,
                ckpt=str(TINY), frames=frames, accum=accum, idx_rate=1,
                spatial=2)
    one = smoke.train_step_on(str(TINY), CPU, frames, accum, idx_rate=1)
    assert len({r["params_sha256"] for r in res}) == 1
    lr, ln = res[0]["logs"], one["logs"]
    assert lr["step_skipped"] == ln["step_skipped"] == 0.0
    assert abs(lr["loss"] - ln["loss"]) <= loss_rtol * abs(ln["loss"])
    for k in ("rate_bpp", "mse", "dist_pure", "flow_max", "alpha_mean"):
        assert lr[k] == pytest.approx(ln[k], rel=1e-5, abs=1e-7), k
    assert lr["grad_norm"] == pytest.approx(ln["grad_norm"], rel=1e-5)
    worst = max(r[1] for r in smoke.leaf_distances(res[0]["grads"],
                                                   one["grads"]))
    assert worst <= leaf_l2, worst


JGOP, JB, JLR = "1_GOP_1", 2, 1e-4
JKW = dict(flow_penalty=0.01, alpha_penalty=0.02)


@pytest.mark.parametrize("world,accum,dist,moved_apart_max", [
    (2, 1, "mse", 1e-3),
    (4, 2, "mse", 1e-3),
    (2, 1, "ms_ssim", 2e-3),
], ids=["spatial", "data_x_spatial", "spatial_ms_ssim"])
def test_spatial_train_step_matches_jax(tmp_path, world, accum, dist,
                                        moved_apart_max):
    import jax
    import jax.numpy as jnp

    from aivc_tpu.gop import generate_gop_struct as j_gop
    from aivc_tpu.models.fullnet import FullNet as JFullNet
    from aivc_tpu.train.trainer import make_optimizer as j_make_optimizer
    from aivc_tpu.train.trainer import make_train_step as j_make_train_step
    from test_torch_parallel import _gradient_moved_apart

    jcfg, params = tiny_toy()
    gop = j_gop(JGOP)
    fr = frames_nhwc(3, len(gop), JB, H)
    rng = jax.random.PRNGKey(11)
    jopt = j_make_optimizer(JLR)
    jstep = j_make_train_step(JFullNet(jcfg), jcfg, gop, jopt, accum=accum,
                              dist_loss=dist, **JKW)
    noise = train_noise(rng, gop, jcfg, JB, H, W, accum)
    res = ranks(tmp_path, "tests.torch_ranks:train_step_fixed_noise", world,
                ckpt=str(TINY), cases=[(to_nchw(fr), noise)], gop=JGOP,
                accum=accum, lr=JLR, kw=dict(JKW, dist_loss=dist),
                spatial=2)
    _, model = load_checkpoint(TINY, device="cpu")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    jp, jst, jlogs = jstep(params, jopt.init(params), jnp.asarray(fr), 1,
                           rng)
    outs = [r[0] for r in res]
    for n in before:
        assert all(torch.equal(o["params"][n], outs[0]["params"][n])
                   for o in outs[1:]), n
    out = outs[0]
    assert out["left"] == 0
    assert out["logs"]["step_skipped"] == float(jlogs["step_skipped"]) == 0.0
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(out["params"][n])
    opt = SimpleNamespace(mu=out["mu"], nu=out["nu"], count=out["count"])
    worst = compare_with_jax((jp, jst), jlogs, model, opt, before,
                             out["logs"], moved_apart_max=moved_apart_max)
    g_apart = _gradient_moved_apart(jp, jst, model, before)
    print(f"{world=} {accum=} {dist=}: {worst}, largest |g| moved apart "
          f"{g_apart:.3e}")
    assert g_apart <= 1e-6


def test_rows_that_cannot_split_raise(tmp_path):
    res = ranks(tmp_path, "tests.torch_ranks:mesh_errors", 3,
                ckpt=str(TINY), spatial=3)
    for out in res:
        assert "64 padded rows" in out["codec"]
        assert "spatial=3" in out["codec"]
        assert "64 % 48 = 16" in out["codec"]
        assert out["train"].startswith("make_train_step: 64 padded rows")
        assert out["builds_192"]
