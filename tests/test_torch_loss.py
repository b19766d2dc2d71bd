"""The port's RD loss and entropy-model pieces against the JAX package's,
on the host:

* ``gop_rd_loss`` in eval mode on tiny-toy, GOP 1_GOP_2 at 128x128 with
  the vertically clamped warp on both sides: every log and the loss
  within 1e-4 relative + 2e-5 absolute; measured 7.1e-6 relative (dist,
  dist_pure and the loss, from MS-SSIM's filter order) and at most
  8.4e-7 elsewhere (flow_max).
* FactorizedPrior's bin probability: 1e-6 of the largest value; the
  Laplace and normal bin probabilities: 1e-6 relative + 2.5e-7 absolute
  (two float32 steps at 1: exp and ndtr differ by an ulp or two),
  measured 1.2e-7; the rate proxy on the same probabilities: 1e-6
  relative, measured 9.5e-7 bits on values near 16.
* ``ste_round``: round half to even, identity gradient.
* Training and the mixture entropy models, refused before the training
  slice: ``gop_rd_loss(training=True)`` on an I-frame, and a mixture
  ConditionalNet's eval latents and rates, against JAX's.
"""

import dataclasses
import importlib
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from aivc_tpu.config import ModelConfig
from aivc_tpu.gop import generate_gop_struct as j_gop
from aivc_tpu.models.fullnet import FullNet as JFullNet
from aivc_tpu.ops import entropy_models as jem
from aivc_tpu.train.loss import gop_rd_loss as j_loss
from aivc_tpu_torch.config import ConditionalNetConfig
from aivc_tpu_torch.gop import generate_gop_struct
from aivc_tpu_torch.models.conditional import ConditionalNet
from aivc_tpu_torch.ops import entropy_models as tem
from aivc_tpu_torch.ops import warp as tw
from aivc_tpu_torch.ops.quantizer import ste_round
from aivc_tpu_torch.train.loss import gop_rd_loss
from aivc_tpu_torch.utils.checkpoint import load_checkpoint, read_params

ROOT = Path(__file__).resolve().parents[1]
jw = importlib.import_module("aivc_tpu.ops.warp")
LOG_KEYS = {"rate_bpp", "mode_rate_bpp", "codec_rate_bpp", "mse", "dist",
            "dist_pure", "psnr", "flow_mag", "flow_max", "alpha_mean"}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Test workers share the host's cores: a small PyTorch pool keeps
    them from oversubscribing it (spinning OpenMP threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dist_loss", ["ms_ssim"])
def test_gop_rd_loss_matches_jax(dist_loss, monkeypatch):
    monkeypatch.setattr(jw, "_USE_PALLAS", True)
    monkeypatch.setattr(tw, "_USE_PALLAS", True)
    path = ROOT / "models_ckpt" / "tiny-toy"
    cfg = ModelConfig.from_json((path / "config.json").read_text())
    params = {"params": read_params(path)["params"]}
    jnet = JFullNet(cfg)
    rng = np.random.default_rng(0)
    frames = [(np.round(rng.random((1, 128, 128, 3)) * 255) / 255).astype(
        np.float32) for _ in range(3)]
    kw = dict(dist_loss=dist_loss, weight_i_frame_loss=1.3,
              flow_penalty=0.01, alpha_penalty=0.02)
    with pltpu.force_tpu_interpret_mode():
        fn = jax.jit(lambda p, fr: j_loss(
            jnet, p, fr, j_gop("1_GOP_2"), 1, jax.random.PRNGKey(0), 0.01,
            0.02, training=False, **kw))
        jl, jlogs = fn(params, [jnp.array(f) for f in frames])
    _, model = load_checkpoint(path, device="cpu")
    with torch.inference_mode():
        tl, tlogs = gop_rd_loss(
            model, [torch.tensor(np.ascontiguousarray(f.transpose(0, 3, 1, 2)))
                    for f in frames], generate_gop_struct("1_GOP_2"), 1.0,
            0.01, 0.02, **kw)
    assert set(tlogs) == LOG_KEYS == set(jlogs)
    pairs = [(float(tl), float(jl))] + [(float(tlogs[k]), float(jlogs[k]))
                                         for k in sorted(LOG_KEYS)]
    for out, ref in pairs:
        assert abs(out - ref) <= 1e-4 * abs(ref) + 2e-5, (out, ref)


def test_gop_rd_loss_refuses_training():
    """gop_rd_loss(training=True), which raised before the training slice,
    matches JAX's on an I-frame of tiny-toy with JAX's noise injected
    (the limits of tests/test_torch_train_loss.py: 1e-5 relative on the
    loss and logs, 1e-3 relative L2 on each gradient leaf); without a
    noise source it refuses."""
    from tests.torch_train_ref import compare_training_loss, tiny_toy

    _, model = load_checkpoint(ROOT / "models_ckpt" / "tiny-toy",
                               device="cpu")
    with pytest.raises(ValueError, match="noise source"):
        gop_rd_loss(model, [torch.zeros((1, 3, 64, 64))],
                    generate_gop_struct("1_GOP_0"), 0.0, 0.01, 0.01,
                    training=True)
    jcfg, params = tiny_toy()
    compare_training_loss(jcfg, params, model, "1_GOP_0", "ms_ssim",
                          batch=1)


def test_mixture_model_refused():
    """A mixture ConditionalNet (ec_mode two), which the port refused
    before the training slice, computes JAX's eval latents and rates:
    y_cq and z_q equal, mu, sigma and the rate maps within 1e-5 of the
    largest value (measured 6.8e-7, on mu)."""
    from aivc_tpu.models.conditional import ConditionalNet as JNet
    from aivc_tpu.models.zoo import TINY as J_TINY
    from aivc_tpu_torch.utils.checkpoint import params_from_jax

    jc = dataclasses.replace(J_TINY.codecnet, ec_mode="two",
                             in_c_shortcut=0, gain_p_b=False)
    x = np.random.default_rng(5).random((1, 64, 64, jc.in_c)).astype(
        np.float32)
    jnet = JNet(jc)
    variables = jax.jit(lambda r, v: jnet.init(r, v, None, 0.0, 0))(
        jax.random.PRNGKey(1), jnp.asarray(x))
    jlat = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda p, v: jnet.apply(p, v, 0.0, 0, method=JNet.encode_latents))(
            variables, jnp.asarray(x)))
    net = ConditionalNet(ConditionalNetConfig(**dataclasses.asdict(jc)))
    net.load_state_dict(params_from_jax(jax.tree_util.tree_map(
        np.asarray, variables)), strict=True)
    assert net.h_s.ConvBlock_0.Conv_0.weight.shape[0] == 5 * jc.nb_ft_y
    with torch.inference_mode():
        lat = net.encode_latents(torch.from_numpy(np.ascontiguousarray(
            x.transpose(0, 3, 1, 2))), 0.0, 0)
    assert sorted(lat) == sorted(jlat)
    for k in ("y_cq", "z_q"):
        assert np.array_equal(lat[k].permute(0, 2, 3, 1).numpy(), jlat[k])
    for k in ("mu", "sigma", "rate_y", "rate_z"):
        out = lat[k].permute(0, 2, 3, 1).numpy()
        err = np.abs(out - jlat[k]).max() / np.abs(jlat[k]).max()
        assert err <= 1e-5, (k, err)


def test_factorized_prior_matches_jax():
    rng = np.random.default_rng(1)
    C = 8
    prior = jem.FactorizedPrior(C)
    params = prior.init(jax.random.PRNGKey(2), jnp.zeros((1, 2, 2, C)))
    z = np.round(rng.normal(0, 3, (2, 5, 6, C))).astype(np.float32)
    ref = np.asarray(prior.apply(params, jnp.array(z)))
    tprior = tem.FactorizedPrior(C)
    with torch.no_grad():
        for k, v in params["params"].items():
            getattr(tprior, k).copy_(torch.tensor(np.asarray(v)))
        out = tprior(torch.tensor(np.ascontiguousarray(
            z.transpose(0, 3, 1, 2)))).permute(0, 2, 3, 1).numpy()
    assert np.abs(out - ref).max() <= 1e-6 * np.abs(ref).max()
    rb = np.asarray(jem.rate_bits(jnp.array(ref)))
    assert np.allclose(tem.rate_bits(torch.tensor(ref)).numpy(), rb,
                       rtol=1e-6, atol=0)


@pytest.mark.parametrize("family", ["laplace", "normal"])
def test_bin_prob_matches_jax(family):
    rng = np.random.default_rng(3)
    y = np.round(rng.normal(0, 4, (2, 16, 4, 4))).astype(np.float32)
    sigma = np.exp(rng.uniform(-4, 3, y.shape)).astype(np.float32)
    ref = np.asarray(jem.bin_prob(jnp.array(y), jnp.array(sigma), family))
    out = tem.bin_prob(torch.tensor(y), torch.tensor(sigma), family).numpy()
    assert np.allclose(out, ref, rtol=1e-6, atol=2.5e-7)
    ref_bits = np.asarray(jem.rate_bits(jnp.array(ref)))
    assert np.allclose(tem.rate_bits(torch.tensor(ref)).numpy(), ref_bits,
                       rtol=1e-6, atol=0)
    with pytest.raises(ValueError):
        tem.bin_prob(torch.tensor(y), torch.tensor(sigma), "cauchy")


def test_ste_round():
    x = torch.tensor([-1.5, -0.5, 0.4, 0.5, 1.5, 2.5], requires_grad=True)
    y = ste_round(x)
    assert y.tolist() == [-2.0, -0.0, 0.0, 0.0, 2.0, 2.0]
    y.sum().backward()
    assert x.grad.tolist() == [1.0] * 6
