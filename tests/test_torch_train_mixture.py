"""Mixture entropy models (ec_mode two in MOFNet, three_gamma in
CodecNet) on a random-init tiny model of the JAX package, loaded through
params_from_jax (mirroring tests/test_models.py:132-180):

* the training loss, every log and every gradient leaf against
  ``jax.value_and_grad`` with JAX's noise injected (GOP 1_GOP_2, 64x64,
  batch 1, mse), within the limits of tests/test_torch_train_loss.py
  (1e-5 relative, 1e-3 relative L2): measured 2.3e-7 and 3.6e-6;
* the port's own coding round trip of a 3-frame RA clip, which reads
  component 0: decode equal to the encoder's reconstruction, bit for
  bit.
"""

import dataclasses

import numpy as np
import pytest

import jax
import torch

from aivc_tpu.models.zoo import TINY as J_TINY
from aivc_tpu.models.zoo import init_fullnet as j_init
from aivc_tpu_torch.config import CodingConfig
from aivc_tpu_torch.config import ModelConfig as TModelConfig
from aivc_tpu_torch.pipeline import video as tvideo
from aivc_tpu_torch.pipeline.codec import FrameCodec
from aivc_tpu_torch.utils.checkpoint import model_from_params
from tests.torch_train_ref import compare_training_loss, limit_threads


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = limit_threads()
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mixture():
    jcfg = dataclasses.replace(
        J_TINY, name="tiny-mix",
        mofnet=dataclasses.replace(J_TINY.mofnet, ec_mode="two"),
        codecnet=dataclasses.replace(J_TINY.codecnet,
                                     ec_mode="three_gamma"))
    _, params = j_init(jcfg, jax.random.PRNGKey(4), spatial=64)
    params = jax.tree_util.tree_map(np.asarray, params)
    tcfg = TModelConfig.from_json(jcfg.to_json())
    assert tcfg.mofnet.sigma_cond_c == 5 * tcfg.mofnet.nb_ft_y
    assert tcfg.codecnet.sigma_cond_c == 11 * tcfg.codecnet.nb_ft_y
    return jcfg, params, tcfg, model_from_params(tcfg, params, "cpu")


def test_mixture_training_loss_and_grads_match_jax(mixture):
    jcfg, params, _, model = mixture
    compare_training_loss(jcfg, params, model, "1_GOP_2", "mse", seed=2,
                          batch=1)


def test_mixture_models_code_bit_exactly(mixture):
    _, _, tcfg, model = mixture
    codec = FrameCodec(tcfg, model, 64, 64, device="cpu")
    frames = tvideo.synthetic_frames(3, 64, 64)
    enc = tvideo.encode_video(codec, frames, CodingConfig(
        coding_config="RA", gop_size=2, intra_period=2))
    dec = tvideo.decode_video(codec, enc.bitstream)
    assert sorted(dec) == [0, 1, 2]
    for i in dec:
        for c in ("y", "u", "v"):
            np.testing.assert_array_equal(dec[i][c],
                                          enc.decoded_frames[i][c])
