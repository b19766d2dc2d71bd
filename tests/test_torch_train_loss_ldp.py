"""``gop_rd_loss(training=True)`` on a low-delay P chain, LDP_2, against
``jax.value_and_grad`` of the JAX package's (the limits and the inputs of
tests/test_torch_train_loss.py): tiny-toy at f32, 64x64, batch 2, JAX's
noise injected.  The loss and every log within 1e-5 relative + 1e-7
absolute, measured 4.3e-6 (ms_ssim) and 1.1e-6 (mse); every gradient
leaf within 1e-3 relative L2, measured 3.9e-4 (ms_ssim) and 4.0e-5
(mse)."""

import pytest
import torch

from aivc_tpu_torch.utils.checkpoint import load_checkpoint
from tests.torch_train_ref import (
    TINY_TOY,
    compare_training_loss,
    limit_threads,
    tiny_toy,
)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = limit_threads()
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dist", ["mse", "ms_ssim"])
def test_ldp_training_loss_and_grads_match_jax(dist):
    jcfg, params = tiny_toy()
    _, model = load_checkpoint(TINY_TOY, device="cpu")
    compare_training_loss(jcfg, params, model, "LDP_2", dist)
