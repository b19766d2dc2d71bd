"""``gop_rd_loss(training=True)`` and its gradients against
``jax.value_and_grad`` of the JAX package's, on the host, with JAX's own
noise fed to the port (tests/torch_train_ref.py:jax_noise and
compare_training_loss).

tiny-toy at f32, 64x64 frames, batch 2, GOP 1_GOP_2 (LDP_2:
test_torch_train_loss_ldp.py), mse and ms_ssim, I-frame weight 1.3, flow
and alpha penalties on:
  loss and every log   within 1e-5 relative + 1e-7 absolute; measured
                       5.8e-6 under ms_ssim (the filter sums run in
                       another order), 5.4e-6 under mse
  every parameter      within 1e-3 relative L2 of JAX's gradient;
  leaf's gradient      measured 4.3e-4 (a CodecNet analysis bias) under
                       ms_ssim, 1.0e-4 under mse
"""

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
def test_training_loss_and_grads_match_jax(dist):
    jcfg, params = tiny_toy()
    _, model = load_checkpoint(TINY_TOY, device="cpu")
    compare_training_loss(jcfg, params, model, "1_GOP_2", dist)
