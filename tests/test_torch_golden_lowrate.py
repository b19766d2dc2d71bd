"""The low-rate pin of the golden suite on the host: ra_240p_lowrate,
models_ckpt/bf16-lr at idx_rate 6 (the ladder's deep end), RA GOP 8 on
17 frames of the photowarp clip, against docs/golden_suite.json.  The
decode must equal the encoder's reconstruction bit for bit.

Limits (golden.HOST_LIMITS): bytes 0.5%, PSNR 0.10 dB, MS-SSIM 0.004.
Measured (port - pin): +0.0399% (5,011 B against 5,009), +0.00323 dB,
+0.00029.
"""

import torch
import pytest

from test_torch_golden import check_pin


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Test workers share the host's cores: a small PyTorch pool keeps
    them from oversubscribing it (spinning OpenMP threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_lowrate_pin_within_host_limits():
    check_pin("ra_240p_lowrate")
