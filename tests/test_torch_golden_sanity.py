"""The sanity pin on the host: docs/golden_sanity.json (bf16-r5, 33
frames of the photowarp clip at 240x416, RA GOP 16, intra period 32),
through ``golden.run_pin``, whose decode must equal the encoder's
reconstruction bit for bit.

Limits (golden.HOST_LIMITS): bytes 0.5%, PSNR 0.10 dB, MS-SSIM 0.004.
Measured (port - pin): +0.0025% (78,503 B against 78,501), -0.00077 dB,
+0.00002.
"""

import json

import pytest

import torch

from aivc_tpu_torch.eval import golden


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Test workers share the host's cores: a small PyTorch pool keeps
    them from oversubscribing it (spinning OpenMP threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_sanity_pin_within_host_limits():
    data = json.loads(golden.SANITY_PATH.read_text())
    pin = golden.suite_pins()[golden.SANITY]
    got = golden.run_pin(pin, "cpu")
    cmp = golden.compare(got, data["expect"], golden.HOST_LIMITS)
    line = golden.report_line(golden.SANITY, got, data["expect"], cmp)
    assert got["bit_exact"] and cmp["ok"], line
