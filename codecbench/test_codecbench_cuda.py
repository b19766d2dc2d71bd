"""The tiny cells on the card (marked ``cuda``; skips without one):
the device path, the trace and the kernels' readers.

    python -m pytest codecbench/test_codecbench_cuda.py
"""

import pytest
import torch

import tinycell

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.parametrize("cell", [tinycell.CELL, tinycell.SEEDED])
def test_tiny_cell_on_the_card(card, tmp_path, capsys, cell):
    root = tinycell.make(tmp_path)
    rc, res, _ = tinycell.run_tiny(root, capsys, device="cuda", cell=cell)
    assert rc == 0 and res["correct"] is True, res and res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["memory_peak_bytes"] > 0
    rc, res, _ = tinycell.run_tiny(root, capsys, device="cuda", trace=1,
                                   cell=cell)
    assert rc == 0 and res["correct"] is True
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert res["breakdown"]["device_ops"]
    for name in ("device_idle.encode", "device_idle.decode", "mfu.encode"):
        assert 0 < res["metrics"][name]["value"] < 100
