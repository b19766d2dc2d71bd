"""The port settles the host's vector math when it is imported
(device.settle_host_math).

PyTorch hands torch.sqrt and other elementwise functions on the CPU to
MKL's vector math library.  In a fresh process whose first call of such a
function runs on two threads at once, one thread can get a coarse
approximation (up to 3.2e-4 relative, measured with
``python -m aivc_tpu_torch.check_host_math``; the plain GDN's square
root of tests/test_torch_gdn_tc.py failed so).  Importing the package
makes each first call on one thread, in float32 and float64, before any
other code of the port runs.  Checked in a fresh process.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Test workers share the host's cores: a small PyTorch pool keeps
    them from oversubscribing it (spinning OpenMP threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


CHILD = """
import torch
seen = []
def watch(fn):
    def call(x, *a, **k):
        seen.append((fn.__name__, x.dtype, x.numel()))
        return fn(x, *a, **k)
    call.__name__ = fn.__name__
    return call
names = ("sqrt", "exp", "log", "log2", "log10", "sin", "cos", "tan", "tanh",
         "erf", "erfc", "erfinv", "acos", "asin", "atan", "trunc")
for n in names:
    setattr(torch, n, watch(getattr(torch, n)))
import aivc_tpu_torch  # noqa: F401
from aivc_tpu_torch import device
assert [f.__name__ for f in device.VML_FUNCTIONS] == list(names)
for n in names:
    calls = [s for s in seen if s[0] == n]
    assert {c[1] for c in calls} == {torch.float32, torch.float64}, (n, calls)
    assert all(c[2] <= 16 for c in calls), (n, calls)
print("ok", len(seen))
"""


def test_import_settles_each_vml_function_on_one_thread():
    """Each function is first called on a 16-element tensor, far below
    PyTorch's parallel grain (32,768 elements), so on the calling thread
    only, in both float types, when the package is imported."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=ROOT,
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["ok", "32"]
