"""The port's RD forward ``FullNet.forward_frame`` against the JAX
package's, on the host at 128x128, for I, P and B frames, on tiny-toy
(f32) and bf16-r5 (bf16).  Both sides take the vertically clamped warp
(AIVC_WARP=pallas: ``_USE_PALLAS`` set on both, JAX's warp_pallas in
interpret mode).

Tolerances, with the errors measured:
  x_hat, alpha, v_prev: max |error| <= TOL x the largest magnitude + ATOL
    tiny-toy  TOL 1e-4, ATOL 1e-6   measured 3.7e-6 on x_hat up to 0.94
    bf16-r5   TOL 0.08, ATOL 2e-3   measured 0.055 on x_hat up to 1.03
                                    (B-frame), 3.8e-3 on v_prev up to 0.77
    The bf16 convolutions round differently in the two packages, so a
    few y symbols move by one bin and change x_hat around them; that
    bounds the largest error, not the bulk.  The bulk is held tighter:
    the mean |error| of x_hat is at most MEAN_ATOL (bf16-r5: 0.006,
    measured 0.0039 at most over I/P/B) and at least MIN_AGREE of the y
    symbols are equal (bf16-r5: 0.995, measured 0.9980 at least).
  summed rate_y / rate_z of both nets, relative:
    tiny-toy  1e-5   measured 3.7e-7
    bf16-r5   2e-3   measured 4.0e-4
"""

import importlib
from pathlib import Path

import numpy as np
import pytest

import jax
import torch
from jax.experimental.pallas import tpu as pltpu

from aivc_tpu.config import FRAME_B, FRAME_I, FRAME_P, ModelConfig
from aivc_tpu.models.fullnet import FullNet as JFullNet
from aivc_tpu_torch.ops import warp as tw
from aivc_tpu_torch.utils.checkpoint import load_checkpoint, read_params

ROOT = Path(__file__).resolve().parents[1]
jw = importlib.import_module("aivc_tpu.ops.warp")
TOL = {"tiny-toy": 1e-4, "bf16-r5": 0.08}
ATOL = {"tiny-toy": 1e-6, "bf16-r5": 2e-3}
MEAN_ATOL = {"tiny-toy": 1e-6, "bf16-r5": 0.006}
MIN_AGREE = {"tiny-toy": 1.0, "bf16-r5": 0.995}
RATE_RTOL = {"tiny-toy": 1e-5, "bf16-r5": 2e-3}
SIZE = 128


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Test workers share the host's cores: a small PyTorch pool keeps
    them from oversubscribing it (spinning OpenMP threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _vclamped_warp(monkeypatch):
    monkeypatch.setattr(jw, "_USE_PALLAS", True)
    monkeypatch.setattr(tw, "_USE_PALLAS", True)


@pytest.fixture(scope="module", params=["tiny-toy", "bf16-r5"])
def nets(request):
    name = request.param
    path = ROOT / "models_ckpt" / name
    cfg = ModelConfig.from_json((path / "config.json").read_text())
    params = {"params": read_params(path)["params"]}
    _, tmodel = load_checkpoint(path, device="cpu")
    return name, JFullNet(cfg), params, tmodel


def _frames(seed):
    rng = np.random.default_rng(seed)
    f = (np.round(rng.random((3, 1, SIZE, SIZE, 3)) * 255) / 255).astype(
        np.float32)
    return f[0], f[1], f[2]


def _nchw(a):
    return torch.tensor(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


def _close(name, ref, out):
    err = np.abs(ref - out).max()
    scale = np.abs(ref).max() + 1e-6
    assert err <= TOL[name] * scale + ATOL[name], (err, scale)


@pytest.mark.parametrize("ftype", [FRAME_I, FRAME_P, FRAME_B])
def test_forward_frame_matches_jax(nets, ftype):
    name, jnet, params, tmodel = nets
    frames = _frames(seed=ftype)
    with pltpu.force_tpu_interpret_mode():
        fn = jax.jit(lambda p, *f: jnet.apply(
            p, *f, 1.5, ftype, method=JFullNet.forward_frame))
        jx, jaux = jax.tree_util.tree_map(np.asarray, fn(params, *frames))
    with torch.inference_mode():
        tx, taux = tmodel.forward_frame(*[_nchw(f) for f in frames], 1.5,
                                        ftype)
    assert sorted(taux) == sorted(jaux)
    _close(name, jx, _nhwc(tx))
    assert np.abs(jx - _nhwc(tx)).mean() <= MEAN_ATOL[name]
    _close(name, jaux["alpha"], _nhwc(taux["alpha"]))
    nets_ = ["cod"] if ftype == FRAME_I else ["cod", "mof"]
    if ftype == FRAME_I:
        assert taux["mof"] is None
    else:
        _close(name, jaux["v_prev"], _nhwc(taux["v_prev"]))
    for net in nets_:
        agree = np.mean(_nhwc(taux[net]["y_cq"]) == jaux[net]["y_cq"])
        assert agree >= MIN_AGREE[name], (net, agree)
        for k in ("rate_y", "rate_z"):
            ref = float(jaux[net][k].sum())
            out = float(taux[net][k].sum())
            assert abs(out - ref) <= RATE_RTOL[name] * abs(ref) + 1e-6, \
                (net, k, out, ref)
