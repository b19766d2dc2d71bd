"""The port's ConditionalNet / FullNet stage methods against the JAX
package's, on real checkpoints: tiny-toy at f32 and bf16-r5 at bf16, on
64x64 and 64x128 frames.  Both run the inference schedule (low-precision
GDN, channel-major maps).

Tolerance: max |error| <= TOL x the output's largest magnitude + ATOL,
ATOL being about one bf16 rounding step of the O(1) activations inside:
  tiny-toy (f32)   TOL 1e-4, ATOL 1e-6  measured 1.25e-6 x the magnitude
  bf16-r5 (bf16)   TOL 0.05, ATOL 2e-3  measured 0.039 on outputs up to
                   6.3, and 6.3e-4 on the MOFNet's near-zero mu (max 0.013)
and at least MIN_AGREE of the integer z_q symbols equal:
  f32 0.99 (measured 1.0), bf16 0.95 (measured 0.992).
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from aivc_tpu.config import FRAME_B, FRAME_I, FRAME_P, ModelConfig
from aivc_tpu.models.fullnet import FullNet as JFullNet
from aivc_tpu_torch.pipeline.codec import FrameCodec
from aivc_tpu_torch.utils.checkpoint import load_checkpoint, read_params

ROOT = Path(__file__).resolve().parents[1]
TOL = {"tiny-toy": 1e-4, "bf16-r5": 0.05}
ATOL = {"tiny-toy": 1e-6, "bf16-r5": 2e-3}
MIN_AGREE = {"tiny-toy": 0.99, "bf16-r5": 0.95}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Test workers share the host's cores: a small PyTorch pool keeps
    them from oversubscribing it (spinning OpenMP threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["tiny-toy", "bf16-r5"])
def nets(request):
    name = request.param
    path = ROOT / "models_ckpt" / name
    cfg = ModelConfig.from_json((path / "config.json").read_text())
    cfg = dataclasses.replace(
        cfg, mofnet=dataclasses.replace(cfg.mofnet, gdn_lowp=True,
                                        maps_cm=True),
        codecnet=dataclasses.replace(cfg.codecnet, gdn_lowp=True))
    params = {"params": read_params(path)["params"]}
    jnet = JFullNet(cfg)
    tcfg, tmodel = load_checkpoint(path, device="cpu")
    codec = FrameCodec(tcfg, tmodel, 64, 64, device="cpu")
    return name, jnet, params, codec.model


def _j(jnet, params, method, *args, **kw):
    fn = jax.jit(lambda p, *a: jnet.apply(p, *a, method=method, **kw))
    return jax.tree_util.tree_map(np.asarray, fn(params, *args))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _close(name, ref, out):
    err = np.abs(ref - out).max()
    scale = np.abs(ref).max() + 1e-6
    assert err <= TOL[name] * scale + ATOL[name], (err, scale)


def _frames(h, w, seed):
    rng = np.random.default_rng(seed)
    f = (np.round(rng.random((3, 2, h, w, 3)) * 255) / 255).astype(np.float32)
    return f[0], f[1], f[2]


@pytest.mark.parametrize("ftype", [FRAME_I, FRAME_P, FRAME_B])
@pytest.mark.parametrize("hw", [(64, 64), (64, 128)])
def test_stage_methods(nets, ftype, hw):
    name, jnet, params, tnet = nets
    frame, prev, nxt = _frames(*hw, seed=ftype + hw[1])
    rate = 1.5
    with torch.no_grad():
        if ftype != FRAME_I:
            jy, jz = _j(jnet, params, JFullNet.mof_analyze, frame, prev, nxt,
                        rate, frame_type=ftype)
            ty, tz = tnet.mof_analyze(_nchw(frame), _nchw(prev), _nchw(nxt),
                                      rate, ftype)
            _close(name, jy, _nhwc(ty))
            assert np.mean(_nhwc(tz) == jz) >= MIN_AGREE[name]
            jmu, jsig = _j(jnet, params, JFullNet.mofnet_hyper, jz)
            tmu, tsig = tnet.mofnet_hyper(_nchw(jz))
            _close(name, jmu, _nhwc(tmu))
            _close(name, jsig, _nhwc(tsig))
            yq = np.round(jy - jmu)
            jmaps = _j(jnet, params, JFullNet.mofnet_synth_maps, yq, jmu,
                       prev, nxt, rate, frame_type=ftype)
            tmaps = tnet.mofnet_synth_maps(_nchw(yq), _nchw(jmu),
                                           _nchw(prev), _nchw(nxt), rate,
                                           ftype)
            _close(name, jmaps, tmaps.numpy())
            jmc = jax.tree_util.tree_map(np.asarray,
                                         JFullNet.motion_comp_stage_cm(
                                             jnp.asarray(prev),
                                             jnp.asarray(nxt),
                                             jnp.asarray(jmaps), ftype))
            tmc = tnet.motion_comp_stage(_nchw(prev), _nchw(nxt),
                                         torch.from_numpy(jmaps), ftype)
            for k in ("pred", "skip"):
                _close(name, jmc[k], _nhwc(tmc[k]))
            pred, skip = jmc["pred"], jmc["skip"]
        else:
            pred = np.zeros_like(frame)
            skip = np.zeros_like(frame)
        jy, jz = _j(jnet, params, JFullNet.cod_analyze, frame, pred, rate,
                    frame_type=ftype)
        ty, tz = tnet.cod_analyze(_nchw(frame), _nchw(pred), rate, ftype)
        _close(name, jy, _nhwc(ty))
        assert np.mean(_nhwc(tz) == jz) >= MIN_AGREE[name]
        jmu, jsig = _j(jnet, params, JFullNet.codecnet_hyper, jz)
        tmu, tsig = tnet.codecnet_hyper(_nchw(jz))
        _close(name, jmu, _nhwc(tmu))
        _close(name, jsig, _nhwc(tsig))
        yq = np.round(jy - jmu)
        jx = _j(jnet, params, JFullNet.codecnet_synth, yq, jmu, pred, skip,
                rate, frame_type=ftype)
        tx = tnet.codecnet_synth(_nchw(yq), _nchw(jmu), _nchw(pred),
                                 _nchw(skip), rate, ftype)
        _close(name, jx, _nhwc(tx))
