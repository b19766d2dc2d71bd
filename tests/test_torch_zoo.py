"""The port's model registry and gain surgery against the JAX package's.

  * ``shift_gain_rows`` / ``shift_gain_tree`` = JAX's exactly (tolerance
    0, measured 0) on every gain leaf of bf16-r5's tree;
  * ``MODEL_ZOO`` has JAX's names, configurations and default rates;
  * ``init_fullnet``: the parameter names, shapes and dtypes equal JAX's
    tree after ``params_from_jax`` (tpu-aivc-tiny from a real JAX init,
    tpu-aivc-base from its abstract shapes), the deterministic leaves
    (biases, gain rows, GDN beta and gamma) equal JAX's exactly, and the
    random leaves follow flax's initialisers: each divided by its
    initialiser's std and pooled over the model has mean 0 and std 1,
    on both sides, within 0.05 for the conv kernels (lecun-normal,
    296,116 weights, within its truncation; measured std 1.0004 here,
    0.9978 in JAX) and 0.10 for the factorized prior (normal, 688 draws;
    measured std 0.989 / 1.041, means -0.074 / 0.051).
"""

import math
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from aivc_tpu.models import zoo as jzoo
from aivc_tpu.models.fullnet import FullNet as JFullNet
from aivc_tpu.ops import gain as jgain
from aivc_tpu_torch.models import zoo
from aivc_tpu_torch.ops import gain as tgain
from aivc_tpu_torch.utils.checkpoint import params_from_jax, read_params

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Test workers share the host's cores: a small PyTorch pool keeps
    them from oversubscribing it (spinning OpenMP threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _gain_leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_gain_leaves(v, f"{prefix}{k}."))
        elif k in ("enc_gain", "dec_gain"):
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def r5_tree():
    return read_params(ROOT / "models_ckpt" / "bf16-r5")


@pytest.mark.parametrize("shift,tail_boost", [(3, 1.5), (1, 1.0), (2, 3.0)])
def test_shift_gain_rows_match_jax(r5_tree, shift, tail_boost):
    leaves = _gain_leaves(r5_tree)
    assert len(leaves) >= 10
    for name, mat in leaves.items():
        ours = tgain.shift_gain_rows(mat, shift, tail_boost=tail_boost)
        ref = jgain.shift_gain_rows(mat, shift, tail_boost=tail_boost)
        assert ours.dtype == np.float32
        np.testing.assert_array_equal(ours, np.asarray(ref), err_msg=name)


def test_shift_gain_tree_matches_jax(r5_tree):
    before = {k: v.copy() for k, v in _gain_leaves(r5_tree).items()}
    ours, n = tgain.shift_gain_tree(r5_tree, 3, tail_boost=1.5)
    ref, n_ref = jgain.shift_gain_tree(r5_tree, 3, tail_boost=1.5)
    assert n == n_ref == len(_gain_leaves(r5_tree))
    a, b = _gain_leaves(ours), _gain_leaves(ref)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], np.asarray(b[k]), err_msg=k)
    # the input tree is left as it was
    for k, v in _gain_leaves(r5_tree).items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)
        assert not np.array_equal(v, a[k]), k


def test_model_zoo_matches_jax():
    assert sorted(zoo.MODEL_ZOO) == sorted(jzoo.MODEL_ZOO)
    for name, (cfg, rate) in zoo.MODEL_ZOO.items():
        jcfg, jrate = jzoo.MODEL_ZOO[name]
        assert cfg.to_json() == jcfg.to_json() and rate == jrate, name
    assert zoo.get_model("tpu-aivc-tiny") == zoo.MODEL_ZOO["tpu-aivc-tiny"]
    with pytest.raises(KeyError, match="tpu-aivc-base"):
        zoo.get_model("no-such-model")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _deterministic(key: str) -> bool:
    return key.split(".")[-1] in ("bias", "beta", "gamma", "enc_gain",
                                  "dec_gain")


def test_init_fullnet_matches_jax_tree_tiny():
    cfg = zoo.TINY
    _, params = jzoo.init_fullnet(jzoo.TINY, jax.random.PRNGKey(0))
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    model = zoo.init_fullnet(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    ours = model.state_dict()
    assert sorted(ours) == sorted(ref)
    for k, v in ours.items():
        assert v.shape == ref[k].shape and v.dtype == ref[k].dtype, k
        if _deterministic(k):
            assert torch.equal(v, ref[k]), k
    # The random leaves follow the same distributions: each leaf divided
    # by its initialiser's std, pooled over the model, has mean 0 and
    # std 1 on both sides; kernels stay within the truncation.
    def pooled(sd, kind):
        zs = []
        for k, v in sd.items():
            if kind == "kernel" and k.endswith(".weight"):
                cout, cin, kh, kw = v.shape
                zs.append(v.flatten() * math.sqrt(cin * kh * kw))
            elif kind == "prior" and ".pdf_z." in k:
                leaf = k.split(".")[-1]
                d_in, d_out = ((v.shape[1], v.shape[2]) if leaf[0] == "h"
                               else (1, v.shape[1]))
                zs.append(v.flatten() / math.sqrt(2.0 / (d_in * d_out)))
        return torch.cat(zs)

    for kind, tol in (("kernel", 0.05), ("prior", 0.10)):
        for sd in (ours, ref):
            z = pooled(sd, kind)
            assert abs(float(z.std()) - 1.0) < tol, (kind, float(z.std()))
            assert abs(float(z.mean())) < tol, (kind, float(z.mean()))
    bound = 2.0 / .87962566103423978
    assert float(pooled(ours, "kernel").abs().max()) <= bound * (1 + 1e-6)
    # the same generator state gives the same model
    again = zoo.init_fullnet(cfg, torch.Generator().manual_seed(0),
                             device="cpu").state_dict()
    assert all(torch.equal(again[k], v) for k, v in ours.items())


@pytest.mark.parametrize("name", ["tpu-aivc-base", "tpu-aivc-bf16"])
def test_init_fullnet_matches_jax_shapes(name):
    jcfg, _ = jzoo.MODEL_ZOO[name]
    model = JFullNet(jcfg)
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    shapes = jax.eval_shape(
        lambda r: model.init(r, x, x, x, method=JFullNet.init_all),
        jax.random.PRNGKey(0))
    ref = params_from_jax(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes))
    cfg, _ = zoo.MODEL_ZOO[name]
    ours = zoo.init_fullnet(cfg, torch.Generator().manual_seed(1),
                            device="cpu").state_dict()
    assert sorted(ours) == sorted(ref)
    for k, v in ours.items():
        assert v.shape == ref[k].shape and v.dtype == ref[k].dtype, k
    flat = _flat(jax.tree_util.tree_map(lambda s: s.dtype, shapes))
    assert {str(d) for d in flat.values()} == {"float32"}
