"""The port's checkpoint loader against the JAX package's.

The pure-Python msgpack reader is held against ``msgpack.unpackb`` and
every leaf it yields against aivc_tpu.utils.checkpoint.load_checkpoint,
on tiny-toy and bf16-r5; ``params_from_jax`` must fill FullNet's
state_dict exactly, in OIHW with the pixel-shuffle channel order.
"""

from pathlib import Path

import msgpack
import numpy as np
import pytest

import jax
import torch

from aivc_tpu.utils.checkpoint import load_checkpoint as jax_load
from aivc_tpu_torch.models.fullnet import FullNet
from aivc_tpu_torch.utils import checkpoint as ck

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Test workers share the host's cores: a small PyTorch pool keeps
    them from oversubscribing it (spinning OpenMP threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _ext_hook(code, data):
    shape, dtype, buf = msgpack.unpackb(data)
    return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}"
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = np.asarray(v)
    return out


@pytest.mark.parametrize("obj", [
    0, 127, 128, 255, 65535, 2 ** 32, 2 ** 63 - 1, -1, -32, -33, -129,
    -2 ** 31, -2 ** 63, 1.5, -0.25, True, False, None, "", "é" * 40,
    "x" * 300, b"", b"\x00\xff" * 200, [1, [2, "a"]], list(range(20)),
    {"k": {"n": [1.0, None]}}, {str(i): i for i in range(40)},
])
def test_reader_matches_msgpack(obj):
    data = msgpack.packb(obj, use_bin_type=True)
    assert ck.read_msgpack(data) == msgpack.unpackb(data, raw=False)


def test_reader_rejects_trailing_bytes():
    with pytest.raises(ValueError):
        ck.read_msgpack(msgpack.packb(1) + b"\x00")


@pytest.mark.parametrize("name", ["tiny-toy", "bf16-r5"])
def test_leaves_match_jax_loader(name):
    path = ROOT / "models_ckpt" / name
    ours = _flat(ck.read_params(path))
    raw = msgpack.unpackb((path / "params.msgpack").read_bytes(),
                          ext_hook=_ext_hook, raw=False)
    ref_raw = _flat(raw)
    _, params = jax_load(path)
    ref = _flat(jax.tree_util.tree_map(np.asarray, params))
    assert ours.keys() == ref.keys() == ref_raw.keys()
    for k in ref:
        assert ours[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
        np.testing.assert_array_equal(ours[k], ref_raw[k], err_msg=k)


@pytest.mark.parametrize("name", ["tiny-toy", "bf16-r5"])
def test_state_dict_fills_fullnet(name):
    path = ROOT / "models_ckpt" / name
    cfg, model = ck.load_checkpoint(path, device="cpu")
    sd = ck.params_from_jax(ck.read_params(path))
    assert set(sd) == set(FullNet(cfg).state_dict())
    tree = ck.read_params(path)["params"]
    # HWIO -> OIHW, and the shuffle permutation on an UpBlock conv
    k = tree["codecnet"]["g_s"]["UpBlock_0"]["Conv_0"]["kernel"]
    w = model.codecnet.g_s.UpBlock_0.Conv_0.weight.detach().numpy()
    c = k.shape[3] // 4
    for ci in range(c):
        for i in range(2):
            for j in range(2):
                np.testing.assert_array_equal(
                    w[ci * 4 + i * 2 + j],
                    k[..., i * 2 * c + j * c + ci].transpose(2, 0, 1))
    k = tree["mofnet"]["g_a"]["ConvBlock_0"]["Conv_0"]["kernel"]
    np.testing.assert_array_equal(
        model.mofnet.g_a.ConvBlock_0.Conv_0.weight.detach().numpy(),
        k.transpose(3, 2, 0, 1))


def test_shuffle_perm_is_a_permutation():
    for c in (1, 3, 6, 96):
        p = ck.shuffle_perm(c)
        assert sorted(p.tolist()) == list(range(4 * c))


def test_entry_point_needs_card_or_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ck.load_checkpoint(ROOT / "models_ckpt" / "tiny-toy")


def test_trained_ladder_names_match():
    from aivc_tpu.models import zoo as jzoo
    from aivc_tpu_torch.models import zoo

    assert zoo.TRAINED_LADDER == jzoo.TRAINED_LADDER
    path, idx = zoo.checkpoint_for("tpu-msssim-2021cc-3")
    assert path == ROOT / "models_ckpt" / "bf16-r5" and idx == 4.0
    assert zoo.checkpoint_for("no-such-model") is None
    # Names 5 and 6 load through the gain surgery: the model's gain rows
    # equal those of JAX's load_trained exactly, under the same config
    # name and rate index.
    for name in ("tpu-msssim-2021cc-5", "tpu-msssim-2021cc-6"):
        cfg, model, idx = zoo.load_trained(name, device="cpu")
        jcfg, jparams, jidx = jzoo.load_trained(name)
        assert cfg.name == jcfg.name == "tpu-aivc-bf16-s3"
        assert idx == jidx
        ref = ck.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                        jparams))
        gains = {k: v for k, v in model.state_dict().items()
                 if k.endswith(("enc_gain", "dec_gain"))}
        assert len(gains) >= 10
        for k, v in gains.items():
            assert torch.equal(v, ref[k]), k
