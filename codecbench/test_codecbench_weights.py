"""Seeded weights (``"weights": {"seed": n}``): the tree the architecture
draws, the checkpoint files the harness writes of it, and what the
program and the reference read back."""

import json

import numpy as np
import pytest
import torch

from harness import weights
from harness.manifest import Manifest
from reference.msgpack import read_params
import tinycell

REPO = tinycell.REPO


@pytest.fixture(scope="module")
def man(tmp_path_factory):
    torch.set_num_threads(2)
    return Manifest(tinycell.make(tmp_path_factory.mktemp("tiny")))


def leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


def params_bytes(man, seed):
    config = dict(man.config("tiny-seeded"), weights={"seed": seed})
    with weights.prepared(man.root, config, man.architecture(config),
                          "cpu") as d:
        return (d / "params.msgpack").read_bytes()


def test_program_and_reference_read_one_tree(man):
    from aivc_tpu_torch.utils.checkpoint import (model_from_params,
                                                 params_from_jax, read_tree)
    config = man.config("tiny-seeded")
    with weights.prepared(man.root, config, man.architecture(config),
                          "cpu") as d:
        cfg, tree = read_tree(d)
        ref = leaves(read_params(d))
        model = model_from_params(cfg, tree, "cpu")
    assert json.loads(cfg.to_json())["codecnet"]["nb_ft"] == \
        config["model"]["codecnet"]["nb_ft"]
    prog = leaves(tree["params"])
    assert sorted(prog) == sorted(ref)
    for k in prog:
        assert prog[k].dtype == ref[k].dtype == np.float32
        assert prog[k].tobytes() == ref[k].tobytes(), k
    # The program holds what it read: every leaf, none left at its init.
    sd = model.state_dict()
    for k, v in params_from_jax(tree).items():
        assert torch.equal(sd[k], v), k


def test_the_seeded_layout_is_the_checkpoints(man):
    """The tree has the leaves and shapes of the tiny-toy checkpoint, of
    the same ModelConfig; its draws are not that checkpoint's."""
    config = man.config("tiny-seeded")
    tree = leaves(man.architecture(config).init_tree(
        config, torch.Generator().manual_seed(tinycell.WEIGHT_SEED)))
    ckpt = leaves(read_params(REPO / "models_ckpt/tiny-toy"))
    assert {k: v.shape for k, v in tree.items()} == \
        {k: v.shape for k, v in ckpt.items()}
    kernel = "codecnet.g_a.ConvBlock_1.Conv_0.kernel"
    assert not np.array_equal(tree[kernel], ckpt[kernel])
    # lecun-normal: std sqrt(1 / fan_in) before the cut at two stds.
    assert tree[kernel].std() == pytest.approx(
        (5 * 5 * 16) ** -0.5, rel=0.15)
    assert np.abs(tree[kernel]).max() <= 2 * (5 * 5 * 16) ** -0.5 / 0.8796


def test_the_same_seed_gives_the_same_bytes(man):
    a = params_bytes(man, tinycell.WEIGHT_SEED)
    assert a == params_bytes(man, tinycell.WEIGHT_SEED)
    assert a != params_bytes(man, tinycell.WEIGHT_SEED + 1)


def test_the_temporary_directory_goes_with_the_run(man):
    config = man.config("tiny-seeded")
    with weights.prepared(man.root, config, man.architecture(config),
                          "cpu") as d:
        assert sorted(p.name for p in d.iterdir()) == ["config.json",
                                                       "params.msgpack"]
    assert not d.exists()
