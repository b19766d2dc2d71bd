"""Checkpoints the port writes, against flax's format, on the host:

* the msgpack writer: reading then writing ``params.msgpack`` of
  tiny-toy and bf16-r5 gives the files' bytes, directly and through
  ``params_from_jax`` / ``params_to_jax``;
* the JAX package's ``load_checkpoint`` reads a checkpoint the port
  wrote after a training step: the same config and, leaf for leaf, the
  port's parameters to the bit;
* ``opt_state.msgpack`` both ways: JAX's ``flax.serialization.from_bytes
  (opt.init(params), ...)`` reads the port's file, and the port reads
  JAX's, with Adam's count, mu and nu and the schedule's count equal to
  the bit; re-written by the port, JAX's state gives flax's bytes.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import serialization

from aivc_tpu.train.trainer import make_optimizer as j_make_optimizer
from aivc_tpu.utils.checkpoint import load_checkpoint as j_load_checkpoint
from aivc_tpu_torch.gop import generate_gop_struct
from aivc_tpu_torch.ops.quantizer import GeneratorNoise
from aivc_tpu_torch.train.trainer import make_optimizer, make_train_step
from aivc_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    params_from_jax,
    params_to_jax,
    read_msgpack,
    read_opt_state,
    save_checkpoint,
    write_msgpack,
    write_opt_state,
)
from tests.torch_train_ref import (
    ROOT,
    TINY_TOY,
    frames_nhwc,
    limit_threads,
    to_nchw,
)

SCHEDULE = dict(lr=1e-4, lr_final=1e-6, decay_steps=30, warmup_steps=5)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = limit_threads()
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["tiny-toy", "bf16-r5"])
def test_writer_reproduces_the_checkpoint_bytes(name):
    raw = (ROOT / "models_ckpt" / name / "params.msgpack").read_bytes()
    tree = read_msgpack(raw)
    assert write_msgpack(tree) == raw
    assert write_msgpack(params_to_jax(params_from_jax(tree))) == raw


def test_writer_encodes_msgpack_forms():
    """Every int and length form comes back through the reader; what
    flax never writes (floats, None, bools) is refused."""
    obj = {"z": [1, -1, -33, 200, -200, 70000, -70000, 2 ** 40],
           "a": {"s" * 40: b"\x00" * 300, "t": "x" * 70000,
                 "u": list(range(20))},
           "m": {str(i): i for i in range(20)},
           "arrays": [np.arange(3, dtype=np.int32),
                      np.zeros((0,), np.float32),
                      np.ones((2, 3), np.float32)]}
    back = read_msgpack(write_msgpack(obj))
    assert list(back) == sorted(obj)
    assert back["z"] == obj["z"] and back["a"] == obj["a"]
    assert back["m"] == obj["m"]
    for a, b in zip(back["arrays"], obj["arrays"]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for bad in (None, True, 1.5):
        with pytest.raises(TypeError):
            write_msgpack({"a": bad})


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """tiny-toy after one training step in the port, saved with its
    optimizer state (a warmup-cosine schedule)."""
    cfg, model = load_checkpoint(TINY_TOY, device="cpu")
    names = [n for n, _ in model.named_parameters()]
    opt = make_optimizer([p for _, p in model.named_parameters()],
                         **SCHEDULE)
    opt.schedule_count = 7
    step = make_train_step(model, cfg, generate_gop_struct("1_GOP_1"), opt,
                           dist_loss="mse")
    logs = step(to_nchw(frames_nhwc(8, 2, 1, 64)), 0, GeneratorNoise(3))
    assert logs["step_skipped"] == 0.0
    out = tmp_path_factory.mktemp("ckpt") / "run"
    save_checkpoint(out, cfg, model)
    write_opt_state(out / "opt_state.msgpack", opt, names)
    return out, cfg, model, opt, names


@pytest.fixture(scope="module")
def jax_loaded(trained):
    """The port's checkpoint through the JAX package's loader."""
    return j_load_checkpoint(trained[0])


def test_jax_loads_a_checkpoint_the_port_trained(trained, jax_loaded):
    _, cfg, model, _, _ = trained
    jcfg, jparams = jax_loaded
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    back = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    sd = model.state_dict()
    assert sorted(back) == sorted(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k


def _jax_opt_state(jcfg_params):
    jopt = j_make_optimizer(**SCHEDULE)
    return jopt, jopt.init(jcfg_params)


def test_jax_reads_the_ports_opt_state(trained, jax_loaded):
    out, _, _, opt, names = trained
    _, jparams = jax_loaded
    jopt, template = _jax_opt_state(jparams)
    raw = (out / "opt_state.msgpack").read_bytes()
    state = serialization.from_bytes(template, raw)
    adam, sched = state[1]
    assert int(adam.count) == opt.count == 1
    assert int(sched.count) == opt.schedule_count == 8
    for tree, mine in ((adam.mu, opt.mu), (adam.nu, opt.nu)):
        got = params_from_jax(jax.tree_util.tree_map(np.asarray, tree))
        for n, t in zip(names, mine):
            assert torch.equal(got[n], t), n
    # flax writes the same bytes for the state it read
    assert serialization.to_bytes(state) == raw


def test_port_reads_jax_opt_state(trained, jax_loaded, tmp_path):
    _, _, model, _, names = trained
    _, jparams = jax_loaded
    jopt, state = _jax_opt_state(jparams)
    rng = np.random.default_rng(9)
    grads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.normal(0, 0.1, p.shape), jnp.float32),
        jparams)
    update = jax.jit(jopt.update)
    for _ in range(3):
        _, state = update(grads, state, jparams)
    raw = serialization.to_bytes(state)
    path = tmp_path / "opt_state.msgpack"
    path.write_bytes(raw)
    opt = make_optimizer([p for _, p in model.named_parameters()],
                         **SCHEDULE)
    read_opt_state(path, opt, names)
    adam, sched = state[1]
    assert opt.count == int(adam.count) == 3
    assert opt.schedule_count == int(sched.count) == 3
    for tree, mine in ((adam.mu, opt.mu), (adam.nu, opt.nu)):
        ref = params_from_jax(jax.tree_util.tree_map(np.asarray, tree))
        for n, t in zip(names, mine):
            assert torch.equal(ref[n], t), n
    again = tmp_path / "again.msgpack"
    write_opt_state(again, opt, names)
    assert again.read_bytes() == raw


def test_read_opt_state_refuses_another_layout(trained, tmp_path):
    out, _, model, _, names = trained
    params = [p for _, p in model.named_parameters()]
    with pytest.raises(ValueError, match="schedule"):
        read_opt_state(out / "opt_state.msgpack",
                       make_optimizer(params, 1e-4), names)
    with pytest.raises(ValueError, match="names"):
        read_opt_state(out / "opt_state.msgpack",
                       make_optimizer(params[1:], **SCHEDULE), names[1:])
    bad = tmp_path / "bad.msgpack"
    bad.write_bytes(write_msgpack({"0": {}}))
    with pytest.raises(ValueError, match="adam"):
        read_opt_state(bad, make_optimizer(params, **SCHEDULE), names)
    assert Path(out / "params.msgpack").exists()
