"""The port's optimizer against optax, and ``gop_curriculum`` against the
JAX package's, on the host.

* ``make_optimizer``'s learning rate against the optax schedule that
  aivc_tpu/train/trainer.py:make_optimizer builds, over counts 0-50, for
  four settings: constant; cosine; cosine with a warmup; a cosine whose
  count is fast-forwarded as ``--step0`` does.  Within 4 float32 ulps
  (4.8e-7 relative: numpy's cosine here and XLA's there differ by up to
  an ulp, which the schedule's affine tail carries on), measured 2.6e-7.
  A warmup at least as long as the decay raises, as optax does.
* Four clipped Adam updates on a small tree (gradient norms above and
  below the clip, a warmup-cosine rate) against ``optax.chain(
  clip_by_global_norm, adam(schedule))``: the parameters within 1e-7
  relative + 1e-12 absolute, measured 6.4e-8; mu and nu within 1e-6
  relative L2 per leaf, measured 3.2e-7 (the port sums the clip's global
  norm in another order, an ulp or so apart; elementwise, the moments'
  cancellations magnify that); Adam's count and the schedule's count
  equal.
"""

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from aivc_tpu.train.trainer import gop_curriculum as j_curriculum
from aivc_tpu.train.trainer import make_optimizer as j_make_optimizer
from aivc_tpu_torch.train.trainer import gop_curriculum, make_optimizer
from tests.torch_train_ref import limit_threads, rel_l2

LR_RTOL = 4.8e-7


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = limit_threads()
    yield
    torch.set_num_threads(n)


def _optax_schedule(lr, lr_final, decay_steps, warmup_steps):
    """The learning rate of aivc_tpu/train/trainer.py:make_optimizer."""
    if lr_final is not None and decay_steps:
        return optax.warmup_cosine_decay_schedule(
            init_value=0.0 if warmup_steps else lr, peak_value=lr,
            warmup_steps=max(warmup_steps, 1) if warmup_steps else 0,
            decay_steps=decay_steps, end_value=lr_final)
    return lambda count: jnp.float32(lr)


@pytest.mark.parametrize("setting", [
    dict(lr=3e-4, lr_final=None, decay_steps=None, warmup_steps=0, step0=0),
    dict(lr=1e-4, lr_final=1e-6, decay_steps=40, warmup_steps=0, step0=0),
    dict(lr=4e-6, lr_final=1e-6, decay_steps=45, warmup_steps=20, step0=0),
    dict(lr=4e-6, lr_final=1e-6, decay_steps=45, warmup_steps=20,
         step0=17),
], ids=["constant", "cosine", "warmup-cosine", "step0"])
def test_learning_rate_matches_optax(setting):
    s = dict(setting)
    step0 = s.pop("step0")
    opt = make_optimizer([torch.zeros(3)], **s)
    sched = _optax_schedule(**s)
    if step0:
        opt.schedule_count = step0
    for k in range(51):
        count = k + step0
        ref = float(sched(jnp.asarray(count, jnp.int32)))
        out = opt.learning_rate()
        assert abs(out - ref) <= LR_RTOL * abs(ref), (count, out, ref)
        if opt.schedule_count is not None:
            opt.schedule_count += 1
    if s["warmup_steps"]:
        assert make_optimizer([torch.zeros(3)], **s).learning_rate() == 0.0


def test_warmup_longer_than_decay_raises():
    with pytest.raises(ValueError):
        j_make_optimizer(4e-6, lr_final=1e-6, decay_steps=6,
                         warmup_steps=200)
    with pytest.raises(ValueError, match="decay_steps"):
        make_optimizer([torch.zeros(3)], 4e-6, lr_final=1e-6,
                       decay_steps=6, warmup_steps=200)


def test_clipped_adam_updates_match_optax():
    rng = np.random.default_rng(3)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 3)}
    params = {k: rng.normal(0, 1, s).astype(np.float32)
              for k, s in shapes.items()}
    kw = dict(lr=1e-2, lr_final=1e-3, decay_steps=10, warmup_steps=2)
    jopt = j_make_optimizer(**kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jp)
    names = sorted(shapes)
    tp = [torch.tensor(params[k]) for k in names]
    opt = make_optimizer(tp, **kw)
    for scale in (3.0, 0.2, 5.0, 0.05):     # global norms above and below 1
        grads = {k: (rng.normal(0, 1, s) * scale / np.sqrt(20)).astype(
            np.float32) for k, s in shapes.items()}
        upd, jstate = jopt.update({k: jnp.asarray(v)
                                   for k, v in grads.items()}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        opt.update([torch.tensor(grads[k]) for k in names])
        adam, sched = jstate[1]
        assert opt.count == int(adam.count)
        assert opt.schedule_count == int(sched.count)
        for i, k in enumerate(names):
            ref = np.asarray(jp[k])
            assert np.allclose(tp[i].numpy(), ref, rtol=1e-7, atol=1e-12)
            assert rel_l2(opt.mu[i].numpy(), np.asarray(adam.mu[k])) <= 1e-6
            assert rel_l2(opt.nu[i].numpy(), np.asarray(adam.nu[k])) <= 1e-6


@pytest.mark.parametrize("epoch", [0, 3, 4, 9, 10, 11, 50])
def test_gop_curriculum_matches_jax(epoch):
    change, names = [4, 10, 20], ["1_GOP_2", "1_GOP_4", "LDP_4"]
    assert gop_curriculum(epoch, change, names) == j_curriculum(
        epoch, change, names)
    with pytest.raises(ValueError):
        gop_curriculum(epoch, change, names[:2])
