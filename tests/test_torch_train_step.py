"""``make_train_step`` against the JAX package's, on the host: tiny-toy at
f32, GOP 1_GOP_1 (an I- and a P-frame), 64x64, batch 2, mse, the flow
and alpha penalties on, Adam at 1e-4, with JAX's noise injected
(tests/torch_train_ref.py:train_noise).

  every log            within 1e-5 relative + 1e-7 absolute, the grad
                       norm within 1e-3 (the gradient's limit); measured
                       1.4e-6 and 4.7e-5
  Adam's mu and nu     within 1e-3 relative L2 per leaf (functions of
                       the gradient); measured 5.6e-4
  the parameters       Adam's first step moves each parameter by
                       lr * g / (|g| + eps), about lr * sign(g), so a
                       gradient near 0 may take the other sign: at most
                       1e-3 of the elements may move differently by more
                       than 1% of lr; measured 7.3e-5
  counts               equal

with accum 1 and 2, and with accum 2 and a NaN microbatch, which both
packages drop (micro_skipped 1).  The port alone: that step equals the
accum-1 step on the valid microbatch to the bit; a step whose
microbatches are all bad, or whose only batch is, is skipped with the
parameters, mu, nu and both counts unchanged to the bit, and an update
after it is the update the skipped step never came before.  The step
runs with TF32 off for a float32 model (the codec's rule) and gives the
previous settings back; a bf16 model's step leaves them as they are.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from aivc_tpu.gop import generate_gop_struct as j_gop
from aivc_tpu.models.fullnet import FullNet as JFullNet
from aivc_tpu.train.trainer import make_optimizer as j_make_optimizer
from aivc_tpu.train.trainer import make_train_step as j_make_train_step
from aivc_tpu_torch.gop import generate_gop_struct
from aivc_tpu_torch.ops.quantizer import FixedNoise
from aivc_tpu_torch.train.trainer import make_optimizer, make_train_step
from aivc_tpu_torch.utils.checkpoint import load_checkpoint, params_from_jax
from tests.torch_train_ref import (
    TINY_TOY,
    frames_nhwc,
    limit_threads,
    rel_l2,
    tiny_toy,
    to_nchw,
    train_noise,
)

GOP, B, SIZE, LR = "1_GOP_1", 2, 64, 1e-4
KW = dict(dist_loss="mse", flow_penalty=0.01, alpha_penalty=0.02)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = limit_threads()
    yield
    torch.set_num_threads(n)


def port_step(accum):
    cfg, model = load_checkpoint(TINY_TOY, device="cpu")
    opt = make_optimizer([p for _, p in model.named_parameters()], LR)
    step = make_train_step(model, cfg, generate_gop_struct(GOP), opt,
                           accum=accum, **KW)
    return model, opt, step


def snapshot(model, opt):
    return ({n: p.detach().clone() for n, p in model.named_parameters()},
            [m.clone() for m in opt.mu], [v.clone() for v in opt.nu],
            opt.count, opt.schedule_count)


def assert_same_state(a, b):
    assert a[3:] == b[3:]
    for k in a[0]:
        assert torch.equal(a[0][k], b[0][k]), k
    for x, y in zip(a[1] + a[2], b[1] + b[2]):
        assert torch.equal(x, y)


def compare_with_jax(jout, jlogs, model, opt, before, logs,
                     moved_apart_max=1e-3):
    assert sorted(logs) == sorted(jlogs)
    worst = {"log": 0.0, "grad_norm": 0.0, "moments": 0.0}
    for k in jlogs:
        ref = float(jlogs[k])
        rtol = 1e-3 if k == "grad_norm" else 1e-5
        assert abs(logs[k] - ref) <= rtol * abs(ref) + 1e-7, (k, logs[k], ref)
        w = "grad_norm" if k == "grad_norm" else "log"
        worst[w] = max(worst[w], abs(logs[k] - ref) / max(abs(ref), 1e-12))
    jparams, jstate = jout
    adam = jstate[1][0]
    assert opt.count == int(adam.count)
    jp = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    jmu = params_from_jax(jax.tree_util.tree_map(np.asarray, adam.mu))
    jnu = params_from_jax(jax.tree_util.tree_map(np.asarray, adam.nu))
    moved_apart = n_all = 0
    for i, (nm, p) in enumerate(model.named_parameters()):
        for mine, ref in ((opt.mu[i], jmu[nm]), (opt.nu[i], jnu[nm])):
            err = rel_l2(mine.numpy(), ref.numpy())
            assert err <= 1e-3, (nm, err)
            worst["moments"] = max(worst["moments"], err)
        dt = (p.detach() - before[nm]).numpy()
        dj = (jp[nm] - before[nm]).numpy()
        moved_apart += int(np.sum(np.abs(dt - dj) > 0.01 * LR))
        n_all += dt.size
    assert moved_apart <= moved_apart_max * n_all, (moved_apart, n_all)
    worst["moved_apart"] = moved_apart / n_all
    return worst


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(accum):
    jcfg, params = tiny_toy()
    gop = j_gop(GOP)
    fr = frames_nhwc(3, len(gop), B, SIZE)
    rng = jax.random.PRNGKey(11)
    jopt = j_make_optimizer(LR)
    jstep = j_make_train_step(JFullNet(jcfg), jcfg, gop, jopt, accum=accum,
                              **KW)
    cases = [fr]
    if accum == 2:
        bad = fr.copy()
        bad[:, B // 2:] = np.nan            # the second microbatch
        cases.append(bad)
    for frames in cases:
        jp, jst, jlogs = jstep(params, jopt.init(params), jnp.asarray(frames),
                               1, rng)
        model, opt, step = port_step(accum)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        noise = FixedNoise(train_noise(rng, gop, jcfg, B, SIZE, SIZE, accum))
        logs = step(to_nchw(frames), 1, noise)
        assert len(noise) == 0
        assert logs["step_skipped"] == float(jlogs["step_skipped"]) == 0.0
        assert logs["micro_skipped"] == float(jlogs["micro_skipped"]) == (
            0.0 if frames is fr else 1.0)
        compare_with_jax((jp, jst), jlogs, model, opt, before, logs)


def _noise(seed, shapes_of):
    g = torch.Generator().manual_seed(seed)
    return [torch.rand(s, generator=g) - 0.5 for s in shapes_of]


def _noise_shapes(batch):
    """Latent shapes of one 1_GOP_1 loss at 64x64: CodecNet z, y of the
    I-frame, then MOFNet z, y and CodecNet z, y of the P-frame."""
    _, model = load_checkpoint(TINY_TOY, device="cpu")
    cod, mof = model.cfg.codecnet, model.cfg.mofnet
    z = lambda c: (batch, c.nb_ft_z, SIZE // 64, SIZE // 64)   # noqa: E731
    y = lambda c: (batch, c.nb_ft_y, SIZE // 16, SIZE // 16)   # noqa: E731
    return [z(cod), y(cod), z(mof), y(mof), z(cod), y(cod)]


def test_nan_microbatch_dropped_equals_step_on_the_valid_one():
    fr = to_nchw(frames_nhwc(4, 2, B, SIZE))
    shapes = _noise_shapes(B // 2)
    n0, n1 = _noise(1, shapes), _noise(2, shapes)
    bad = fr.clone()
    bad[:, B // 2:] = float("nan")
    model2, opt2, step2 = port_step(2)
    logs2 = step2(bad, 0, FixedNoise(n0 + n1))
    model1, opt1, step1 = port_step(1)
    logs1 = step1(fr[:, :B // 2], 0, FixedNoise(n0))
    assert logs2["micro_skipped"] == 1.0 and logs2["step_skipped"] == 0.0
    for k in logs1:
        if k != "micro_skipped":
            assert logs2[k] == logs1[k], k
    assert_same_state(snapshot(model2, opt2), snapshot(model1, opt1))


@pytest.mark.parametrize("accum", [1, 2])
def test_all_bad_step_is_skipped(accum):
    fr = to_nchw(frames_nhwc(5, 2, B, SIZE))
    model, opt, step = port_step(accum)
    shapes = _noise_shapes(B // accum)
    step(fr, 2, FixedNoise(sum((_noise(s, shapes) for s in range(accum)),
                               [])))
    before = snapshot(model, opt)
    assert before[3] == 1
    bad = torch.full_like(fr, float("nan"))
    logs = step(bad, 2, FixedNoise(sum((_noise(s, shapes)
                                        for s in range(accum)), [])))
    assert logs["step_skipped"] == 1.0
    assert logs["micro_skipped"] == (2.0 if accum == 2 else 0.0)
    assert_same_state(before, snapshot(model, opt))


def test_skipped_step_between_updates_leaves_no_trace():
    """Update, a step the guard skips, update: the same parameters, mu,
    nu and counts, to the bit, as the two updates alone (Adam's bias
    correction reads the count, so a count that moved would show)."""
    shapes = _noise_shapes(B)
    good = [to_nchw(frames_nhwc(s, 2, B, SIZE)) for s in (6, 7)]
    bad = torch.full_like(good[0], float("nan"))
    states = []
    for frames in ([good[0], bad, good[1]], [good[0], good[1]]):
        model, opt, step = port_step(1)
        for i, fr in enumerate(frames):
            seed = 11 if fr is good[1] else 10 + i
            logs = step(fr, 1, FixedNoise(_noise(seed, shapes)))
            assert logs["step_skipped"] == (1.0 if fr is bad else 0.0)
        states.append(snapshot(model, opt))
    assert states[0][3] == 2
    assert_same_state(states[0], states[1])


@pytest.mark.parametrize("dtype,tf32_inside", [("float32", False),
                                               ("bfloat16", True)])
def test_step_applies_the_float32_precision_rule(dtype, tf32_inside):
    import dataclasses as dc

    cfg, model = load_checkpoint(TINY_TOY, device="cpu")
    cfg = dc.replace(cfg, mofnet=dc.replace(cfg.mofnet, dtype=dtype),
                     codecnet=dc.replace(cfg.codecnet, dtype=dtype))
    opt = make_optimizer([p for _, p in model.named_parameters()], LR)
    step = make_train_step(model, cfg, generate_gop_struct(GOP), opt, **KW)
    from aivc_tpu_torch.ops.layers import Conv

    seen = []
    for m in model.modules():
        if isinstance(m, Conv):
            m.register_forward_pre_hook(lambda m, a: seen.append(
                (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)))
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        fr = to_nchw(frames_nhwc(6, 2, B, SIZE))
        step(fr, 1, FixedNoise(_noise(10, _noise_shapes(B))))
        assert seen and all(s == (tf32_inside, tf32_inside) for s in seen)
        assert (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32) == (True, True)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
