"""Shared pieces of the training tests (tests/test_torch_train*.py): the
JAX side of a comparison, made on the host.

``jax_noise`` draws the training quantizer's noise as the JAX package
does inside ``gop_rd_loss(training=True)``: one key per frame in coding
order (aivc_tpu/train/loss.py:69), ``rng_m, rng_c`` for P- and B-frames
(models/fullnet.py:159-161), ``rng_z, rng_y`` in each ConditionalNet
(models/conditional.py:225-227), then ``jax.random.uniform`` in
[-0.5, 0.5) of the latent's shape.  The port takes the same tensors, in
the same order, through ``ops.quantizer.FixedNoise``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

import jax
import jax.numpy as jnp

from aivc_tpu.config import FRAME_I, ModelConfig
from aivc_tpu.gop import generate_gop_struct as j_gop
from aivc_tpu.models.fullnet import FullNet as JFullNet
from aivc_tpu.train.loss import gop_rd_loss as j_loss
from aivc_tpu_torch.gop import generate_gop_struct
from aivc_tpu_torch.ops.quantizer import FixedNoise
from aivc_tpu_torch.train.loss import gop_rd_loss
from aivc_tpu_torch.utils.checkpoint import params_from_jax, read_params

ROOT = Path(__file__).resolve().parents[1]
TINY_TOY = ROOT / "models_ckpt" / "tiny-toy"
# gop_rd_loss(training=True) against JAX's (tests/test_torch_train_loss*.py)
LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-7
GRAD_REL_L2 = 1e-3


def limit_threads():
    """Test workers share the host's cores: a small PyTorch pool keeps
    them from oversubscribing it (spinning OpenMP threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    return n


def tiny_toy():
    """-> (JAX ModelConfig, JAX variables {"params": ...}) of tiny-toy."""
    cfg = ModelConfig.from_json((TINY_TOY / "config.json").read_text())
    return cfg, {"params": read_params(TINY_TOY)["params"]}


def _net_noise(key, c, B, H, W):
    kz, ky = jax.random.split(key)
    z = jax.random.uniform(kz, (B, H // 64, W // 64, c.nb_ft_z),
                           jnp.float32, -0.5, 0.5)
    y = jax.random.uniform(ky, (B, H // 16, W // 16, c.nb_ft_y),
                           jnp.float32, -0.5, 0.5)
    return [z, y]


def jax_noise(rng, gop, cfg, B: int, H: int, W: int):
    """The noise JAX draws in gop_rd_loss(training=True, rng=rng) at frames
    of B x H x W (multiples of 64), as NCHW torch tensors in the order
    the port's quantizer asks for them."""
    out = []
    for spec in gop.coding_order:
        rng, rng_f = jax.random.split(rng)
        if spec.frame_type == FRAME_I:
            out += _net_noise(rng_f, cfg.codecnet, B, H, W)
        else:
            rng_m, rng_c = jax.random.split(rng_f)
            out += _net_noise(rng_m, cfg.mofnet, B, H, W)
            out += _net_noise(rng_c, cfg.codecnet, B, H, W)
    return [torch.from_numpy(np.asarray(a).transpose(0, 3, 1, 2).copy())
            for a in out]


def train_noise(rng, gop, cfg, B: int, H: int, W: int, accum: int = 1):
    """The noise of JAX's make_train_step: the step key split into
    ``accum`` microbatch keys (one key, unsplit, for accum 1), each a
    gop_rd_loss, microbatches of B // accum."""
    if accum == 1:
        return jax_noise(rng, gop, cfg, B, H, W)
    out = []
    for r in jax.random.split(rng, accum):
        out += jax_noise(r, gop, cfg, B // accum, H, W)
    return out


def frames_nhwc(seed: int, n: int, B: int, size: int) -> np.ndarray:
    """[n, B, size, size, 3] float32 frames on the 256-level grid."""
    rng = np.random.default_rng(seed)
    return (np.round(rng.random((n, B, size, size, 3)) * 255)
            / 255).astype(np.float32)


def to_nchw(a: np.ndarray) -> torch.Tensor:
    """[..., H, W, C] numpy -> [..., C, H, W] torch."""
    nd = a.ndim
    perm = tuple(range(nd - 3)) + (nd - 1, nd - 3, nd - 2)
    return torch.from_numpy(np.ascontiguousarray(a.transpose(perm)))


def jax_grads_by_name(grads) -> dict:
    """JAX gradient tree -> {state_dict name: numpy array} in the port's
    layout (params_from_jax of the tree)."""
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), grads)
    return {k: v.numpy() for k, v in params_from_jax(tree).items()}


def rel_l2(out: np.ndarray, ref: np.ndarray) -> float:
    """||out - ref|| / ||ref|| (0 where both are zero)."""
    num = float(np.linalg.norm((out - ref).ravel()))
    den = float(np.linalg.norm(ref.ravel()))
    if den == 0.0:
        return 0.0 if num == 0.0 else float("inf")
    return num / den


def compare_training_loss(jcfg, jparams, model, gop_name, dist, seed=1,
                          batch=2, size=64):
    """Run both losses with the same frames and noise; assert the loss,
    every log and every gradient leaf within the limits.  Returns the
    largest relative errors (loss and logs, gradient leaves)."""
    gop = j_gop(gop_name)
    n = len(gop)
    fr = frames_nhwc(seed, n, batch, size)
    rng = jax.random.PRNGKey(seed + 6)
    kw = dict(dist_loss=dist, weight_i_frame_loss=1.3, flow_penalty=0.01,
              alpha_penalty=0.02)
    jnet = JFullNet(jcfg)

    def f(p):
        return j_loss(jnet, p, [jnp.asarray(fr[i]) for i in range(n)], gop,
                      1, rng, 0.01, 0.02, training=True, **kw)

    (jl, jlogs), jg = jax.jit(jax.value_and_grad(f, has_aux=True))(jparams)
    jg = jax_grads_by_name(jg)
    noise = FixedNoise(jax_noise(rng, gop, jcfg, batch, size, size))
    for p in model.parameters():
        p.grad = None
    tl, tlogs = gop_rd_loss(model, [to_nchw(fr[i]) for i in range(n)],
                            generate_gop_struct(gop_name), 1.0, 0.01, 0.02,
                            training=True, noise=noise, **kw)
    tl.backward()
    tl = tl.detach()
    assert len(noise) == 0
    assert sorted(tlogs) == sorted(jlogs)
    pairs = [("loss", float(tl), float(jl))] + [
        (k, float(tlogs[k].detach()), float(jlogs[k])) for k in sorted(jlogs)]
    worst_log = worst_grad = 0.0
    for k, out, ref in pairs:
        assert abs(out - ref) <= LOSS_RTOL * abs(ref) + LOSS_ATOL, \
            (k, out, ref)
        worst_log = max(worst_log, abs(out - ref) / max(abs(ref), 1e-12))
    names = [nm for nm, _ in model.named_parameters()]
    assert sorted(names) == sorted(jg)
    for nm, p in model.named_parameters():
        g = (p.grad.numpy() if p.grad is not None
             else np.zeros(tuple(p.shape), np.float32))
        err = rel_l2(g, jg[nm])
        assert err <= GRAD_REL_L2, (nm, err)
        worst_grad = max(worst_grad, err)
    return worst_log, worst_grad
