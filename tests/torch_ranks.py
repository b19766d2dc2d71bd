"""Rank entry points of the port's multi-process tests, run in worker
processes by aivc_tpu_torch/parallel/launch.py:run_ranks.  Imports only
the port (the pytest process computes JAX's references)."""

from __future__ import annotations

import torch
import torch.distributed as dist

from aivc_tpu_torch.ops.metrics import msssim
from aivc_tpu_torch.parallel import (
    frame_sharding,
    make_mesh,
    replicated,
    shard_params,
    stacked_frame_sharding,
)
from aivc_tpu_torch.parallel.mesh import all_gather_cat, mean_over_data
from aivc_tpu_torch.parallel.multihost import _allgather_bytes


def placements(device, x: torch.Tensor):
    """This rank's slices of ``x`` [B, ...] and of ``x`` stacked twice
    [2, B, ...], the whole batch gathered back, a tensor broadcast from
    the first rank, and one gather of an odd-sized uint8 tensor, a None
    and the float slice."""
    mesh = make_mesh()
    part = frame_sharding(mesh, x)
    own = [torch.full((3,), float(dist.get_rank()))]
    shard_params(own, mesh)
    mixed = all_gather_cat(mesh, [
        torch.arange(5, dtype=torch.uint8) + 10 * dist.get_rank(), None,
        part])
    return {"shape": mesh.shape, "data_index": mesh.data_index,
            "mixed": mixed,
            "part": part.clone(), "back": replicated(mesh, part),
            "stacked": stacked_frame_sharding(mesh, torch.stack([x, -x]))
            .clone(), "params": own[0]}


def allgather_bytes(device, lists):
    """_allgather_bytes of this rank's entry of ``lists``."""
    return _allgather_bytes(lists[dist.get_rank()])


def msssim_split(device, a: torch.Tensor, b: torch.Tensor):
    """MS-SSIM of this rank's slice of the batch (a, b) with the whole
    batch's means (mean_over_data), and the gradient with respect to this
    rank's slice of b of the ranks' shares of it (value / ranks each)."""
    mesh = make_mesh()
    sa = frame_sharding(mesh, a)
    sb = frame_sharding(mesh, b).clone().requires_grad_(True)
    value = msssim(sa, sb, batch_mean=lambda t: mean_over_data(mesh, t))
    (value / mesh.data_size).backward()
    return {"value": value.detach(), "grad": sb.grad}


def train_step_fixed_noise(device, ckpt: str, cases, gop: str, accum: int,
                           lr: float, kw):
    """For each (frames, noise tensors) of ``cases``: one make_train_step
    step of a fresh ``ckpt`` over the 'data' mesh of every rank, fed the
    given noise through FixedNoise; the logs, the parameters, Adam's
    moments and count, and the noise tensors left over."""
    from aivc_tpu_torch.gop import generate_gop_struct
    from aivc_tpu_torch.ops.quantizer import FixedNoise
    from aivc_tpu_torch.train.trainer import make_optimizer, make_train_step
    from aivc_tpu_torch.utils.checkpoint import load_checkpoint

    out = []
    for frames, tensors in cases:
        cfg, model = load_checkpoint(ckpt, device="cpu")
        opt = make_optimizer([p for _, p in model.named_parameters()], lr)
        step = make_train_step(model, cfg, generate_gop_struct(gop), opt,
                               accum=accum, mesh=make_mesh(), **kw)
        noise = FixedNoise(tensors)
        logs = step(frames, 1, noise)
        out.append({"logs": logs, "left": len(noise),
                    "params": {n: p.detach().clone()
                               for n, p in model.named_parameters()},
                    "mu": [m.clone() for m in opt.mu],
                    "nu": [v.clone() for v in opt.nu], "count": opt.count})
    return out
