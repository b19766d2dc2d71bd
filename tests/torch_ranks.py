"""Rank entry points of the port's multi-process tests, run in worker
processes by aivc_tpu_torch/parallel/launch.py:run_ranks.  Imports only
the port (the pytest process computes JAX's references)."""

from __future__ import annotations

import torch
import torch.distributed as dist

from aivc_tpu_torch import tracing
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
                           lr: float, kw, spatial: int = 1):
    """For each (frames, noise tensors) of ``cases``: one make_train_step
    step of a fresh ``ckpt`` over the ('data', 'spatial') mesh of every
    rank with ``spatial`` bands, fed the given noise through FixedNoise;
    the logs, the parameters, Adam's moments and count, and the noise
    tensors left over."""
    from aivc_tpu_torch.gop import generate_gop_struct
    from aivc_tpu_torch.ops.quantizer import FixedNoise
    from aivc_tpu_torch.train.trainer import make_optimizer, make_train_step
    from aivc_tpu_torch.utils.checkpoint import load_checkpoint

    out = []
    for frames, tensors in cases:
        cfg, model = load_checkpoint(ckpt, device="cpu")
        opt = make_optimizer([p for _, p in model.named_parameters()], lr)
        step = make_train_step(model, cfg, generate_gop_struct(gop), opt,
                               accum=accum, mesh=make_mesh(spatial=spatial),
                               **kw)
        noise = FixedNoise(tensors)
        logs = step(frames, 1, noise)
        out.append({"logs": logs, "left": len(noise),
                    "params": {n: p.detach().clone()
                               for n, p in model.named_parameters()},
                    "mu": [m.clone() for m in opt.mu],
                    "nu": [v.clone() for v in opt.nu], "count": opt.count})
    return out


def halo_exchange(device, x: torch.Tensor, pads, spatial: int):
    """For each pad of ``pads``: this rank's band of ``x`` (rows over
    'spatial') padded by exchange_rows and the column padding
    (RowBand.pad), and the gradient with respect to the band of the loss
    sum(padded * weight), the weight this band's rows of a fixed whole
    weight; then the band gathered back (gather_rows) and the gradient
    of sum(gathered * weight) / spatial with respect to the band."""
    from aivc_tpu_torch.parallel.halo import RowBand

    band = RowBand(make_mesh(spatial=spatial))
    g = torch.Generator().manual_seed(7)
    out = {"index": band.index}
    for pad in pads:
        xb = band.rows(x).requires_grad_(True)
        padded = band.pad(xb, pad)
        weight = torch.randint(-4, 5, (x.shape[0], x.shape[1],
                                       band.size * padded.shape[2],
                                       padded.shape[3]), generator=g
                               ).float()
        (grad,) = torch.autograd.grad(
            (padded * band.rows(weight)).sum(), xb)
        out[pad] = {"padded": padded.detach(), "grad": grad,
                    "weight": weight}
    xb = band.rows(x).requires_grad_(True)
    whole = band.gather(xb)
    weight = torch.randint(-4, 5, tuple(x.shape), generator=g).float()
    (grad,) = torch.autograd.grad((whole * weight).sum() / band.size, xb)
    out["gather"] = {"whole": whole.detach(), "grad": grad,
                     "weight": weight}
    return out


def split_nets(device, ckpt: str, x: torch.Tensor, y: torch.Tensor,
               spatial: int):
    """CodecNet's and MOFNet's g_a on this rank's band of ``x`` and g_s
    on its band of ``y`` (the nets split over 'spatial', halos
    exchanged), each gathered back over 'spatial', and the same stages
    on the whole tensors in this process."""
    from aivc_tpu_torch.parallel.halo import RowBand
    from aivc_tpu_torch.utils.checkpoint import load_checkpoint

    _, model = load_checkpoint(ckpt, device="cpu")
    band = RowBand(make_mesh(spatial=spatial))
    out = {}
    with torch.no_grad(), tracing.recording() as rec:
        for name in ("mofnet", "codecnet"):
            net = getattr(model, name)
            xs = x[:, :net.cfg.in_c]
            ys = y[:, :net.g_s.UpBlock_0.Conv_0.weight.shape[1]]
            net.split_rows(None)
            whole = (net.g_a(xs), net.g_s(ys))
            net.split_rows(band)
            split = (band.gather(net.g_a(band.rows(xs))),
                     band.gather(net.g_s(band.rows(ys))))
            out[name] = {"whole": whole, "split": split}
    out["halo_s"] = rec.seconds("halo.exchange")
    return out


def mesh_errors(device, ckpt: str, spatial: int):
    """The errors of a FrameCodec and of a train step over a mesh of
    ``spatial`` bands where the rows cannot split (64x64: 64 padded
    rows), and whether a FrameCodec builds where they can (192 rows)."""
    from aivc_tpu_torch.gop import generate_gop_struct
    from aivc_tpu_torch.pipeline.codec import FrameCodec
    from aivc_tpu_torch.train.trainer import make_optimizer, make_train_step
    from aivc_tpu_torch.utils.checkpoint import load_checkpoint

    cfg, model = load_checkpoint(ckpt, device="cpu")
    mesh = make_mesh(spatial=spatial)
    out = {}
    try:
        FrameCodec(cfg, model, 64, 64, device="cpu", mesh=mesh)
    except ValueError as e:
        out["codec"] = str(e)
    out["builds_192"] = FrameCodec(cfg, model, 192, 64, device="cpu",
                                   mesh=mesh).band.size == spatial
    step = make_train_step(model, cfg, generate_gop_struct("1_GOP_1"),
                           make_optimizer(list(model.parameters())),
                           mesh=mesh)
    try:
        step(torch.zeros((1, 1, 3, 64, 64)), 0, None)
    except ValueError as e:
        out["train"] = str(e)
    return out


def spatial_placements(device, x: torch.Tensor, spatial: int):
    """frame_sharding, stacked_frame_sharding and replicated over the
    ('data', 'spatial') mesh of every rank."""
    mesh = make_mesh(spatial=spatial)
    part = frame_sharding(mesh, x)
    return {"shape": mesh.shape, "data_index": mesh.data_index,
            "spatial_index": mesh.spatial_index, "part": part.clone(),
            "stacked": stacked_frame_sharding(
                mesh, torch.stack([x, -x])).clone(),
            "back": replicated(mesh, part)}
