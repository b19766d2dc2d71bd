"""Device-mesh helpers over torch.distributed (counterpart of
aivc_tpu/parallel/mesh.py): a ('data', 'spatial') grid of ranks, one
process per rank.

  'data'    splits the batch dimension: the frames of one wave, the
            microbatches (or a microbatch's batch) of a train step;
  'spatial' splits the rows of frames and latents into equal bands, one
            a rank.  JAX's GSPMD inserts the conv halo exchanges by
            itself; here every conv of a split stage takes its halo rows
            from its neighbours through ``parallel/halo.py``, and the
            consumers (FrameCodec, make_train_step) gather the bands
            where a stage needs the whole frame.  ``check_rows`` refuses
            a frame whose rows cannot split so.

JAX's placements become plain functions: ``frame_sharding`` gives this
rank's batch slice and row band, ``replicated`` gathers both back,
``shard_params`` broadcasts tensors from the first rank of the mesh, so
every rank holds the same weights.

The collectives run on the backend the caller started the process group
with (``init_distributed`` takes it as an argument).  gloo's all_gather
takes host tensors only, so under gloo a CUDA tensor goes through a host
copy and back; every collective, copies included, is a ``mesh.gather``
span (tracing.py).  Nothing switches backends by itself.
"""

from __future__ import annotations

import datetime
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from aivc_tpu_torch import tracing

AXES = ("data", "spatial")
# The longest a rank waits in one collective before its process group
# raises.
COLLECTIVE_TIMEOUT_S = 60
# Rows of a frame per row of the y latent (config.py:Y_DOWNSCALE).
Y_DOWNSCALE = 16


class Mesh:
    """A ('data', 'spatial') grid of ranks.  ``device_mesh`` is the
    torch DeviceMesh over them where a process group is up (None where it
    is not: then the mesh is a shape only, as in the tests of shapes)."""

    axis_names = AXES

    def __init__(self, grid: np.ndarray, device_mesh=None):
        self.grid = grid
        self.device_mesh = device_mesh

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(AXES, self.grid.shape))

    def size(self, axis: str) -> int:
        return int(self.grid.shape[AXES.index(axis)])

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        return (None if self.device_mesh is None
                else self.device_mesh.get_group(axis))

    def index(self, axis: str) -> int:
        """This rank's place on ``axis``."""
        if self.device_mesh is None:
            if self.size(axis) > 1:
                raise ValueError(f"{self} has no process group: start one "
                                 f"(init_distributed) before make_mesh")
            return 0
        return int(self.device_mesh.get_local_rank(axis))

    @property
    def data_size(self) -> int:
        return self.size("data")

    @property
    def data_group(self):
        return self.group("data")

    @property
    def data_index(self) -> int:
        return self.index("data")

    @property
    def spatial_size(self) -> int:
        return self.size("spatial")

    @property
    def spatial_group(self):
        return self.group("spatial")

    @property
    def spatial_index(self) -> int:
        return self.index("spatial")

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def make_mesh(n_devices: Optional[int] = None, spatial: int = 1,
              devices: Optional[Sequence[int]] = None) -> Mesh:
    """Build a ('data', 'spatial') mesh over the ranks ``devices``
    (default: every rank of the process group, or ``range(n_devices)``
    where none is up).  Where a process group is up the mesh must cover
    all of it, and a DeviceMesh is built over it: of the backend's device
    type (cpu under gloo, whose collectives take host tensors)."""
    up = dist.is_available() and dist.is_initialized()
    if devices is None:
        devices = range(dist.get_world_size() if up else (n_devices or 1))
    devices = list(devices)
    if n_devices is None:
        n_devices = len(devices)
    if n_devices % spatial != 0:
        raise ValueError(f"{n_devices} devices not divisible by "
                         f"spatial={spatial}")
    grid = np.asarray(devices[:n_devices]).reshape(n_devices // spatial,
                                                   spatial)
    if not up:
        return Mesh(grid)
    if sorted(grid.reshape(-1).tolist()) != list(range(dist.get_world_size())):
        raise ValueError(f"a mesh over ranks {grid.reshape(-1).tolist()} "
                         f"does not cover the process group of "
                         f"{dist.get_world_size()}")
    from torch.distributed.device_mesh import DeviceMesh

    dtype = "cpu" if dist.get_backend() == "gloo" else "cuda"
    return Mesh(grid, DeviceMesh(dtype, torch.as_tensor(grid),
                                 mesh_dim_names=AXES))


def check_mesh(mesh: Mesh, what: str) -> None:
    """Raise where ``what`` cannot run over the mesh: one that splits an
    axis with no process group to gather over."""
    if mesh.device_mesh is None and (mesh.data_size > 1
                                     or mesh.spatial_size > 1):
        raise ValueError(f"{what}: {mesh} has no process group: start one "
                         f"(init_distributed) before make_mesh")


def check_rows(mesh: Optional[Mesh], hp: int, halo: int, what: str) -> None:
    """Raise ValueError, naming the sizes, where frames of ``hp`` padded
    rows cannot split over 'spatial' into bands the nets run on: every
    band must start on a multiple of 16 rows (the y grid: each stride-2
    conv then keeps its output rows aligned), and hold at least ``halo``
    rows at the y level (the largest halo of a conv there: a band takes
    its halo from its neighbours only).  JAX's GSPMD pads such splits
    instead; the port refuses them."""
    s = 1 if mesh is None else mesh.spatial_size
    if s == 1:
        return
    if hp % (Y_DOWNSCALE * s):
        raise ValueError(f"{what}: {hp} padded rows do not split over "
                         f"spatial={s}: each band must be a multiple of "
                         f"{Y_DOWNSCALE} rows ({hp} % {Y_DOWNSCALE * s} = "
                         f"{hp % (Y_DOWNSCALE * s)})")
    band = hp // Y_DOWNSCALE // s
    if band < halo:
        raise ValueError(f"{what}: {hp} padded rows over spatial={s} leave "
                         f"{band} rows a rank at the y level, fewer than "
                         f"the {halo}-row halo of its convs")


def init_distributed(backend: str, rank: int, world_size: int,
                     init_file: str, device=None) -> torch.device:
    """Start the process group on ``backend`` ("gloo" or "nccl") with a
    file store at ``init_file`` (a fresh path, the same for every rank)
    and COLLECTIVE_TIMEOUT_S on every collective, and return this rank's
    device: ``device`` where the caller names one, else
    ``cuda:{rank % device_count}`` (one host: the rank is the local
    rank); with no card and no ``device`` this raises, as resolve_device
    does."""
    if device is None and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "ranks on the host")
    dist.init_process_group(
        backend, init_method=f"file://{init_file}", rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    if device is not None:
        return torch.device(device)
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def comm_device(group=None) -> torch.device:
    """Where the group's collectives take their tensors: the host under
    gloo, this rank's card under nccl."""
    if dist.get_backend(group) == "gloo":
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def batch_slice(mesh: Optional[Mesh], n: int) -> slice:
    """This rank's share of a batch of ``n``: a slice of n / data items
    where 'data' divides n, else all of it (every rank computes the whole
    batch, JAX's fallback for a batch the axis does not divide)."""
    if mesh is None or mesh.data_size == 1 or n % mesh.data_size:
        return slice(None)
    b = n // mesh.data_size
    return slice(mesh.data_index * b, (mesh.data_index + 1) * b)


def row_band(mesh: Mesh, x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's band of ``x`` along its row dimension ``dim`` over
    'spatial' (a view; all of ``x`` with spatial 1)."""
    s = mesh.spatial_size
    if x.shape[dim] % s:
        raise ValueError(f"{x.shape[dim]} rows not divisible by spatial={s}")
    h = x.shape[dim] // s
    return x.narrow(dim, mesh.spatial_index * h, h)


def frame_sharding(mesh: Mesh, x: torch.Tensor, dim: int = 0
                   ) -> torch.Tensor:
    """This rank's slice of the NCHW batch ``x`` (batch at ``dim``, rows
    at ``dim + 2``): the batch over 'data', the rows over 'spatial' (the
    placement P('data', 'spatial', None, None) of JAX's NHWC)."""
    check_mesh(mesh, "frame_sharding")
    if x.shape[dim] % mesh.data_size:
        raise ValueError(f"batch {x.shape[dim]} not divisible by data="
                         f"{mesh.data_size}")
    x = x[(slice(None),) * dim + (batch_slice(mesh, x.shape[dim]),)]
    return row_band(mesh, x, dim + 2)


def stacked_frame_sharding(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """[n_frames, B, C, H, W] GOP tensor: the batch (dim 1) over 'data',
    the rows (dim 3) over 'spatial'; the frame axis is the sequential DAG
    and stays whole."""
    return frame_sharding(mesh, x, dim=1)


def all_gather_cat(mesh: Mesh, tensors: List[Optional[torch.Tensor]],
                   dim: int = 0, axis: str = "data"
                   ) -> List[Optional[torch.Tensor]]:
    """Each tensor's slices of every rank on ``axis`` ('data', or
    'spatial' for row bands), concatenated along ``dim`` in the order of
    the axis; None stays None.  Every rank must pass the same shapes and
    dtypes.  One collective for all: the tensors travel as one byte
    buffer."""
    present = [t.contiguous() for t in tensors if t is not None]
    if not present:
        return list(tensors)
    # Each tensor's bytes padded to a multiple of 8, so that every slice
    # of the buffer can be viewed as its dtype again.
    sizes = [t.numel() * t.element_size() for t in present]
    flat = torch.cat([F.pad(t.reshape(-1).view(torch.uint8), (0, -n % 8))
                      for t, n in zip(present, sizes)])
    group = mesh.group(axis)
    cdev = comm_device(group)
    with tracing.span("mesh.gather"):
        sent = flat.to(cdev)
        parts = [torch.empty_like(sent) for _ in range(mesh.size(axis))]
        dist.all_gather(parts, sent, group=group)
        parts = [p.to(flat.device) for p in parts]
    out, it, off = [], iter(zip(present, sizes)), 0
    for t in tensors:
        if t is None:
            out.append(None)
            continue
        src, n = next(it)
        pieces = [p[off:off + n].view(src.dtype).reshape(src.shape)
                  for p in parts]
        out.append(torch.cat(pieces, dim=dim))
        off += n + (-n % 8)
    return out


def replicated(mesh: Mesh, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The whole batch on every rank from each rank's slice (the inverse
    of frame_sharding: the rows gathered over 'spatial', then the batch
    over 'data'; the placement P() of the gathered tensor)."""
    check_mesh(mesh, "replicated")
    if mesh.spatial_size > 1:
        x = all_gather_cat(mesh, [x], dim + 2, axis="spatial")[0]
    if mesh.data_size > 1:
        x = all_gather_cat(mesh, [x], dim)[0]
    return x


def all_reduce(mesh: Mesh, x: torch.Tensor, op: str = "sum",
               axis: str = "data") -> torch.Tensor:
    """A new tensor: ``x`` reduced over ``axis`` ("sum" or "max"), the
    same on every rank of the line."""
    group = mesh.group(axis)
    cdev = comm_device(group)
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    with tracing.span("mesh.gather"):
        y = x.detach().to(cdev, copy=True)
        dist.all_reduce(y, op=red, group=group)
        return y.to(x.device)


class _SumOverData(torch.autograd.Function):
    """all_reduce(SUM) whose gradient is the all_reduce(SUM) of the
    incoming gradients: each rank's loss then sends the part of the
    gradient that flows through the sum to every rank's slice."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_reduce(mesh, x, "sum")

    @staticmethod
    def backward(ctx, g):
        return all_reduce(ctx.mesh, g.contiguous(), "sum"), None


def mean_over_data(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The mean over 'data' of each rank's ``x`` (means over equal
    slices of a batch -> the batch's means), differentiable."""
    return _SumOverData.apply(x, mesh) / mesh.data_size


@torch.no_grad()
def shard_params(params, mesh: Mesh):
    """Replicate: every tensor of ``params`` (a module or an iterable of
    tensors) broadcast in place from the mesh's first rank (grid[0, 0])
    to every rank.  Returns ``params``."""
    tensors: Iterable[torch.Tensor] = (
        params.parameters() if isinstance(params, torch.nn.Module)
        else params)
    if mesh.device_mesh is None or mesh.grid.size == 1:
        return params
    cdev = comm_device()
    src = int(mesh.grid[0, 0])
    with tracing.span("mesh.gather"):
        for t in tensors:
            buf = t.detach().to(cdev, copy=True)
            dist.broadcast(buf, src=src)
            t.copy_(buf)
    return params
