"""Training step and optimizer (counterpart of aivc_tpu/train/trainer.py).

``make_optimizer`` is optax's ``chain(clip_by_global_norm(clip),
adam(schedule))`` written out: the same arithmetic in float32, the same
state (Adam's count, mu and nu, and the schedule's own count), so that
``utils/checkpoint.py`` can read and write it in the layout flax gives
optax's state and a leg resumes across the two packages with Adam's
memory intact.

``make_train_step`` is the multi-rate RD step: an integer rate index per
step picks lambda from the ladder; ``accum`` microbatches run in
sequence, each with its own guard, and one update uses the float32 mean
of the valid microbatches' gradients; a step the guard refuses leaves
the parameters and the whole optimizer state as they were.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from aivc_tpu_torch.device import float32_precision
from aivc_tpu_torch.parallel.halo import RowBand
from aivc_tpu_torch.parallel.mesh import (
    all_reduce,
    batch_slice,
    check_mesh,
    check_rows,
    mean_over_data,
    shard_params,
)
from aivc_tpu_torch.train.loss import gop_rd_loss, psnr_of_mse

F32 = np.float32


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0
                                 ) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule (exponent 1), in float32: a
    linear ramp from ``init_value`` to ``peak_value`` over ``warmup_steps``
    counts, then a cosine to ``end_value`` that ends at ``decay_steps``
    counts, warmup included.  Returns count -> learning rate."""
    T = decay_steps - warmup_steps
    if not T > 0:
        raise ValueError(f"the cosine decay needs positive decay_steps, got "
                         f"decay_steps - warmup_steps = {T}")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def linear(count: int):
        if warmup_steps <= 0:
            return F32(init_value)
        c = F32(min(max(count, 0), warmup_steps))
        frac = F32(1) - c / F32(warmup_steps)
        return F32(init_value - peak_value) * frac + F32(peak_value)

    def cosine(count: int):
        c = F32(min(count, T))
        cos = F32(0.5) * (F32(1) + np.cos(F32(math.pi) * c / F32(T)))
        return F32(peak_value) * (F32(1 - alpha) * cos + F32(alpha))

    def schedule(count: int) -> float:
        return float(linear(count) if count < warmup_steps
                     else cosine(count - warmup_steps))

    return schedule


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm), a
    0-d float32 tensor: the norm of the tensors' norms, summed in another
    order than optax's."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


class Optimizer:
    """Adam (b1 0.9, b2 0.999, eps 1e-8, eps_root 0) behind optax's
    clip_by_global_norm, over ``params`` (a list of float32 tensors),
    with a learning rate that is a constant or a schedule of its own
    count.

    State: ``count`` (Adam's bias-correction count), ``mu``, ``nu`` (one
    tensor per parameter) and ``schedule_count`` (None for a constant
    rate).  ``update`` applies one step in place."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, params: List[torch.Tensor], lr, clip: float = 1.0):
        self.params = list(params)
        self.lr = lr
        self.clip = float(clip)
        self.count = 0
        self.schedule_count: Optional[int] = 0 if callable(lr) else None
        self.mu = [torch.zeros_like(p, dtype=torch.float32)
                   for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32)
                   for p in self.params]

    def learning_rate(self) -> float:
        """The rate the next update will take (optax reads the schedule's
        count before incrementing it)."""
        if self.schedule_count is None:
            return float(F32(self.lr))
        return self.lr(self.schedule_count)

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor]) -> None:
        """optax's arithmetic, op for op, on all tensors at once: clip
        (t / norm) * clip, then mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2
        + b2 nu, u = (mu / bc1) / (sqrt(nu / bc2) + eps) (eps_root 0), and
        p + u * -lr, each product and sum rounded in float32."""
        grads = [g.float() for g in grads]
        g_norm = float(global_norm(grads))
        if not g_norm < self.clip:
            grads = torch._foreach_mul(torch._foreach_div(grads, g_norm),
                                       self.clip)
        b1, b2 = self.B1, self.B2
        count = self.count + 1
        bc1 = float(F32(1) - F32(b1) ** F32(count))
        bc2 = float(F32(1) - F32(b2) ** F32(count))
        m_new = torch._foreach_mul(grads, 1 - b1)
        torch._foreach_add_(m_new, torch._foreach_mul(self.mu, b1))
        v_new = torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2)
        torch._foreach_add_(v_new, torch._foreach_mul(self.nu, b2))
        torch._foreach_copy_(self.mu, m_new)
        torch._foreach_copy_(self.nu, v_new)
        den = torch._foreach_div(v_new, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.EPS)
        u = torch._foreach_div(torch._foreach_div(m_new, bc1), den)
        torch._foreach_mul_(u, -self.learning_rate())
        torch._foreach_add_(self.params, u)
        self.count = count
        if self.schedule_count is not None:
            self.schedule_count += 1


def make_optimizer(params, lr: float = 1e-4, clip: float = 1.0,
                   lr_final: Optional[float] = None,
                   decay_steps: Optional[int] = None,
                   warmup_steps: int = 0) -> Optimizer:
    """Adam with global-norm clipping (trainer.py:24-50).  With
    ``lr_final`` and ``decay_steps`` the rate warms up linearly from 0 for
    ``warmup_steps`` counts (so the first warmup step has rate 0) and then
    follows a cosine from ``lr`` to ``lr_final`` ending at
    ``decay_steps`` counts; otherwise it is ``lr`` throughout."""
    if lr_final is not None and decay_steps:
        lr = warmup_cosine_decay_schedule(
            init_value=0.0 if warmup_steps else lr, peak_value=lr,
            warmup_steps=max(warmup_steps, 1) if warmup_steps else 0,
            decay_steps=decay_steps, end_value=lr_final)
    return Optimizer(params, lr, clip)


def micro_ok(loss: torch.Tensor, logs: Dict[str, torch.Tensor],
             gn: torch.Tensor) -> torch.Tensor:
    """The poison guard (trainer.py:124-129, 187-220): finite loss and
    grad norm, loss >= -1e-3 (lambda R + D cannot be negative: a finite
    negative loss is an exploded forward), psnr > -20 dB (reconstruction
    magnitudes off scale) and grad norm < 1e5 (clipping keeps the
    direction of a garbage gradient).  A 0-d bool tensor."""
    return (torch.isfinite(gn) & torch.isfinite(loss) & (loss >= -1e-3)
            & (logs["psnr"] > -20.0) & (gn < 1e5))


class _DrawShapes:
    """A noise source that hands out zeros and keeps the shapes asked."""

    def __init__(self):
        self.shapes: List[tuple] = []

    def uniform(self, like: torch.Tensor) -> torch.Tensor:
        self.shapes.append(tuple(like.shape))
        return torch.zeros(like.shape, dtype=torch.float32,
                           device=like.device)


class _RowsOf:
    """The rows ``sl`` of what ``noise`` draws for the whole batch, of
    which the asking latent is the slice ``sl`` of ``d`` equal ones."""

    def __init__(self, noise, sl: slice, d: int):
        self.noise, self.sl, self.d = noise, sl, d

    def uniform(self, like: torch.Tensor) -> torch.Tensor:
        full = torch.empty((like.shape[0] * self.d,) + tuple(like.shape[1:]),
                           device=like.device)
        return self.noise.uniform(full)[self.sl]


def make_train_step(model, cfg, gop, optimizer: Optimizer,
                    dist_loss: Optional[str] = None,
                    flow_penalty: float = 0.0, alpha_penalty: float = 0.0,
                    accum: int = 1, mesh=None):
    """-> ``train_step(frames, idx_rate, noise) -> logs`` over one GOP
    structure (trainer.py:53-220).

    ``frames`` is [n, B, 3, H, W] in display order on the model's device,
    ``idx_rate`` an integer index into ``cfg.lambda_tradeoff``, ``noise``
    a noise source (ops/quantizer.py).  With ``accum > 1`` the batch is
    split into ``accum`` microbatches taken in sequence; a microbatch the
    guard refuses is dropped (by selection: a NaN cannot leak into the
    sums), and one update uses the mean over the valid ones, with the
    logs weighted the same way and ``flow_max`` their maximum.  The step
    is skipped (parameters and optimizer state, counts included, stay as
    they were) when the guard refuses the mean or every microbatch.  The
    step runs with TF32 off where a net computes in float32, as the codec
    does (device.py:float32_precision).
    After the step each parameter's ``.grad`` holds the gradient of the
    update.  Returns the logs of gop_rd_loss plus ``micro_skipped``,
    ``loss``, ``grad_norm`` and ``step_skipped`` as Python floats.

    With ``mesh`` (parallel/mesh.py) every rank of the mesh calls the
    step with the same frames and a noise source in the same state, and
    the step is the one-process step over the ranks (the parameters and
    Adam's state are broadcast from the first rank here).  Over
    'spatial' each rank runs the nets on its band of the frames' rows
    (models/fullnet.py, the placement P(None, 'data', 'spatial', None,
    None)): its loss and logs are its shares of the (micro)batch's
    (train/loss.py), and the shares, the logs and the parameter
    gradients are summed over 'spatial' (``flow_max`` its maximum,
    ``psnr`` from the summed mse) before anything below sees them.  Over
    'data':
    - where 'data' divides ``accum``, each rank takes a block of whole
      microbatches, guards each one, and the guarded sums, the valid
      count and each microbatch's loss and logs are all-reduced;
    - otherwise each microbatch's batch is split over the ranks: MS-SSIM
      takes its means over the whole microbatch (mean_over_data), the
      slices' loss, logs and gradients are averaged (``psnr`` from the
      averaged mse, ``flow_max`` their maximum), and the microbatch's
      guard decides on those.
    Each rank draws every microbatch's noise in order and uses its own
    (of a split microbatch, its rows), so a microbatch's noise is what
    one process draws for it.  Every guard decides on reduced values and
    every rank applies the same update, so the parameters stay identical
    across ranks; the gradients are sums in another order than one
    process's."""
    dist = dist_loss or cfg.dist_loss
    lambdas = np.asarray(cfg.lambda_tradeoff, np.float32)
    params = list(optimizer.params)
    d = 1
    band = None
    if mesh is not None:
        check_mesh(mesh, "make_train_step")
        d = mesh.data_size
        shard_params(params + optimizer.mu + optimizer.nu, mesh)
        if mesh.spatial_size > 1:
            band = RowBand(mesh)
    halo = max(cfg.mofnet.k_size, cfg.codecnet.k_size) // 2
    whole = d > 1 and accum % d == 0
    split = d > 1 and not whole
    draw_shapes_of: Dict[tuple, List[tuple]] = {}

    def value_and_grad(fr, idx_rate, lam, noise, batch_mean=None):
        for p in params:
            p.grad = None
        loss, logs = gop_rd_loss(
            model, list(fr), gop, float(idx_rate), lam, lam,
            dist_loss=dist, weight_i_frame_loss=cfg.weight_i_frame_loss,
            training=True, flow_penalty=flow_penalty,
            alpha_penalty=alpha_penalty, noise=noise, batch_mean=batch_mean)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        loss, logs = loss.detach(), {k: v.detach() for k, v in logs.items()}
        if band is not None:
            return reduce_ranks(loss, logs, grads, "spatial", "sum")
        return loss, logs, grads

    def reduce_ranks(loss, logs, grads, axis: str, how: str):
        """The ranks' loss, logs and gradients on ``axis``, summed
        ("sum": shares of one whole) or averaged ("mean": slices of a
        batch); ``flow_max`` their maximum and ``psnr`` from the reduced
        mse."""
        n = mesh.size(axis)
        keys = [k for k in logs if k not in ("psnr", "flow_max")]
        flat = all_reduce(mesh, torch.cat(
            [loss.reshape(1)] + [logs[k].reshape(1) for k in keys]
            + [g.float().reshape(-1) for g in grads]), "sum", axis)
        if how == "mean":
            flat = flat / n
        fmax = all_reduce(mesh, logs["flow_max"].reshape(1), "max", axis)[0]
        red = dict(zip(keys, flat[1:1 + len(keys)]))
        red["psnr"] = psnr_of_mse(red["mse"])
        red["flow_max"] = fmax
        out, off = [], 1 + len(keys)
        for p in params:
            out.append(flat[off:off + p.numel()].view(p.shape).to(p.dtype))
            off += p.numel()
        return flat[0], {k: red[k] for k in logs}, out

    def split_value_and_grad(fr, idx_rate, lam, noise):
        """A (micro)batch split over the ranks: this rank's rows, then
        the slices' loss, logs and gradients averaged over 'data'."""
        b = fr.shape[1]
        if b % d:
            raise ValueError(f"batch {b} not divisible by data={d}")
        sl = batch_slice(mesh, b)
        loss, logs, grads = value_and_grad(
            fr[:, sl], idx_rate, lam, _RowsOf(noise, sl, d),
            batch_mean=lambda t: mean_over_data(mesh, t))
        return reduce_ranks(loss, logs, grads, "data", "mean")

    def draw_shapes(fr, idx_rate, lam) -> List[tuple]:
        """The shapes of the noise one microbatch ``fr`` draws, in order:
        a forward of its first sample without gradients, once per
        shape."""
        key = tuple(fr.shape)
        if key not in draw_shapes_of:
            probe = _DrawShapes()
            with torch.no_grad():
                gop_rd_loss(
                    model, list(fr[:, :1]), gop, float(idx_rate), lam, lam,
                    dist_loss=dist,
                    weight_i_frame_loss=cfg.weight_i_frame_loss,
                    training=True, flow_penalty=flow_penalty,
                    alpha_penalty=alpha_penalty, noise=probe)
            draw_shapes_of[key] = [(fr.shape[1],) + s[1:]
                                   for s in probe.shapes]
        return draw_shapes_of[key]

    def combine(gsum, losses, oks, logs_st):
        oks_t = torch.stack(oks)
        cnt = oks_t.sum()
        denom = torch.clamp_min(cnt, 1.0)
        grads = [(a / denom).to(p.dtype) for a, p in zip(gsum, params)]
        w = oks_t / denom
        loss = torch.sum(torch.stack(losses) * w)
        logs = {k: torch.sum(torch.stack([lg[k] for lg in logs_st]) * w)
                for k in logs_st[0]}
        logs["flow_max"] = torch.max(torch.where(
            oks_t > 0.5, torch.stack([lg["flow_max"] for lg in logs_st]),
            0.0))
        logs["micro_skipped"] = accum - cnt
        return loss, logs, grads, bool(cnt < 0.5)

    def whole_microbatches(frames, idx_rate, lam, noise, bm):
        """'data' divides accum: this rank's block of microbatches, the
        others' noise drawn and dropped, the sums all-reduced."""
        per = accum // d
        mine = range(mesh.data_index * per, (mesh.data_index + 1) * per)
        gsum = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        rows = {}
        for m in range(accum):
            fr = frames[:, m * bm:(m + 1) * bm]
            if m not in mine:
                for shape in draw_shapes(fr, idx_rate, lam):
                    noise.uniform(torch.empty(shape, device=frames.device))
                continue
            mloss, mlogs, mgrads = value_and_grad(fr, idx_rate, lam, noise)
            ok = micro_ok(mloss, mlogs, global_norm(mgrads))
            for a, g in zip(gsum, mgrads):
                a.add_(torch.where(ok, g.float(), 0.0))
            rows[m] = torch.stack(
                [torch.where(ok, mloss, 0.0), ok.float()]
                + [torch.where(ok, v, 0.0) for v in mlogs.values()]).float()
            keys = list(mlogs)
        table = torch.zeros((accum, 2 + len(keys)), dtype=torch.float32,
                            device=frames.device)
        for m, row in rows.items():
            table[m] = row
        flat = all_reduce(mesh, torch.cat(
            [table.reshape(-1)] + [a.reshape(-1) for a in gsum]), "sum")
        table = flat[:table.numel()].view(table.shape)
        off = table.numel()
        for i, a in enumerate(gsum):
            gsum[i] = flat[off:off + a.numel()].view(a.shape)
            off += a.numel()
        return combine(gsum, list(table[:, 0]), list(table[:, 1]),
                       [dict(zip(keys, r)) for r in table[:, 2:]])

    def train_step(frames: torch.Tensor, idx_rate: int, noise):
        if band is not None:
            check_rows(mesh, frames.shape[3], halo, "make_train_step")
            model.split_rows(band)
        try:
            with float32_precision(cfg):
                return step(frames, idx_rate, noise)
        finally:
            if band is not None:
                model.split_rows(None)

    def step(frames: torch.Tensor, idx_rate: int, noise):
        lam = float(lambdas[int(idx_rate)])
        if accum > 1:
            bt = frames.shape[1]
            if bt % accum:
                raise ValueError(f"batch {bt} not divisible by accum "
                                 f"{accum}")
            bm = bt // accum
            if whole:
                loss, logs, grads, all_bad = whole_microbatches(
                    frames, idx_rate, lam, noise, bm)
            else:
                gsum = [torch.zeros_like(p, dtype=torch.float32)
                        for p in params]
                losses, oks, logs_st = [], [], []
                vg = split_value_and_grad if split else value_and_grad
                for m in range(accum):
                    mloss, mlogs, mgrads = vg(
                        frames[:, m * bm:(m + 1) * bm], idx_rate, lam, noise)
                    ok = micro_ok(mloss, mlogs, global_norm(mgrads))
                    for a, g in zip(gsum, mgrads):
                        a.add_(torch.where(ok, g.float(), 0.0))
                    losses.append(torch.where(ok, mloss, 0.0))
                    logs_st.append({k: torch.where(ok, v, 0.0)
                                    for k, v in mlogs.items()})
                    oks.append(ok.float())
                loss, logs, grads, all_bad = combine(gsum, losses, oks,
                                                     logs_st)
        else:
            vg = split_value_and_grad if split else value_and_grad
            loss, logs, grads = vg(frames, idx_rate, lam, noise)
            logs["micro_skipped"] = torch.zeros((), device=frames.device)
            all_bad = False
        gnorm = global_norm(grads)
        ok = bool(micro_ok(loss, logs, gnorm)) and not all_bad
        for p, g in zip(params, grads):
            p.grad = g
        if ok:
            optimizer.update(grads)
        out = {k: float(v) for k, v in logs.items()}
        out["loss"] = float(loss)
        out["grad_norm"] = float(gnorm)
        out["step_skipped"] = 0.0 if ok else 1.0
        return out

    return train_step


def gop_curriculum(nb_epoch_done: int, change_epochs, gop_names):
    """The GOP structure to train on at this epoch: stage i runs until
    change_epochs[i] (trainer.py:225-237)."""
    if len(change_epochs) != len(gop_names):
        raise ValueError("change_epochs and gop_names must align")
    for end_epoch, name in zip(change_epochs, gop_names):
        if nb_epoch_done < end_epoch:
            return name
    return gop_names[-1]
