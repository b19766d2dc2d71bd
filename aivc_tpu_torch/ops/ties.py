"""Elementwise functions whose gradients at a tie follow JAX's rules.

The training forward is held against ``jax.grad`` of the JAX package, and
the two libraries differ where a function's derivative jumps:

  =====================  ==========================  ================
  function at the tie    JAX                         PyTorch
  =====================  ==========================  ================
  ``jnp.clip`` at a      0.5 (maximum, then          1 (``clamp``)
  bound                  minimum: each splits a tie)
  ``jnp.abs`` at 0       1                           0
  ``leaky_relu`` at 0    1 (``where(x >= 0, ...)``)  the slope
  =====================  ==========================  ================

The functions here compute the same values as their PyTorch namesakes,
bit for bit, and JAX's gradients.  Ties are common where they are used:
a bin probability rounds to exactly 1.0 for small scales, and a
reconstruction clipped to [0, 1] sits on its bounds.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


class _Clip(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.lo, ctx.hi = lo, hi
        return torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        lo, hi = ctx.lo, ctx.hi
        inside = x > lo if lo is not None else torch.ones_like(x, dtype=bool)
        if hi is not None:
            inside = inside & (x < hi)
        tie = torch.zeros_like(inside)
        for b in (lo, hi):
            if b is not None:
                tie = tie | (x == b)
        return (torch.where(inside, g, torch.where(tie, g * 0.5,
                                                   torch.zeros_like(g))),
                None, None)


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)`` (a maximum, then a minimum): the values of
    ``torch.clamp``; the gradient passes inside, half of it on a bound,
    none outside."""
    return _Clip.apply(x, lo, hi)


def floor_at(x: torch.Tensor, lo: float) -> torch.Tensor:
    """``jnp.maximum(x, lo)``: the values of ``torch.clamp_min``; half the
    gradient at x == lo."""
    return _Clip.apply(x, lo, None)


class _Abs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def abs_(x: torch.Tensor) -> torch.Tensor:
    """``jnp.abs``: the gradient at 0 is 1."""
    return _Abs.apply(x)


class _LeakyRelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, slope):
        ctx.save_for_backward(x)
        ctx.slope = slope
        return F.leaky_relu(x, slope)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, g * ctx.slope), None


def leaky_relu(x: torch.Tensor, slope: float = 0.01) -> torch.Tensor:
    """``jax.nn.leaky_relu``: the gradient at 0 is 1."""
    return _LeakyRelu.apply(x, slope)


class LeakyReLU(torch.nn.Module):
    def __init__(self, slope: float = 0.01):
        super().__init__()
        self.slope = slope

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(x, self.slope)
