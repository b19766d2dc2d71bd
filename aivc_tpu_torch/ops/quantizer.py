"""Latent quantization (counterpart of aivc_tpu/ops/quantizer.py).

Eval: hard round to nearest, ties to even as ``jnp.round``, clipped to
the alphabet, with a straight-through gradient in ``ste_round``.
Training: additive uniform noise in [-0.5, 0.5) as a differentiable proxy
(quantizer.py:31-38).

The noise comes from a *noise source*, an object with a method
``uniform(like)`` that returns a float32 tensor of ``like``'s shape on
``like``'s device.  ``GeneratorNoise`` draws it on the tensor's device
from a ``torch.Generator`` of that device; ``FixedNoise`` hands out
tensors the caller made, in the order the quantizer asks for them.  The
training forward asks in JAX's key-split order: frames in coding order
(train/loss.py:69), within a P- or B-frame MOFNet before CodecNet
(models/fullnet.py:159-161), within each net z before y
(models/conditional.py:225-227).  So a test can feed the port the very
draws of ``jax.random``, which PyTorch cannot reproduce.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, Iterable, List

import torch

from aivc_tpu_torch.config import AC_MAX_VAL


class _SteRound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """round(x) whose gradient is the identity (quantizer.py:ste_round)."""
    return _SteRound.apply(x)


class GeneratorNoise:
    """Uniform noise in [-0.5, 0.5) drawn on the tensor's device, one
    ``torch.Generator`` per device, each seeded with ``seed``.  ``shapes``
    lists the draws since the last ``shapes.clear()`` (the trainer reads
    it to time the draws of a step)."""

    def __init__(self, seed: int):
        self.seed = int(seed)
        self._gens: Dict[torch.device, torch.Generator] = {}
        self.shapes: List[tuple] = []

    def _gen(self, device: torch.device) -> torch.Generator:
        g = self._gens.get(device)
        if g is None:
            g = torch.Generator(device=device)
            g.manual_seed(self.seed)
            self._gens[device] = g
        return g

    def uniform(self, like: torch.Tensor) -> torch.Tensor:
        self.shapes.append(tuple(like.shape))
        u = torch.rand(like.shape, generator=self._gen(like.device),
                       dtype=torch.float32, device=like.device)
        return u - 0.5


class FixedNoise:
    """Hands out the given tensors in order, each moved to the asking
    tensor's device; a shape that differs from the asking tensor's
    raises, and so does asking for more than were given."""

    def __init__(self, tensors: Iterable[torch.Tensor]):
        self._queue = deque(tensors)

    def __len__(self) -> int:
        return len(self._queue)

    def uniform(self, like: torch.Tensor) -> torch.Tensor:
        if not self._queue:
            raise RuntimeError("FixedNoise: no noise tensor left")
        t = self._queue.popleft()
        if tuple(t.shape) != tuple(like.shape):
            raise ValueError(f"FixedNoise: next tensor has shape "
                             f"{tuple(t.shape)}, the latent "
                             f"{tuple(like.shape)}")
        return t.to(device=like.device, dtype=torch.float32)


def quantize(x: torch.Tensor, ac_max: int = AC_MAX_VAL, *,
             training: bool = False, noise=None) -> torch.Tensor:
    """Eval: round(x) clipped to the alphabet [-ac_max, ac_max - 1], the
    eval branch of ConditionalNet.encode_latents and analyze
    (conditional.py:231,239).  Training: x + uniform noise in
    [-0.5, 0.5) from the noise source ``noise`` (float32 latents)."""
    if training:
        if noise is None:
            raise ValueError("quantize(training=True) needs a noise source")
        return x + noise.uniform(x)
    return torch.clamp(torch.round(x), -ac_max, ac_max - 1)
