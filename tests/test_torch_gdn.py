"""The port's fused GDN (``gdn_fused``, whose host route is the plain
version of kernel K4) against aivc_tpu/ops/gdn.py:gdn_pallas run in
interpret mode on the host, at f32 and bf16, forward and inverse, at
C = 128 (the fused route) and C = 96 (JAX's shape rule falls back to
gdn_apply).  The GDN layers use gdn_apply, as the JAX models do.

Tolerance, elementwise |port - jax| <= RTOL * |jax| + ATOL:
  f32   RTOL 1e-6, ATOL 1e-6   measured 3.5e-7 relative (7.6e-6 on
                               values to 52)
  bf16  RTOL 2^-6, ATOL 1e-6   two bf16 steps: the two sum the channels
                               in another order, so the bf16 normaliser
                               may round to its neighbour, and then the
                               bf16 quotient; measured 0.0136 relative
                               (C = 128), 0.0038 (C = 96, gdn_apply)
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from aivc_tpu.ops.gdn import gdn_pallas
from aivc_tpu_torch.ops import gdn as tg

TOL = {"float32": (1e-6, 1e-6), "bfloat16": (2.0 ** -6, 1e-6)}
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Test workers share the host's cores: a small PyTorch pool keeps
    them from oversubscribing it (spinning OpenMP threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _params(c, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((1, 16, 32, c)) * 2).astype(np.float32)
    beta = np.sqrt(rng.uniform(0.5, 1.5, c)).astype(np.float32)
    gamma = np.sqrt(np.abs(rng.standard_normal((c, c))) * 0.05).astype(
        np.float32)
    return x, beta, gamma


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [128, 96])
@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_fused_matches_gdn_pallas(dtype, c, inverse):
    x, beta, gamma = _params(c, seed=c)
    jdt, tdt = DT[dtype]
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(gdn_pallas(jnp.array(x, jdt), jnp.array(beta),
                                    jnp.array(gamma), inverse=inverse
                                    ).astype(jnp.float32))
    tx = torch.tensor(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).to(tdt)
    out = tg.gdn_fused(tx, torch.tensor(beta), torch.tensor(gamma), inverse)
    if c == 128:
        assert out.dtype == tdt       # gdn_pallas keeps x's type
    out = out.float().permute(0, 2, 3, 1).numpy()
    rtol, atol = TOL[dtype]
    assert (np.abs(out - ref) <= rtol * np.abs(ref) + atol).all()


def test_shape_rule_falls_back_to_gdn_apply():
    """Rows not a multiple of 512, or C not of 128: gdn_apply itself."""
    g = torch.Generator().manual_seed(0)
    for shape in ((1, 128, 10, 10), (1, 96, 16, 32)):
        x = torch.randn(shape, generator=g)
        b = torch.rand(shape[1], generator=g) + 0.5
        gm = torch.rand(shape[1], shape[1], generator=g) * 0.2
        assert torch.equal(tg.gdn_fused(x, b, gm, True),
                           tg.gdn_apply(x, b, gm, True))


@pytest.mark.parametrize("clamp,lowp", [(0.0, False), (16.0, False),
                                        (0.0, True)])
def test_layer_uses_gdn_apply(clamp, lowp):
    """Every GDN layer takes gdn_apply with its own clamp and type rule,
    even where gdn_fused's shape rule would hold (no model calls
    gdn_pallas in JAX either)."""
    layer = tg.GDN(128, inverse=False, clamp=clamp, lowp=lowp)
    x = torch.randn((1, 128, 16, 32), generator=torch.Generator()
                    .manual_seed(1)).to(torch.bfloat16)
    with torch.no_grad():
        got = layer(x)
        want = tg.gdn_apply(x, layer.beta, layer.gamma, False, clamp, lowp)
    assert got.dtype == want.dtype and torch.equal(got, want)
