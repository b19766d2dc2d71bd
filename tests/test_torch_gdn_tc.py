"""K4's bf16 tensor-core arithmetic, held on the host.

On the card the bf16 path of K4 sums x2 * (hi + lo) on the tensor cores,
gamma split by ``ops/gdn.py:split_gamma`` into two bf16 terms.  Here:
  * the split keeps gamma within 2^-16 relative (each bf16 rounding is
    within 2^-8 relative; measured 7.6e-6, about 2^-17, at most);
  * that arithmetic, emulated with an exact float64 sum rounded once to
    f32, is within GDN_PLAIN_ULPS = 2 bf16 ulps of gdn_fused_plain (the
    normaliser may round to its bf16 neighbour, and the quotient again),
    and so is JAX's own gdn_pallas (an MXU product, in interpret mode):
    both sum in another order than the plain version, the same property;
  * ``smoke.bf16_ulps`` counts ulps in the larger binade of the value
    and the reference, so that a step across a power of two counts once.
"""

from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from aivc_tpu.ops.gdn import gdn_pallas
from aivc_tpu_torch import smoke
from aivc_tpu_torch.ops import gdn as tg
from aivc_tpu_torch.utils.checkpoint import read_params

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Test workers share the host's cores: a small PyTorch pool keeps
    them from oversubscribing it (spinning OpenMP threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _random(c, seed, h=24, w=40):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal((1, c, h, w)) * 2)
                         .astype(np.float32)).to(torch.bfloat16)
    beta_r = torch.from_numpy(np.sqrt(rng.uniform(0.5, 1.5, c))
                              .astype(np.float32))
    gamma_r = torch.from_numpy(np.sqrt(rng.uniform(0, 0.05, (c, c)))
                               .astype(np.float32))
    return x, beta_r, gamma_r


def _bf16_r5_gdns():
    """(beta_r, gamma_r) of every C = 128 GDN layer of bf16-r5."""
    params = read_params(ROOT / "models_ckpt" / "bf16-r5")
    found = []

    def walk(tree):
        if isinstance(tree, dict):
            if "beta" in tree and "gamma" in tree:
                g = np.asarray(tree["gamma"], np.float32)
                if g.shape == (128, 128):
                    found.append((torch.from_numpy(
                        np.asarray(tree["beta"], np.float32)),
                        torch.from_numpy(g)))
            for v in tree.values():
                walk(v)
    walk(params)
    return found


def _tc_emulated(x, beta, gamma, inverse):
    """K4's bf16 arithmetic: x2 = bf16(x * x); the sum of x2 * (hi + lo)
    exact (float64), rounded once to f32; then plain's epilogue."""
    hi, lo = tg.split_gamma(gamma)
    g = hi.double() + lo.double()
    x2 = torch.square(x).double()
    acc = torch.einsum("bjhw,oj->bohw", x2, g).float()
    norm = torch.sqrt(acc + beta.float().view(1, -1, 1, 1)).to(x.dtype)
    return x * norm if inverse else x / norm


def test_split_gamma_of_random_and_checkpoint_gammas():
    gammas = [tg.reparam(b, g)[1] for b, g in _bf16_r5_gdns()]
    assert len(gammas) >= 6
    gammas.append(tg.reparam(*_random(128, 0)[1:])[1])
    for gamma in gammas:
        hi, lo = tg.split_gamma(gamma)
        assert hi.dtype == lo.dtype == torch.bfloat16
        assert hi.is_contiguous() and lo.is_contiguous()
        assert torch.equal(hi, gamma.to(torch.bfloat16))
        err = (hi.double() + lo.double() - gamma.double()).abs()
        assert bool((err <= 2.0 ** -16 * gamma.double().abs()).all())


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("inverse", [False, True])
def test_tensor_core_sum_within_two_ulps_of_plain(seed, inverse):
    x, beta_r, gamma_r = _random(128, seed)
    beta, gamma = tg.reparam(beta_r, gamma_r)
    out = _tc_emulated(x, beta, gamma, inverse)
    ref = tg.gdn_fused_plain(x, beta, gamma, inverse)
    ulps = smoke.bf16_ulps(out, ref)
    assert float(ulps.max()) <= smoke.GDN_PLAIN_ULPS
    # Most outputs are equal: only normalisers next to a bf16 rounding
    # boundary differ.
    assert float((ulps > 0).float().mean()) < 1e-3


@pytest.mark.parametrize("layer", range(6))
def test_checkpoint_gdns_within_two_ulps_of_plain(layer):
    beta_r, gamma_r = _bf16_r5_gdns()[layer]
    beta, gamma = tg.reparam(beta_r, gamma_r)
    x = _random(128, 10 + layer)[0]
    for inverse in (False, True):
        out = _tc_emulated(x, beta, gamma, inverse)
        ref = tg.gdn_fused_plain(x, beta, gamma, inverse)
        assert float(smoke.bf16_ulps(out, ref).max()) <= smoke.GDN_PLAIN_ULPS


@pytest.mark.parametrize("inverse", [False, True])
def test_jax_mxu_product_within_two_ulps_of_plain(inverse):
    """JAX's gdn_pallas (bf16, interpret mode) against the plain version:
    the same limit holds for the reference's own product order."""
    x, beta_r, gamma_r = _random(128, 5, h=16, w=32)
    beta, gamma = tg.reparam(beta_r, gamma_r)
    xn = x.float().numpy()
    with pltpu.force_tpu_interpret_mode():
        ref_jax = np.asarray(gdn_pallas(
            jnp.array(np.moveaxis(xn, 1, -1), jnp.bfloat16),
            jnp.array(beta_r.numpy()), jnp.array(gamma_r.numpy()),
            inverse=inverse).astype(jnp.float32))
    jx = torch.from_numpy(np.moveaxis(ref_jax, -1, 1).copy())
    plain = tg.gdn_fused_plain(x, beta, gamma, inverse)
    assert float(smoke.bf16_ulps(jx, plain).max()) <= smoke.GDN_PLAIN_ULPS


def test_bf16_ulps_counts_in_the_reference_binade():
    """In the reference's binade where the value stays in it; across a
    power of two, in the larger of the two binades, whichever side the
    reference lies (the last pair: 1.5 steps of 2^-6's binade, which read
    three of the binade below it)."""
    ref = torch.tensor([1.0, 1.0, 1.9921875, -2.0, 0.0, 2.0, 0.01556396484375])
    a = torch.tensor([1.0078125, 1.015625, 2.0, -2.03125, 0.0, 1.9921875,
                      0.0157470703125])
    assert smoke.bf16_ulps(a, ref).tolist() == [1.0, 2.0, 0.5, 2.0, 0.0,
                                                0.5, 1.5]
