"""Integer CDF tables of the port: byte-identical to the JAX package's.
One count off in a row would break every stream coded with it."""

from pathlib import Path

import numpy as np
import pytest

import jax
import torch

from aivc_tpu.coding import cdf as jcdf
from aivc_tpu.config import ModelConfig
from aivc_tpu.ops.entropy_models import FactorizedPrior as JPrior
from aivc_tpu_torch.coding import cdf as tcdf
from aivc_tpu_torch.ops.entropy_models import FactorizedPrior
from aivc_tpu_torch.utils.checkpoint import params_from_jax, read_params

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Test workers share the host's cores: a small PyTorch pool keeps
    them from oversubscribing it (spinning OpenMP threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["tiny-toy", "bf16-r5"])
def test_z_tables_byte_identical(name):
    path = ROOT / "models_ckpt" / name
    cfg = ModelConfig.from_json((path / "config.json").read_text())
    ac = cfg.ac_max_val
    tree = read_params(path)["params"]
    sd = params_from_jax(tree)
    for net in ("mofnet", "codecnet"):
        c = getattr(cfg, net).nb_ft_z
        ref = jcdf.build_z_table(JPrior(c), {"params": tree[net]["pdf_z"]},
                                 ac_max=ac)
        prior = FactorizedPrior(c)
        prior.load_state_dict({k.rsplit(".", 1)[1]: v for k, v in sd.items()
                               if k.startswith(f"{net}.pdf_z.")})
        ours = tcdf.build_z_table(prior, ac_max=ac)
        assert ours.dtype == ref.dtype
        assert ours.tobytes() == ref.tobytes()


@pytest.mark.parametrize("ac", [64, 256])
def test_laplace_table_byte_identical(ac):
    assert (tcdf.build_laplace_table(ac_max=ac).tobytes()
            == jcdf.build_laplace_table(ac_max=ac).tobytes())


def test_quantize_pmf_matches():
    rng = np.random.default_rng(0)
    pmf = rng.random((20, 128)) ** 4
    pmf[3] = 0.0
    np.testing.assert_array_equal(tcdf.quantize_pmf(pmf),
                                  jcdf.quantize_pmf(pmf))


def test_sigma_to_bin_matches_numpy():
    rng = np.random.default_rng(1)
    s = np.concatenate([np.exp(rng.uniform(-8, 8, size=200_000)),
                        jcdf.sigma_bin_centers(), [0.0, 1e-12, 1e9]]
                       ).astype(np.float32)
    ours = tcdf.sigma_to_bin(torch.from_numpy(s)).numpy()
    np.testing.assert_array_equal(ours, jcdf.sigma_to_bin_np(s))
    np.testing.assert_array_equal(
        ours, np.asarray(jax.jit(jcdf.sigma_to_bin_jnp)(s)))


@pytest.mark.parametrize("ac", [64, 256])
def test_gaussian_table_quantises_each_bins_normal(ac):
    """ELIC's Gaussian rows: each sums to PROB_SCALE, every symbol has a
    frequency of at least 1, and every frequency but the row's most
    probable lies within one quantum of p * (PROB_SCALE - n_sym) + 1,
    with p the bin's probability under normal_bin_prob (the edge symbols
    holding the tails); the most probable symbol takes the rounding
    remainder, under n_sym quanta."""
    from aivc_tpu_torch.ops.entropy_models import normal_bin_prob

    cdf = tcdf.build_gaussian_table(ac_max=ac).astype(np.int64)
    freq = np.diff(cdf, axis=1)
    n_sym = 2 * ac
    assert cdf.shape == (tcdf.NBINS, n_sym + 1)
    assert (cdf[:, 0] == 0).all() and (cdf[:, -1] == tcdf.PROB_SCALE).all()
    assert freq.min() >= 1
    sym = torch.arange(-ac, ac, dtype=torch.float64)
    sig = torch.from_numpy(tcdf.sigma_bin_centers())[:, None]
    p = normal_bin_prob(sym[None, :], sig).numpy()
    # Symbols -ac .. ac - 1: the tails beyond -ac - 0.5 and ac - 0.5.
    p[:, 0] += torch.special.ndtr((-ac - 0.5) / sig)[:, 0].numpy()
    p[:, -1] += torch.special.ndtr((-ac + 0.5) / sig)[:, 0].numpy()
    want = p / p.sum(axis=1, keepdims=True) * (tcdf.PROB_SCALE - n_sym) + 1
    # The row's most probable symbol (one of two equal edges for the
    # widest bins) is where the remainder went.
    dev = np.abs(freq - want)
    top = dev.argmax(axis=1)
    rows = np.arange(len(top))
    moved = dev.max(axis=1) > 1.0
    assert (p[rows, top] >= p.max(axis=1) * (1 - 1e-9))[moved].all()
    rest = np.ones_like(freq, bool)
    rest[rows, top] = False
    assert dev[rest].max() <= 1.0
    over = freq[rows, top] - want[rows, top]
    assert (over >= -1.0).all() and (over < n_sym).all()
