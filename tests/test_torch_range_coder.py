"""The port's host range coder and chunk payloads against the JAX
package's.

Integer layers, so every comparison is exact (tolerance 0, error 0):
  * the native coder (built by g++ into aivc_tpu_torch/_build/) = its
    pure-Python oracle = JAX's ``range_coder.encode``, byte for byte, on
    random symbols and rows and on bf16-r5's own z and Laplace tables,
    and both decoders give the symbols back;
  * ``encode_z_chunk`` / ``encode_y_chunk`` bytes = JAX's for the same
    latents, and each decode = JAX's decode;
  * ``expected_bits`` = JAX's within 1e-12 relative (measured: equal);
  * a failed build raises instead of falling back to the Python coder.
"""

from pathlib import Path

import numpy as np
import pytest

import torch

from aivc_tpu.coding import bitstream as jbs
from aivc_tpu.coding import cdf as jcdf
from aivc_tpu.coding import range_coder as jrc
from aivc_tpu_torch.coding import bitstream as tbs
from aivc_tpu_torch.coding import cdf as tcdf
from aivc_tpu_torch.coding import range_coder as trc
from aivc_tpu_torch.utils.checkpoint import load_checkpoint

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Test workers share the host's cores: a small PyTorch pool keeps
    them from oversubscribing it (spinning OpenMP threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def r5_tables():
    """bf16-r5's z rows (both nets) and Laplace rows, built by the port."""
    _, model = load_checkpoint(ROOT / "models_ckpt" / "bf16-r5",
                               device="cpu")
    zm = tcdf.build_z_table(model.mofnet.pdf_z, ac_max=64)
    zc = tcdf.build_z_table(model.codecnet.pdf_z, ac_max=64)
    lap = tcdf.build_laplace_table(ac_max=64)
    return {"z_m": zm, "z_c": zc, "lap": lap}


def _draw(cdf: np.ndarray, rows: np.ndarray, rng) -> np.ndarray:
    """One symbol per element from its row's distribution."""
    slots = rng.integers(0, trc.PROB_SCALE, size=rows.shape)
    sym = np.empty(rows.shape, np.int64)
    for r in np.unique(rows):
        sel = rows == r
        sym[sel] = np.searchsorted(cdf[r], slots[sel], side="right") - 1
    return sym


def _random_rows(rng, n_rows: int, width: int) -> np.ndarray:
    """Strictly increasing integer CDF rows [n_rows, width + 1]."""
    freq = rng.integers(1, 400, size=(n_rows, width)).astype(np.float64)
    q = np.floor(freq / freq.sum(1, keepdims=True)
                 * (trc.PROB_SCALE - width)).astype(np.int64) + 1
    q[:, -1] += trc.PROB_SCALE - q.sum(1)
    return np.concatenate([np.zeros((n_rows, 1), np.int64),
                           np.cumsum(q, axis=1)], axis=1).astype(np.uint32)


@pytest.mark.parametrize("seed,n,width,uniform", [
    (0, 1, 16, True), (1, 3000, 16, True), (2, 20000, 128, False),
    (3, 20000, 128, True)])
def test_native_equals_oracle_and_jax_on_random_rows(seed, n, width,
                                                     uniform):
    rng = np.random.default_rng(seed)
    cdf = _random_rows(rng, 37, width)
    rows = rng.integers(0, 37, size=n).astype(np.int32)
    sym = (rng.integers(0, width, size=n) if uniform
           else _draw(cdf, rows, rng)).astype(np.uint16)
    ours = trc.encode(sym, cdf, rows)
    assert ours == trc._py_encode(sym, cdf, rows)
    assert ours == jrc.encode(sym, cdf, rows)
    np.testing.assert_array_equal(trc.decode(ours, n, cdf, rows), sym)
    np.testing.assert_array_equal(trc._py_decode(ours, n, cdf, rows), sym)


@pytest.mark.parametrize("table", ["z_m", "z_c", "lap"])
def test_native_equals_oracle_and_jax_on_bf16_r5_tables(r5_tables, table):
    rng = np.random.default_rng(7)
    cdf = r5_tables[table]
    rows = rng.integers(0, cdf.shape[0], size=12000).astype(np.int32)
    sym = _draw(cdf, rows, rng).astype(np.uint16)
    ours = trc.encode(sym, cdf, rows)
    assert ours == trc._py_encode(sym, cdf, rows)
    assert ours == jrc.encode(sym, cdf, rows)
    np.testing.assert_array_equal(trc.decode(ours, sym.size, cdf, rows),
                                  sym)


def test_empty_and_bad_inputs():
    cdf = _random_rows(np.random.default_rng(0), 2, 8)
    assert trc.encode(np.zeros(0, np.uint16), cdf,
                      np.zeros(0, np.int32)) == b""
    assert trc.decode(b"", 0, cdf, np.zeros(0, np.int32)).size == 0
    with pytest.raises(ValueError, match="row_idx"):
        trc.encode(np.zeros(3, np.uint16), cdf, np.full(3, 2, np.int32))
    with pytest.raises(ValueError, match="rans_encode failed"):
        trc.encode(np.full(2, 8, np.uint16), cdf, np.zeros(2, np.int32))


def test_failed_build_raises(tmp_path, monkeypatch):
    """A missing compiler or a source that does not compile raises; the
    coder never falls back to the Python oracle."""
    monkeypatch.setattr(trc, "_lib", None)
    monkeypatch.setattr(trc, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(trc, "CXX", "no-such-compiler-aivc")
    with pytest.raises(RuntimeError, match="cannot run"):
        trc.encode(np.zeros(4, np.uint16),
                   _random_rows(np.random.default_rng(0), 1, 8),
                   np.zeros(4, np.int32))
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(trc, "CXX", "g++")
    monkeypatch.setattr(trc, "SRC", bad)
    with pytest.raises(RuntimeError, match="failed to build"):
        trc.lib()
    assert not list((tmp_path / "build").glob("*.so"))


def _latents(rng, shape, ac, p_zero_channel=0.3):
    """Laplace-ish integer latents in [-ac, ac - 1] with whole channels
    zero (the elided ones)."""
    y = np.clip(np.round(rng.laplace(0, 1.5, size=shape)), -ac, ac - 1)
    y[..., rng.random(shape[-1]) < p_zero_channel] = 0
    return y.astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1])
def test_chunk_functions_match_jax(r5_tables, seed):
    rng = np.random.default_rng(seed)
    lap = r5_tables["lap"]
    for fam in ("z_m", "z_c"):
        rows = r5_tables[fam]
        z = _latents(rng, (3, 5, rows.shape[0]), 64, p_zero_channel=0.0)
        ours = tbs.encode_z_chunk(z, rows)
        assert ours == jbs.encode_z_chunk(z, rows)
        back = tbs.decode_z_chunk(ours, z.shape, rows)
        np.testing.assert_array_equal(back, z)
        np.testing.assert_array_equal(
            back, jbs.decode_z_chunk(ours, z.shape, rows))
    y = _latents(rng, (4, 6, 128), 64)
    bins = rng.integers(0, tcdf.NBINS, size=y.shape).astype(np.int32)
    ours = tbs.encode_y_chunk(y, bins, lap)
    assert ours == jbs.encode_y_chunk(y, bins, lap)
    back = tbs.decode_y_chunk(ours, y.shape, bins, lap)
    np.testing.assert_array_equal(back, y)
    np.testing.assert_array_equal(
        back, jbs.decode_y_chunk(ours, y.shape, bins, lap))
    zero = np.zeros((2, 2, 8), np.int32)
    assert tbs.encode_y_chunk(zero, bins[:2, :2, :8], lap) == b"\x00"
    assert tbs.encode_y_chunk(zero, bins[:2, :2, :8], lap) == \
        jbs.encode_y_chunk(zero, bins[:2, :2, :8], lap)


def test_expected_bits_matches_jax(r5_tables):
    rng = np.random.default_rng(3)
    lap = r5_tables["lap"]
    rows = rng.integers(0, lap.shape[0], size=(40, 50))
    sym = _draw(lap, rows, rng)
    ours = tcdf.expected_bits(sym, rows, lap)
    ref = jcdf.expected_bits(sym, rows, lap)
    assert abs(ours - ref) <= 1e-12 * abs(ref)
    assert ours > 0
