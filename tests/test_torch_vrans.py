"""The port's plain rANS coder against aivc_tpu/coding/vrans.py.

Integer layer: words, states, segment word counts and chunk bytes must be
byte-identical to encode_impl / decode_impl (XLA path) and to the Pallas
kernels run in interpret mode, at n of a few thousand and K = 1024
(mirrors tests/test_vrans.py:181-265, including the staged decode with
g0 and return_carry).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from aivc_tpu.coding import vrans as jv
from aivc_tpu.coding.cdf import build_laplace_table
from aivc_tpu_torch.coding import vrans as tv

K = 1024


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Test workers share the host's cores: a small PyTorch pool keeps
    them from oversubscribing it (spinning OpenMP threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rand_cdf_rows(rng, n_rows, n_sym=512, skew=3.0):
    pmf = rng.random((n_rows, n_sym)) ** skew + 1e-3
    from aivc_tpu.coding.cdf import quantize_pmf
    return quantize_pmf(pmf, jv.PROB_SCALE)


def _jax_encode(vals, rows, enc, n, k, segs):
    buf, st, tot, sw = jv.encode_impl(
        jnp.asarray(vals), jnp.asarray(rows), enc, n=n, k=k,
        n_sym=enc.n_symbols, pad_sym=enc.pad_sym, method="gather",
        segment_steps=segs)
    tot = int(tot)
    return np.asarray(buf)[:tot], np.asarray(st), np.asarray(sw)


def _port_words(buf, seg_g, i):
    return buf[i, int(seg_g[i, 0]):].numpy()


@pytest.mark.parametrize("table", ["laplace", "random"])
def test_encode_matches_encode_impl(table):
    rng = np.random.default_rng(5)
    cdf = (build_laplace_table(scale=jv.PROB_SCALE) if table == "laplace"
           else _rand_cdf_rows(rng, 12))
    enc = jv.make_enc_tables(cdf)
    t = tv.make_table(cdf, "cpu")
    b, n1, n2 = 2, 2 * K, 3 * K
    n = n1 + n2
    segs = (n1 // K, n2 // K)
    lo, hi = (180, 332) if table == "laplace" else (0, 512)
    vals = rng.integers(lo, hi, size=(b, n)).astype(np.int32)
    rows = rng.integers(0, cdf.shape[0], size=(b, n)).astype(np.int32)
    buf, st, seg_g = tv.encode_plain(torch.from_numpy(vals),
                                     torch.from_numpy(rows), t, K, segs)
    for i in range(b):
        words, jst, jsw = _jax_encode(vals[i], rows[i], enc, n, K, segs)
        np.testing.assert_array_equal(_port_words(buf, seg_g, i), words)
        np.testing.assert_array_equal(st[i].numpy(), jst)
        bounds = np.append(seg_g[i].numpy(), n)
        np.testing.assert_array_equal(np.diff(bounds), jsw)
        # the serialized chunk is byte-identical
        bms = [tv.chan_bitmap(np.arange(12) % (i + 2) == 0)]
        assert (tv.serialize_chunk_v2(K, st[i].numpy(), words, bms)
                == jv.serialize_chunk_v2(K, jst, words, bms))


def test_encode_matches_pallas_interpret():
    rng = np.random.default_rng(9)
    cdf = build_laplace_table(scale=jv.PROB_SCALE, ac_max=64)
    dec = jv.make_dec_tables(cdf)
    t = tv.make_table(cdf, "cpu")
    b, n = 2, 3 * K
    vals = rng.integers(40, 90, size=(b, n)).astype(np.int32)
    rows = rng.integers(0, cdf.shape[0], size=(b, n)).astype(np.int32)
    segs = (1, 2)
    jbuf, jst, jseg, g0 = jv.encode_pallas_batch(
        jnp.asarray(vals), jnp.asarray(rows), dec.cdf512_f32, n=n, k=K,
        pad_sym=0, segment_steps=segs, interpret=True)
    jbuf, jseg = np.asarray(jbuf), np.asarray(jseg)
    buf, st, seg_g = tv.encode_plain(torch.from_numpy(vals),
                                     torch.from_numpy(rows), t, K, segs)
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
    # same cursor arithmetic relative to each buffer's end
    np.testing.assert_array_equal(n - seg_g.numpy(), g0 - jseg)
    for i in range(b):
        np.testing.assert_array_equal(_port_words(buf, seg_g, i),
                                      jbuf[i, jseg[i, 0]:g0])


def _encoded_batch(rng, cdf, b, n, segs):
    enc = jv.make_enc_tables(cdf)
    vals = np.stack([rng.integers(0, cdf.shape[1] - 1, size=n)
                     .astype(np.int32) * (1 if i else 0) for i in range(b)])
    rows = rng.integers(0, cdf.shape[0], size=(b, n)).astype(np.int32)
    out = [_jax_encode(vals[i], rows[i], enc, n, K, segs) for i in range(b)]
    m = max(jv.bucket(len(o[0]), n) for o in out)
    w = np.zeros((b, m), np.uint16)
    for i, o in enumerate(out):
        w[i, :len(o[0])] = o[0]
    st = np.stack([o[1] for o in out])
    sw = np.stack([o[2] for o in out])
    return vals, rows, w, st, sw


def test_decode_matches_decode_impl_and_pallas():
    rng = np.random.default_rng(47)
    cdf = _rand_cdf_rows(rng, 12)
    dec = jv.make_dec_tables(cdf)
    t = tv.make_table(cdf, "cpu")
    b, n = 3, 5 * K
    vals, rows, w, st, _ = _encoded_batch(rng, cdf, b, n, (5,))
    syms, pst, pg = tv.decode_plain(torch.from_numpy(w),
                                    torch.from_numpy(st),
                                    torch.from_numpy(rows), t, K)
    np.testing.assert_array_equal(syms.numpy(), vals)
    for i in range(b):
        js, jst, jg = jv.decode_impl(
            jnp.asarray(w[i]), jnp.asarray(st[i]), jnp.asarray(rows[i]),
            dec, n=n, k=K, n_sym=dec.n_symbols, method="gather",
            return_carry=True)
        np.testing.assert_array_equal(syms[i].numpy(), np.asarray(js))
        np.testing.assert_array_equal(pst[i].numpy(), np.asarray(jst))
        assert int(pg[i]) == int(jg)
    jp = jv.decode_pallas_batch(jnp.asarray(w), jnp.asarray(st),
                                jnp.asarray(rows), dec.cdf512_f32, n=n,
                                k=K, interpret=True)
    np.testing.assert_array_equal(syms.numpy(), np.asarray(jp))


def test_staged_decode_with_carry():
    rng = np.random.default_rng(3)
    cdf = _rand_cdf_rows(rng, 12)
    dec = jv.make_dec_tables(cdf)
    t = tv.make_table(cdf, "cpu")
    b, n1, n2 = 3, 2 * K, 3 * K
    vals, rows, w, st, sw = _encoded_batch(rng, cdf, b, n1 + n2,
                                           (n1 // K, n2 // K))
    wt, rt = torch.from_numpy(w), torch.from_numpy(rows)
    s1, st1, g1 = tv.decode_plain(wt, torch.from_numpy(st), rt[:, :n1], t,
                                  K)
    np.testing.assert_array_equal(s1.numpy(), vals[:, :n1])
    np.testing.assert_array_equal(g1.numpy(), sw[:, 0])
    js1, jst1, jg1 = jv.decode_pallas_batch(
        jnp.asarray(w), jnp.asarray(st), jnp.asarray(rows[:, :n1]),
        dec.cdf512_f32, n=n1, k=K, interpret=True, return_carry=True)
    np.testing.assert_array_equal(st1.numpy(), np.asarray(jst1))
    np.testing.assert_array_equal(g1.numpy(), np.asarray(jg1))
    s2, st2, g2 = tv.decode_plain(wt, st1, rt[:, n1:], t, K, g0=g1)
    np.testing.assert_array_equal(s2.numpy(), vals[:, n1:])
    np.testing.assert_array_equal(g2.numpy(), sw.sum(axis=1))


def test_batch_dispatch_on_host_is_plain():
    rng = np.random.default_rng(1)
    cdf = build_laplace_table(scale=jv.PROB_SCALE, ac_max=64)
    t = tv.make_table(cdf, "cpu")
    vals = torch.from_numpy(rng.integers(50, 80, size=(2, 2 * K))
                            .astype(np.int32))
    rows = torch.from_numpy(rng.integers(0, 64, size=(2, 2 * K))
                            .astype(np.int32))
    a = tv.encode_batch(vals, rows, t, K, (1, 1))
    b = tv.encode_plain(vals, rows, t, K, (1, 1))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("n", [0, 1, 500, 4096, 100_000, 3_000_000])
def test_policy_helpers_match(n):
    assert tv.pick_k(n) == jv.pick_k(n)
    for k in (8, 1024, 2048):
        assert tv.plan(n, k) == jv.plan(n, k)
        assert tv.bucket(n, 1 << 22) == jv.bucket(n, 1 << 22)


def test_chunk_format_helpers_match():
    rng = np.random.default_rng(2)
    for c in (12, 96, 128):
        mask = rng.random(c) < 0.3
        bm = tv.chan_bitmap(mask)
        assert bm == jv.chan_bitmap(mask)
        np.testing.assert_array_equal(tv.bitmap_channels(bm, c),
                                      jv.bitmap_channels(bm, c))
        for cm in range(c + 1):
            assert tv.elide_bucket(cm, c) == jv.elide_bucket(cm, c)
    states = rng.integers(1 << 16, 1 << 32, size=64, dtype=np.uint64
                          ).astype(np.uint32)
    words = rng.integers(0, 1 << 16, size=300).astype(np.uint16)
    bms = [tv.chan_bitmap(rng.random(96) < 0.5),
           tv.chan_bitmap(rng.random(128) < 0.5)]
    ours = tv.serialize_chunk_v2(64, states, words, bms)
    assert ours == jv.serialize_chunk_v2(64, states, words, bms)
    w, s, k, b = tv.parse_chunk_v2(ours)
    jw, js, jk, jb = jv.parse_chunk_v2(ours)
    np.testing.assert_array_equal(w, jw)
    np.testing.assert_array_equal(s, js)
    assert k == jk == 64 and b == jb == bms
