"""ELIC in the port (models/elic.py, pipeline/elic.py) against its plain
float32 reference (tests/torch_elic_ref.py) on seeded random weights, at
a tiny size of its own (N 16, M 40, groups 2/2/4/8/24, 64 x 96 frames):
the stages, the context model's causality, the staged entropy decode,
the finish's pinned bytes and a bit-exact round trip through
encode_video / decode_video."""

import hashlib
import json

import numpy as np
import pytest
import torch

import torch_elic_ref as ref
from aivc_tpu_torch import tracing
from aivc_tpu_torch.coding import bitstream as bs
from aivc_tpu_torch.coding import vrans
from aivc_tpu_torch.config import FRAME_I, CodingConfig, ElicConfig
from aivc_tpu_torch.models.elic import Elic
from aivc_tpu_torch.pipeline.codec import FrameCodec, make_codec
from aivc_tpu_torch.pipeline.elic import ElicCodec
from aivc_tpu_torch.pipeline.video import (
    decode_video,
    encode_video,
    synthetic_frames,
)
from aivc_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    model_from_params,
    params_to_jax,
    save_tree,
)

TINY = ElicConfig(name="elic-tiny", n=16, m=40, groups=(2, 2, 4, 8, 24),
                  ctx_hidden=(12, 8), agg_hidden=(24, 16), dtype="float32")
H, W = 64, 96
# The analysis's last conv scaled so that a good share of the y symbols
# is non-zero on these frames.
GAIN = 6.0
# Float32 on both sides, the same convolutions in the same order but not
# always the same algorithm (the transposed convs run on a transposed
# copy of the kernel in the port): agreement to a few float32 ulps of the
# largest value, which bounds the sums' reordering through ~60 layers.
REL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Test workers share the host's cores: a small PyTorch pool keeps
    them from oversubscribing it (spinning OpenMP threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def seeded_tree(cfg: ElicConfig, seed: int = 7, gain: float = GAIN):
    """A parameter tree of ``cfg`` in the JAX layout: weights normal of std
    1 / sqrt(fan_in) (g_a's last conv times ``gain``), biases and the
    prior's leaves normal of std 0.1, drawn in the sorted order of the
    parameter names."""
    model = Elic(cfg)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in sorted(model.named_parameters()):
            v = torch.randn(p.shape, generator=gen)
            if name.endswith("weight"):
                v = v / float(np.sqrt(p[0].numel()))
                if name == "g_a.conv_3.weight":
                    v = v * gain
            else:
                v = v * 0.1
            p.copy_(v)
    return params_to_jax(model.state_dict())["params"]


def model_block(cfg: ElicConfig) -> dict:
    return json.loads(cfg.to_json())


@pytest.fixture(scope="module")
def tree():
    return seeded_tree(TINY)


@pytest.fixture(scope="module")
def frames():
    return synthetic_frames(5, H, W, seed=3)


def _codec(cfg, tree, **kw):
    return make_codec(cfg, model_from_params(cfg, tree, "cpu"), H, W,
                      device="cpu", **kw)


def _planes(frames):
    return {k: torch.from_numpy(np.stack([f[k] for f in frames]))
            for k in ("y", "u", "v")}


def _close(a, b):
    scale = float(b.abs().max())
    assert float((a - b).abs().max()) <= REL * max(scale, 1.0), (
        float((a - b).abs().max()), scale)


def test_config_round_trips_and_selects_the_model(tmp_path, tree):
    assert ElicConfig.from_json(TINY.to_json()) == TINY
    save_tree(tmp_path, TINY, {"params": tree})
    cfg, model = load_checkpoint(tmp_path, device="cpu")
    assert cfg == TINY and isinstance(model, Elic)
    with pytest.raises(ValueError, match="do not sum"):
        ElicConfig(m=40, groups=(2, 2))


@torch.no_grad()
def test_stages_match_the_reference(tree, frames):
    """Every stage on the same inputs: the analysis, the hyperprior, each
    context step's mu and sigma, the synthesis."""
    model = model_from_params(TINY, tree, "cpu")
    net = ref.RefElic(tree, model_block(TINY), "cpu")
    orig = _planes(frames[:2])
    x = ref.to_444(orig)
    y = model.analyze(x)
    _close(y, net.g_a(x))
    _close(model.hyper_analyze(y), net.h_a(y))
    zq = torch.round(model.hyper_analyze(y))
    hyper = model.hyper_synthesize(zq)
    _close(hyper, net.h_s(zq))
    anchors = ref.anchor_mask(y.shape[2], y.shape[3])
    c0, done = 0, []
    for k, g in enumerate(TINY.groups):
        cc = model.channel_context(k, done)
        if k:
            _close(cc, net.channel_context(k, done))
        cur = torch.where(anchors, torch.round(y[:, c0:c0 + g]), 0.0)
        sc = model.spatial_context(k, cur)
        _close(sc, net.spatial_context(k, cur))
        mu, sigma = model.params(k, hyper, cc, sc)
        rmu, rsigma = net.params(k, hyper, cc, sc)
        _close(mu, rmu)
        _close(sigma, rsigma)
        done.append(y[:, c0:c0 + g])
        c0 += g
    _close(model.synthesize(y), net.g_s(y))


def test_round_trip_equals_the_reference(tree, frames):
    """The codec's symbols are the reference's roundings of its own
    latents, and its reconstruction the reference's synthesis of them."""
    codec = _codec(TINY, tree)
    seen = []
    inner = codec._encode_step

    def keep(k, p, *a):
        out = inner(k, p, *a)
        seen.append(out[1])
        return out
    codec._encode_step = keep
    res = encode_video(codec, frames[:2], CodingConfig(coding_config="AI"),
                       wave_batch=2)
    net = ref.RefElic(tree, model_block(TINY), "cpu")
    out = ref.code_frame(net, _planes(frames[:2]))
    nonzero = 0
    for q, (_, p, _), step in zip(seen, codec.steps, out["steps"]):
        assert torch.equal(q, codec._gather(step["q"], p))
        nonzero += int((q != 0).sum())
    assert nonzero > 0
    for i in range(2):
        got = res.decoded_frames[i].planes
        want = ref.apply_dc(out["pre_dc"], out["dc"])
        for c in ("y", "u", "v"):
            assert np.array_equal(got[c], want[c][i].numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_round_trip_is_bit_exact(tree, frames, dtype):
    """encode_video then decode_video, All-Intra, waves of 2 over 5
    frames: the decoder's symbols are the encoder's and its frames the
    encoder's reconstruction, in float32 and in bfloat16."""
    cfg = ElicConfig(**{**model_block(TINY), "groups": TINY.groups,
                        "ctx_hidden": TINY.ctx_hidden,
                        "agg_hidden": TINY.agg_hidden, "dtype": dtype})
    codec = _codec(cfg, tree)
    enc_syms, dec_syms = [], []
    inner_e, inner_s = codec._encode_step, codec._scatter

    def keep_e(*a):
        out = inner_e(*a)
        enc_syms.append(out[1])
        return out

    def keep_s(v, c, p):
        dec_syms.append(v)
        return inner_s(v, c, p)
    codec._encode_step, codec._scatter = keep_e, keep_s
    res = encode_video(codec, frames, CodingConfig(coding_config="AI"),
                       wave_batch=2)
    dec = decode_video(codec, res.bitstream)
    assert len(enc_syms) == len(dec_syms) == 30
    for a, b in zip(enc_syms, dec_syms):
        assert torch.equal(a, b)
    for i in range(len(frames)):
        for c in ("y", "u", "v"):
            assert np.array_equal(dec[i].planes[c],
                                  res.decoded_frames[i].planes[c])
    assert all(fr.bytes > 0 and fr.mode_bytes == 0
               for fr in res.frame_results)


def _all_params(codec, y_hat, hyper):
    """Every step's (mu, bins) with the decoder's inputs taken from
    ``y_hat``: the groups before each step and its group's anchors."""
    out, done, cache = [], [], {}
    for k, p, c0 in codec.steps:
        g = TINY.groups[k]
        anchors = torch.where(codec._mask[0], y_hat[:, c0:c0 + g], 0.0)
        out.append(codec._step_params(k, p, hyper, done, anchors, cache))
        if p == 1:
            done.append(y_hat[:, c0:c0 + g])
    return out


@torch.no_grad()
def test_each_step_sees_only_what_was_decoded_before_it(tree):
    """Perturbing y_hat at the positions of step t leaves the mu and
    sigma bins of every step up to t unchanged (the non-anchors do not
    reach their own group's anchors, group k nothing of the groups after
    it), and changes a later step's."""
    codec = _codec(TINY, tree)
    gen = torch.Generator().manual_seed(5)
    y_hat = torch.randn((2, TINY.m, codec.hy, codec.wy), generator=gen) * 3
    hyper = torch.randn((2, 2 * TINY.m, codec.hy, codec.wy), generator=gen)
    base = _all_params(codec, y_hat, hyper)
    for t, (k, p, c0) in enumerate(codec.steps):
        g = TINY.groups[k]
        bumped = y_hat.clone()
        bumped[:, c0:c0 + g] += torch.where(codec._mask[p], 5.0, 0.0)
        got = _all_params(codec, bumped, hyper)
        for s in range(t + 1):
            assert torch.equal(got[s][0], base[s][0]), (t, s)
            assert torch.equal(got[s][1], base[s][1]), (t, s)
        if t < len(codec.steps) - 1:
            assert any(not torch.equal(got[s][0], base[s][0])
                       for s in range(t + 1, len(codec.steps))), t


@torch.no_grad()
def test_staged_plain_decode_returns_the_coded_symbols(tree, frames):
    """One K1 stream of z and the ten steps, decoded by ``decode_plain``
    stage by stage, each stage resumed from the last one's states and word
    cursor: every stage gives back the symbols coded."""
    codec = _codec(TINY, tree)
    w = codec.encode_frames_launch(frames[:2], [None] * 2, [None] * 2, 0,
                                   0.0)
    kk, parts, _, _ = codec._wave_parts(w)
    assert kk == 8
    assert [s.shape[1] for s, _ in parts] == codec._n_pad(kk)
    sym = torch.cat([s for s, _ in parts], 1)
    rows = torch.cat([r for _, r in parts], 1)
    buf, states, seg_g = vrans.encode_plain(sym, rows, codec.table, kk)
    n_pad = sym.shape[1]
    words = torch.stack([torch.cat([buf[b, seg_g[b, 0]:],
                                    torch.zeros(int(seg_g[b, 0]),
                                                dtype=torch.uint16)])
                         for b in range(2)])
    st, g = states, torch.zeros(2, dtype=torch.int32)
    for s, r in parts:
        back, st, g = vrans.decode_plain(words, st, r, codec.table, kk, g)
        assert torch.equal(back, s)
    assert torch.equal(g.long(), n_pad - seg_g[:, 0].long())


# Each frame's sha256 and stats from ``encode_frames_finish`` on the
# seeded handles of ``_finish_handle``, as ELIC's finish wrote them when
# it was its own method (before WaveCodec held the one K1 finish).
FINISH_PINS = {
    1: (["4d91c3203edfe6968066c24cffcffe16ae5f8f28976a9b6a9bd4ff98aff8b278"],
        [1323], [1266]),
    3: (["55e458e372079dbb4d2da7c77e3f97f2bd6dab68007bfa35e92b11f1501ebf04",
         "bce9be5a9e4bb36d1ea4182e6c41cf60fffcdc70617b8643e6889884fa0ff1cc",
         "3f0598f85aecb0f3a65663a2977d503e080d6d04b4bdd5d4b504ad445c3a3d5d"],
        [1311, 1317, 1351], [1254, 1260, 1294]),
}


def _finish_handle(codec, k: int, seed: int) -> dict:
    """A wave handle as the launch hands it to the finish, of seeded
    integer values: z, each step's symbols and sigma bins, a DC row a
    frame."""
    gen = torch.Generator().manual_seed(seed)
    acv = codec.ac_max
    n_bins = codec.fused_rows.shape[0] - codec._row_off["y"]
    z = torch.clamp(torch.round(2.0 * torch.randn(
        (k, codec.cfg.n, codec.hz, codec.wz), generator=gen)),
        -acv, acv - 1) + 0.0
    steps = []
    for kg, p, _ in codec.steps:
        n = codec.cfg.groups[kg] * codec._pos[p].numel()
        q = torch.clamp(torch.round(3.0 * torch.randn((k, n), generator=gen)),
                        -acv, acv - 1) + 0.0
        steps.append((q, torch.randint(0, n_bins, (k, n), generator=gen,
                                       dtype=torch.int32)))
    dc = torch.randint(-9, 10, (k, 3), generator=gen, dtype=torch.int32)
    return {"k": k, "frame_type": FRAME_I, "z": z, "steps": steps,
            "dc": dc, "decoded": None}


@torch.no_grad()
@pytest.mark.parametrize("k,seed", [(1, 11), (3, 12)])
def test_finish_bytes_are_pinned(tree, k, seed):
    """The finish writes the pinned bytes and stats; the decode front
    parses them, and the K2-segment helper (the plain decode on the host)
    gives back z, every step's symbols and the DC rows."""
    codec = _codec(TINY, tree)
    w = _finish_handle(codec, k, seed)
    fbs, _, stats = codec.encode_frames_finish(w)
    shas, n_bytes, codec_bytes = FINISH_PINS[k]
    assert [hashlib.sha256(fb).hexdigest() for fb in fbs] == shas
    assert stats == [{"alpha_mean": 1.0, "beta_mean": 1.0, "bytes": b,
                      "mode_bytes": 0, "codec_bytes": c, "k": 8}
                     for b, c in zip(n_bytes, codec_bytes)]
    chunks = [bs.unpack_frame(fb) for fb in fbs]
    assert [c["__dc__"] for c in chunks] == [tuple(r)
                                             for r in w["dc"].tolist()]
    kk, pads, words, st, g = codec._decode_front(chunks, FRAME_I)
    assert kk == 8 and pads == codec._n_pad(kk)
    z, st, g = codec._dec_z(words, st, g, pads[0], kk, TINY.n, "z")
    assert torch.equal(z, w["z"])
    yo = codec._row_off["y"]
    for (q, bins), n in zip(w["steps"], pads[1:]):
        back, st, g = codec._k2_seg(words, st, g, bins + yo, n, kk, yo)
        assert torch.equal(back, q)
    assert g.tolist() == [c // 2 for c in codec_bytes]


def test_a_decoded_wave_takes_eleven_k2_launches(tree, frames, monkeypatch):
    """z, then one launch a context step; one K1 launch an encoded wave."""
    codec = _codec(TINY, tree)
    calls = {"decode": 0, "encode": 0}
    dec, enc = vrans.decode_batch, vrans.encode_batch

    def count(kind, fn):
        def wrapped(*a, **kw):
            calls[kind] += 1
            return fn(*a, **kw)
        return wrapped
    monkeypatch.setattr(vrans, "decode_batch", count("decode", dec))
    monkeypatch.setattr(vrans, "encode_batch", count("encode", enc))
    res = encode_video(codec, frames, CodingConfig(coding_config="AI"),
                       wave_batch=2)
    assert calls["encode"] == 3
    decode_video(codec, res.bitstream)
    assert calls["decode"] == 11 * 3


def test_spans_mark_each_context_step(tree, frames):
    codec = _codec(TINY, tree)
    with tracing.recording() as rec:
        res = encode_video(codec, frames[:2], CodingConfig(coding_config="AI"),
                           wave_batch=2)
        decode_video(codec, res.bitstream)
    for name in ("launch.ctx", "batch.ctx"):
        steps = [(s.attrs["group"], s.attrs["pass"]) for s in
                 rec.named(name)]
        assert steps == [(k, p) for k in range(5) for p in (0, 1)]
    ctx = {s.id for s in rec.named("batch.ctx")}
    k2 = rec.named("batch.k2")
    assert len(k2) == 11 and sum(s.parent in ctx for s in k2) == 10


def test_intra_only_and_streams_of_the_other_model_are_refused(tree,
                                                               frames):
    codec = _codec(TINY, tree)
    with pytest.raises(ValueError, match="intra-only"):
        encode_video(codec, frames, CodingConfig(coding_config="RA",
                                                 gop_size=4, intra_period=4))
    with pytest.raises(ValueError, match="intra-only"):
        encode_video(codec, frames, CodingConfig(coding_config="LDP",
                                                 intra_period=4))
    elic = encode_video(codec, frames[:2], CodingConfig(coding_config="AI"),
                        wave_batch=2).bitstream
    from pathlib import Path
    aivc = load_checkpoint(Path(__file__).resolve().parents[1]
                           / "models_ckpt" / "tiny-toy", device="cpu")
    other = FrameCodec(aivc[0], aivc[1], H, W, device="cpu")
    assert not isinstance(other, ElicCodec)
    with pytest.raises(ValueError, match="coded by an ELIC model"):
        decode_video(other, elic)
    stream = encode_video(other, frames[:2], CodingConfig(coding_config="AI"),
                          wave_batch=2).bitstream
    with pytest.raises(ValueError, match="coded by an AIVC model"):
        decode_video(codec, stream)


def test_cli_codes_an_elic_checkpoint(tmp_path, tree, frames, capsys):
    """``python -m aivc_tpu_torch`` with an ELIC checkpoint directory:
    All-Intra encodes, decodes and reports; RA is refused."""
    from aivc_tpu_torch import cli
    from aivc_tpu_torch.io.yuv import YuvWriter

    ckpt = tmp_path / "elic"
    save_tree(ckpt, TINY, {"params": tree})
    clip = tmp_path / f"clip_{W}x{H}_30_420.yuv"
    with YuvWriter(str(clip)) as w:
        for f in frames[:3]:
            w.write_frame(f)
    args = ["--cpu", "-i", str(clip), "-o", str(tmp_path / "dec.yuv"),
            "--bitstream_out", str(tmp_path / "clip.bin"), "--model",
            str(ckpt), "--wave_batch", "2"]
    assert cli.main(args + ["--coding_config", "AI"]) == 0
    assert "[RESULT] decoding fps" in capsys.readouterr().out
    with pytest.raises(ValueError, match="intra-only"):
        cli.main(args + ["--coding_config", "RA", "--gop_size", "2",
                         "--intra_period", "2"])


def test_the_benchmarks_reference_is_this_one():
    """codecbench/reference/elic.py, the judge's reference, is a copy of
    this file's reference."""
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    assert ((root / "codecbench" / "reference" / "elic.py").read_text()
            == (root / "tests" / "torch_elic_ref.py").read_text())
