"""AIVC as the program runs it: ``aivc_tpu_torch``'s FullNet (MOFNet and
CodecNet, conditional autoencoders with hyperpriors; arXiv 2202.04365)
under FrameCodec.  A configuration names it with ``"architecture":
"aivc"`` and holds the program's ModelConfig under ``"model"``.

The harness calls, by these names, what every architecture provides:

* ``system(root, config, traffic, device, weights_dir)``: the system
  under test (harness/system.py:System) built from the checkpoint files
  in ``weights_dir``;
* ``capture_decode(system, stream)``: a decode with the symbols each
  batch reads recorded;
* ``judge(weights_dir, config, traffic, kept, waves, specs, device)``:
  the float32 reference's judgement of the judged clips, a Tally whose
  ``numbers()`` are latent_excess, latent_mismatch, recon_gap, dc_gap
  and frames_judged (reference/judge.py);
* ``control(weights_dir, config, traffic, clips, waves, specs, device,
  precision=None)``: the reference in the precision below the
  configuration's, coding the clips on its own loop, judged alike;
* ``frame_flops(model, frame_type, height, width, part)``: the frozen
  FLOP count of a frame;
* ``init_tree(config, generator)``: seeded parameters;

and, for the tools, ``fault(name, system)`` (the planted faults that
reach into the model's stages, harness/faults.py) and ``diagnose``
(diagnose.py).
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from harness.system import System
from reference.judge import Tally, control_frame, judge_frame
from reference.msgpack import read_params
from reference.net import (FRAME_B, FRAME_I, RefNet, apply_dc, arithmetic,
                           cast_planes, encode_frame, to_444, warp)

# The reference's precision below each configuration's: TF32 for float32,
# float8 e4m3 convolutions for bfloat16.
LOWER = {"float32": "tf32", "bfloat16": "fp8"}


# ---------------------------------------------------------------------------
# The system under test
# ---------------------------------------------------------------------------

def model_config(config: dict):
    from aivc_tpu_torch.config import ModelConfig
    return ModelConfig.from_json(json.dumps(config["model"]))


def system(root: Path, config: dict, traffic: dict, device,
           weights_dir: Path) -> System:
    """One FrameCodec for the cell's frame size, from the parameters in
    ``weights_dir`` with the compute dtype the configuration states."""
    from aivc_tpu_torch.pipeline.codec import FrameCodec
    from aivc_tpu_torch.utils.checkpoint import model_from_params, read_tree

    device = torch.device(device)
    cfg = model_config(config)
    _, tree = read_tree(weights_dir)
    model = model_from_params(cfg, tree, device)
    codec = FrameCodec(cfg, model, traffic["height"], traffic["width"],
                       device=device)
    del model
    return System(codec, traffic, device)


def capture_decode(system: System, stream: bytes):
    """Decode ``stream`` with the symbols each batch reads recorded: per
    decode batch, in call order, the frame type, per net the z and y
    symbols (keys ("z", net), ("y", net)) and the DC offsets ("dc").
    -> (decoded planes, batches)."""
    codec = system.codec
    batches: List[dict] = []

    def keep(key):
        return lambda v: batches[-1].__setitem__(key, v.detach().clone())

    hooks = [
        (codec, "decode_frames_batch",
         lambda fb, p, n, t, *a, **kw: batches.append({"type": t})),
        (codec, "_hyper", lambda which, z: keep(("z", which))(z)),
        (codec, "_motion", lambda q, *a: keep(("y", "mofnet"))(q)),
        (codec.model, "codecnet_synth",
         lambda q, *a: keep(("y", "codecnet"))(q)),
        (codec, "_apply_dc", lambda out, dc: keep("dc")(dc)),
    ]
    for obj, name, see in hooks:
        inner = getattr(obj, name)

        def wrapped(*a, _inner=inner, _see=see, **kw):
            _see(*a, **kw)
            return _inner(*a, **kw)
        setattr(obj, name, wrapped)
    try:
        planes = system.decode(stream)
    finally:
        for obj, name, _ in hooks:
            obj.__dict__.pop(name, None)
    return planes, batches


# ---------------------------------------------------------------------------
# Correctness: the judge and the control
# ---------------------------------------------------------------------------

def judge(weights_dir: Path, config: Dict, traffic: Dict,
          kept: Dict[int, Dict], waves: List[List[int]], specs: Dict,
          device) -> Tally:
    """The reference's judgement of the judged clips: each frame as the
    program decoded it, its references the program's decoded frames."""
    def planes_t(p):
        return {k: torch.from_numpy(np.ascontiguousarray(p[k]))[None]
                .to(device) for k in ("y", "u", "v")}

    tally = Tally()
    with arithmetic("f32"):
        net = RefNet(read_params(weights_dir), config["model"], device, "f32")
        for k in kept.values():
            clip, dec = k["clip"], k["decoded"]
            for wave, b in zip(waves, k["batches"]):
                for r, j in enumerate(wave):
                    s = specs[j]
                    nets = ["codecnet"] + (["mofnet"] if s["type"] else [])
                    cand = {"z": {n: b[("z", n)][r:r + 1].to(device).float()
                                  for n in nets},
                            "y": {n: b[("y", n)][r:r + 1].to(device).float()
                                  for n in nets},
                            "dc": (b["dc"][r:r + 1].to(device) if "dc" in b
                                   else torch.zeros((1, 3), dtype=torch.int32,
                                                    device=device)),
                            "planes": planes_t(dec[j])}
                    orig = {c: torch.from_numpy(clip.planes[c][j:j + 1])
                            .to(device) for c in ("y", "u", "v")}
                    prev = (None if s["prev"] is None
                            else planes_t(dec[s["prev"]]))
                    nxt = (None if s["next"] is None
                           else planes_t(dec[s["next"]]))
                    judge_frame(net, tally, orig, prev, nxt, s["type"],
                                float(traffic["idx_rate"]), cand)
    return tally


@torch.no_grad()
def control(weights_dir: Path, config: Dict, traffic: Dict, clips,
            waves: List[List[int]], specs: Dict, device,
            precision: str = None) -> tuple:
    """The reference in ``precision`` (default: ``LOWER`` of the
    configuration's) standing in for the program: it codes ``clips``
    closed loop on its own reconstructions, and the float32 reference
    judges each frame as it judges the program's.  -> (precision,
    Tally)."""
    precision = precision or LOWER[config["peak_dtype"]]
    tree = read_params(weights_dir)
    ref = RefNet(tree, config["model"], device, "f32")
    low = RefNet(tree, config["model"], device, precision)
    idx_rate = float(traffic["idx_rate"])
    tally = Tally()
    for clip in clips:
        own = {}
        for wave in waves:
            for j in wave:
                s = specs[j]
                orig = {k: torch.from_numpy(clip.planes[k][j:j + 1])
                        .to(device) for k in ("y", "u", "v")}
                prev, nxt = own.get(s["prev"]), own.get(s["next"])
                with arithmetic(precision):
                    cand = control_frame(low, orig, prev, nxt, s["type"],
                                         idx_rate)
                own[j] = cand["planes"]
                with arithmetic("f32"):
                    judge_frame(ref, tally, orig, prev, nxt, s["type"],
                                idx_rate, cand)
    return precision, tally


# ---------------------------------------------------------------------------
# Planted faults
# ---------------------------------------------------------------------------

def fault(name: str, system: System) -> None:
    """Break ``system`` in place where the fault needs the model's stages:
    ``token`` (one symbol of each frame's CodecNet latent altered by +3
    where the encoder rounds it) or ``unchanged`` (the synthesis hands
    back its prediction)."""
    codec = system.codec
    if name == "token":
        inner = codec._quantize_y

        def altered(y, mu):
            q = inner(y, mu).clone()
            if q.shape[1] == codec.cfg.codecnet.nb_ft_y:
                q[:, 0, 0, 0] = torch.clamp(q[:, 0, 0, 0] + 3,
                                            max=codec.ac_max - 1)
            return q
        codec._quantize_y = altered
    elif name == "unchanged":
        codec.model.codecnet_synth = (lambda y, mu, pred, skip, *a, **kw:
                                      pred + skip)
    else:
        raise KeyError(f"no fault {name!r} in the aivc architecture")


# ---------------------------------------------------------------------------
# FLOPs
# ---------------------------------------------------------------------------
#
# Frozen count of a frame's model FLOPs: two operations per multiply-add
# of every convolution, the 1x1 convolutions of (inverse) GDN included,
# elementwise work left out, as ``torch.utils.flop_counter`` counts the
# RD forward (FullNet.forward_frame).  The frame is padded to a multiple
# of 64 first, as the codec pads it.
#
# ``part="encode"`` counts what an encode runs per frame (both nets'
# analysis, hyper-analysis, hyper-synthesis, shortcut and synthesis: the
# forward); ``part="decode"`` what a decode runs (hyper-synthesis,
# shortcut and synthesis).

PAD = 64
I, P, B = 0, 1, 2


def _conv(cin, cout, k, px):
    return 2 * cin * cout * k * k * px


def _attention(c, px):
    return 12 * _conv(c, c, 3, px) + _conv(c, c, 1, px)


def _analysis(cin, c, cout, k, h, w, attention):
    """g_a / g_a_ref: four stride-2 convs, GDN after the first three."""
    f, ch = 0, cin
    for i, out in enumerate((c, c, c, cout)):
        px = (h >> (i + 1)) * (w >> (i + 1))
        f += _conv(ch, out, k, px)
        if i < 3:
            f += _conv(out, out, 1, px)
        if i == 1 and attention:
            f += _attention(c, px)
        ch = out
    return f


def _synthesis(cin, c, cout, k, h, w, attention):
    """g_s: four x2 up-blocks (a conv to 4x channels, then IGDN on the
    first three), attention after the first."""
    f, ch = 0, cin
    for i, out in enumerate((c, c, c, cout)):
        px_in = (h >> (4 - i)) * (w >> (4 - i))
        f += _conv(ch, 4 * out, k, px_in)
        if i < 3:
            f += _conv(out, out, 1, 4 * px_in)
        if i == 0 and attention:
            f += _attention(c, 4 * px_in)
        ch = out
    return f


def _hyper_analysis(c, h, w):
    y, z = c["nb_ft_y"], c["nb_ft_z"]
    return (_conv(y, z, 3, (h >> 4) * (w >> 4)) + _conv(z, z, 5, (h >> 5)
            * (w >> 5)) + _conv(z, z, 5, (h >> 6) * (w >> 6)))


def _hyper_synthesis(c, h, w):
    y, z = c["nb_ft_y"], c["nb_ft_z"]
    return (_conv(z, 4 * y, 5, (h >> 6) * (w >> 6))
            + _conv(y, 4 * y, 5, (h >> 5) * (w >> 5))
            + _conv(y, 2 * y, 3, (h >> 4) * (w >> 4)))


def net_flops(c: Dict, h: int, w: int, shortcut: bool, part: str) -> int:
    att = c.get("use_attention", True)
    k = c.get("k_size", 5)
    f = _hyper_synthesis(c, h, w) + _synthesis(
        c["nb_ft_y"] + c["out_c_shortcut_y"], c["nb_ft"], c["out_c"], k,
        h, w, att)
    if shortcut and c["in_c_shortcut"] > 0:
        f += _analysis(c["in_c_shortcut"], c["nb_ft"], c["out_c_shortcut_y"],
                       k, h, w, False)
    if part == "encode":
        f += _analysis(c["in_c"], c["nb_ft"], c["nb_ft_y"], k, h, w, att)
        f += _hyper_analysis(c, h, w)
    return f


def frame_flops(model: Dict, frame_type: int, height: int, width: int,
                part: str = "encode") -> int:
    """Model FLOPs of one frame of ``frame_type`` at height x width."""
    if part not in ("encode", "decode"):
        raise ValueError(f"unknown part {part!r}")
    h = -(-height // PAD) * PAD
    w = -(-width // PAD) * PAD
    f = net_flops(model["codecnet"], h, w, frame_type != I, part)
    if frame_type != I:
        f += net_flops(model["mofnet"], h, w, frame_type == B, part)
    return f


# ---------------------------------------------------------------------------
# Seeded parameters
# ---------------------------------------------------------------------------

PEDESTAL = (2.0 ** -18) ** 2
GAMMA_INIT = 0.1
LECUN_TRUNC = 0.87962566103423978   # std of a unit normal cut at +-2
PRIOR_FILTERS = (1, 3, 3, 3, 1)


def _net_layout(c: Dict, gain_i: bool) -> Dict[tuple, tuple]:
    """{path: (shape, kind)} of one ConditionalNet's leaves."""
    if c.get("ec_mode", "one") != "one":
        raise ValueError(f"init_tree lays out ec_mode 'one', not "
                         f"{c['ec_mode']!r}")
    k, nb = c.get("k_size", 5), c["nb_ft"]
    y, z = c["nb_ft_y"], c["nb_ft_z"]
    out = {}

    def conv(path, size, cin, cout):
        out[path + ("Conv_0", "kernel")] = ((size, size, cin, cout), "conv")
        out[path + ("Conv_0", "bias")] = ((cout,), "zero")

    def gdn(path, ch):
        out[path + ("GDN_0", "beta")] = ((ch,), "beta")
        out[path + ("GDN_0", "gamma")] = ((ch, ch), "gamma")

    def attention(path):
        for i in range(6):
            for j in range(2):
                conv(path + (f"ResBlock_{i}", f"ConvBlock_{j}"), 3, nb, nb)
        conv(path, 1, nb, nb)

    def analysis(name, cin, cout, att):
        for i, o in enumerate((nb, nb, nb, cout)):
            conv((name, f"ConvBlock_{i}"), k, cin, o)
            if i < 3:
                gdn((name, f"ConvBlock_{i}"), o)
            cin = o
        if att:
            attention((name, "SimplifiedAttention_0"))

    att = c.get("use_attention", True)
    analysis("g_a", c["in_c"], y, att)
    if c["in_c_shortcut"] > 0:
        analysis("g_a_ref", c["in_c_shortcut"], c["out_c_shortcut_y"], False)
    cin = y + c["out_c_shortcut_y"]
    for i, o in enumerate((nb, nb, nb, c["out_c"])):
        conv(("g_s", f"UpBlock_{i}"), k, cin, 4 * o)
        if i < 3:
            gdn(("g_s", f"UpBlock_{i}"), o)
        cin = o
    if att:
        attention(("g_s", "SimplifiedAttention_0"))
    conv(("h_a", "ConvBlock_0"), 3, y, z)
    conv(("h_a", "ConvBlock_1"), 5, z, z)
    conv(("h_a", "ConvBlock_2"), 5, z, z)
    conv(("h_s", "UpBlock_0"), 5, z, 4 * y)
    conv(("h_s", "UpBlock_1"), 5, y, 4 * y)
    conv(("h_s", "ConvBlock_0"), 3, y, 2 * y)
    f = PRIOR_FILTERS
    for i in range(len(f) - 1):
        out[("pdf_z", f"h{i}")] = ((z, f[i], f[i + 1]), "prior")
        out[("pdf_z", f"b{i}")] = ((z, f[i + 1]), "prior")
        if i < len(f) - 2:
            out[("pdf_z", f"a{i}")] = ((z, f[i + 1]), "prior")
    gains = (["I"] if gain_i or not c.get("gain_p_b", True) else []) + (
        ["P", "B"] if c.get("gain_p_b", True) else [])
    for g in gains:
        for side in ("enc_gain", "dec_gain"):
            out[(f"gain_{g}", side)] = ((c["n_rates"], y), "one")
    return out


def layout(model: Dict) -> Dict[tuple, tuple]:
    """{path: (shape, kind)} of every leaf of a FullNet's parameter tree
    (MOFNet carries no I-frame gains)."""
    out = {}
    for net, gain_i in (("mofnet", False), ("codecnet", True)):
        for path, leaf in _net_layout(model[net], gain_i).items():
            out[(net,) + path] = leaf
    return out


def init_tree(config: Dict, generator: torch.Generator) -> Dict:
    """A parameter tree for ``config["model"]`` (nested dicts of float32
    numpy arrays in the JAX layout, conv kernels HWIO) drawn from
    ``generator``, on its device, in two calls: one truncated normal for
    every conv kernel and one normal for every prior leaf, each cut into
    the leaves in the order of their sorted paths.  The distributions are
    flax's initialisers, the ones the JAX package trains from:

    * conv kernels lecun-normal: a normal of std sqrt(1 / fan_in) /
      0.8796 (fan_in = kh * kw * cin) cut at two of its stds;
    * biases 0; the gain rows 1;
    * GDN beta sqrt(1 + pedestal) and gamma sqrt(0.1 I + pedestal), the
      reparametrised values of beta 1 and gamma 0.1 I (pedestal 2^-36);
    * the factorized prior's matrices h_i [C, d_in, d_out], biases b_i and
      factors a_i [C, d_out] normal of std sqrt(2 / (d_in * d_out))
      (d_in 1 for b_i and a_i).
    """
    leaves = sorted(layout(config["model"]).items())
    dev = generator.device

    def draw(kind, fn):
        n = sum(math.prod(s) for _, (s, k) in leaves if k == kind)
        flat = torch.empty(n, dtype=torch.float32, device=dev)
        fn(flat)
        return flat.cpu().numpy()

    conv = draw("conv", lambda t: torch.nn.init.trunc_normal_(
        t, 0.0, 1.0, -2.0, 2.0, generator=generator))
    prior = draw("prior", lambda t: t.normal_(generator=generator))
    at = {"conv": 0, "prior": 0}
    tree: Dict = {}
    for path, (shape, kind) in leaves:
        if kind in at:
            n = math.prod(shape)
            v = (conv if kind == "conv" else prior)[at[kind]:at[kind] + n]
            at[kind] += n
            fan = (shape[0] * shape[1] * shape[2] if kind == "conv"
                   else (shape[1] if path[-1][0] == "h" else 1) * shape[-1])
            std = (math.sqrt(1.0 / fan) / LECUN_TRUNC if kind == "conv"
                   else math.sqrt(2.0 / fan))
            arr = (v * np.float32(std)).reshape(shape)
        elif kind == "zero":
            arr = np.zeros(shape, np.float32)
        elif kind == "one":
            arr = np.ones(shape, np.float32)
        elif kind == "beta":
            arr = np.full(shape, math.sqrt(1.0 + PEDESTAL), np.float32)
        else:
            arr = np.sqrt(GAMMA_INIT * np.eye(shape[0]) + PEDESTAL
                          ).astype(np.float32)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = arr
    return tree


# ---------------------------------------------------------------------------
# Diagnosis (diagnose.py): where the program and the reference part
# ---------------------------------------------------------------------------

def record_encode(system: System, frames):
    """Encode with each wave's stages recorded: (result, waves), a wave a
    dict of batched tensors."""
    codec, model = system.codec, system.codec.model
    waves = []
    cur = {}

    def keep(key, v):
        cur.setdefault(key, v.detach().float().clone())

    def wrap(obj, name, after):
        inner = getattr(obj, name)

        def wrapped(*a, **kw):
            out = inner(*a, **kw)
            after(out, *a)
            return out
        setattr(obj, name, wrapped)
        return (obj, name)

    def nets_done(t, *a):
        w = dict(cur)
        w.update({k: v for k, v in t.items() if torch.is_tensor(v)})
        waves.append(w)
        cur.clear()

    hooks = [
        wrap(model.mofnet, "analyze", lambda o, *a: keep("mofnet.y", o[0])),
        wrap(model.codecnet, "analyze",
             lambda o, *a: keep("codecnet.y", o[0])),
        wrap(codec, "_hyper", lambda o, which, z: keep(f"{which}.mu", o[0])),
        wrap(model, "mofnet_synth_maps", lambda o, *a: keep("maps", o)),
        wrap(model, "motion_comp_stage",
             lambda o, *a: keep("pred", o["pred"])),
        wrap(model, "codecnet_synth", lambda o, *a: keep("synth", o)),
        wrap(codec, "_encode_nets", nets_done),
    ]
    handles = [
        m.h_a.register_forward_hook(
            lambda mod, i, o, n=n: keep(f"{n}.z", o))
        for n, m in (("mofnet", model.mofnet), ("codecnet", model.codecnet))]
    try:
        res = system.encode(frames)
    finally:
        for obj, name in hooks:
            obj.__dict__.pop(name, None)
        for h in handles:
            h.remove()
    return res, waves


def fdiff(a, b):
    d = (a.float() - b.float()).abs()
    return {"max_abs": float(d.max()), "mean_abs": float(d.mean())}


def ndiff(a, b):
    return int((a != b).sum())


@torch.no_grad()
def stages(net: RefNet, port: dict, orig, prev, nxt, ftype, idx_rate):
    """The reference's stages of one frame on the program's inputs, each
    compared with the program's (``port``: this frame's slice of its
    wave's records)."""
    out = {}
    x = to_444(orig)
    syms = {}

    def code(n, inp):
        y, z = net.analyze(n, inp, ftype, idx_rate)
        out[f"{n}.y"] = fdiff(port[f"{n}.y"], y)
        out[f"{n}.z"] = fdiff(port[f"{n}.z"], z)
        out[f"{n}.z_sym"] = ndiff(port["z_m" if n == "mofnet" else "z_c"],
                                  net.quantize(z))
        zq = port["z_m" if n == "mofnet" else "z_c"]
        mu, _ = net.hyper(n, zq)
        out[f"{n}.r"] = fdiff(port[f"{n}.y"] - port[f"{n}.mu"], y - mu)
        yq_port = port["q_m" if n == "mofnet" else "q_c"]
        out[f"{n}.y_sym"] = ndiff(yq_port, net.quantize(y - mu))
        syms[n] = (yq_port, mu)

    if ftype == FRAME_I:
        pred = skip = torch.zeros_like(x)
        sc = None
    else:
        p4 = to_444(prev)
        n4 = to_444(nxt) if nxt is not None else torch.zeros_like(p4)
        code("mofnet", torch.cat([x, p4, n4], 1))
        yq, mu = syms["mofnet"]
        m = net.synthesize("mofnet", yq, mu, torch.cat([p4, n4], 1)
                           if ftype == FRAME_B else None, ftype, idx_rate)
        alpha, beta, vp, vn = net.maps(m, ftype)
        out["maps"] = fdiff(port["maps"], torch.cat([alpha, beta, vp, vn], 1))
        # The warp on the program's own maps, so K3 is judged alone.
        pm = port["maps"]
        xw = warp(p4, pm[:, 2], pm[:, 3])
        if ftype == FRAME_B:
            xw = pm[:, 1:2] * xw + (1 - pm[:, 1:2]) * warp(n4, pm[:, 4],
                                                           pm[:, 5])
        out["warp"] = fdiff(port["pred"], pm[:, 0:1] * xw)
        pred, skip = pm[:, 0:1] * xw, (1 - pm[:, 0:1]) * xw
        sc = pred
    code("codecnet", torch.cat([x, pred], 1))
    yq, mu = syms["codecnet"]
    x_hat = net.synthesize("codecnet", yq, mu, sc, ftype, idx_rate) + skip
    out["synth"] = fdiff(port["synth"], x_hat)
    mine = apply_dc(cast_planes(x_hat, orig["y"].shape[1],
                                orig["y"].shape[2]), port["dc"].int())
    out["recon"] = sum(ndiff(port[k], mine[k]) for k in ("y", "u", "v"))
    return out


ORDER = ["mofnet.y", "mofnet.z", "mofnet.z_sym", "mofnet.r",
         "mofnet.y_sym", "maps", "warp", "codecnet.y", "codecnet.z",
         "codecnet.z_sym", "codecnet.r", "codecnet.y_sym", "synth", "recon"]
INTEGER = {"mofnet.z_sym", "mofnet.y_sym", "codecnet.z_sym",
           "codecnet.y_sym", "recon"}


@torch.no_grad()
def diagnose(root: Path, config: Dict, traffic: Dict, clip, specs: Dict,
             waves_idx: List[List[int]], device, weights_dir: Path) -> Dict:
    """The program encodes ``clip`` with its stages recorded, then the
    reference runs each frame on the program's inputs and every stage is
    compared (``stages``); then the reference codes the clip alone, closed
    loop.  -> {"decode_bit_exact", "first_part", "frames",
    "closed_loop"}."""
    dev = torch.device(device)
    sys_ = system(root, config, traffic, dev, weights_dir)
    res, waves = record_encode(sys_, clip.frames)
    enc = {j: res.decoded_frames[j].planes for j in res.decoded_frames}
    dec = sys_.decode(res.bitstream)
    bit_exact = all(np.array_equal(enc[j][k], dec[j][k])
                    for j in enc for k in ("y", "u", "v"))
    del sys_, res
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    def pt(p):
        return {k: torch.from_numpy(np.ascontiguousarray(p[k]))[None].to(dev)
                for k in ("y", "u", "v")}

    idx_rate = float(traffic["idx_rate"])
    rows, first = [], None
    with arithmetic("f32"):
        net = RefNet(read_params(weights_dir), config["model"], dev, "f32")
        for wave, w in zip(waves_idx, waves):
            for r, j in enumerate(wave):
                s = specs[j]
                port = {k: v[r:r + 1] for k, v in w.items() if v is not None}
                orig = {k: torch.from_numpy(clip.planes[k][j:j + 1]).to(dev)
                        for k in ("y", "u", "v")}
                st = stages(net, port, orig,
                            None if s["prev"] is None else pt(enc[s["prev"]]),
                            None if s["next"] is None else pt(enc[s["next"]]),
                            s["type"], idx_rate)
                rows.append({"frame": j, "type": "IPB"[s["type"]], **st})
                if first is None:
                    for k in ORDER:
                        if k in INTEGER and st.get(k, 0):
                            first = {"frame": j, "type": "IPB"[s["type"]],
                                     "stage": k, "count": st[k],
                                     "figures": st}
                            break
        # The reference alone, closed loop, against the program's frames.
        own, drift = {}, []
        for wave in waves_idx:
            for j in wave:
                s = specs[j]
                orig = {k: torch.from_numpy(clip.planes[k][j:j + 1]).to(dev)
                        for k in ("y", "u", "v")}
                o = encode_frame(net, orig, own.get(s["prev"]),
                                 own.get(s["next"]), s["type"], idx_rate)
                own[j] = apply_dc(o["pre_dc"], o["dc"])
                gap = sum(float((own[j][k].int() - pt(enc[j])[k].int())
                                .abs().sum()) for k in ("y", "u", "v"))
                n = sum(own[j][k].numel() for k in ("y", "u", "v"))
                drift.append({"frame": j, "type": "IPB"[s["type"]],
                              "mean_abs_levels": gap / n})
    return {"decode_bit_exact": bit_exact, "first_part": first,
            "frames": rows, "closed_loop": drift}
