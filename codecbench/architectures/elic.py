"""ELIC as the program runs it: ``aivc_tpu_torch``'s Elic model
(models/elic.py; He et al., CVPR 2022, arXiv 2203.10886) under
ElicCodec (pipeline/elic.py), FrameCodec's All-Intra subclass.  A
configuration names it with ``"architecture": "elic"`` and holds the
program's ElicConfig under ``"model"``; with seeded weights, the gain of
g_a's last convolution under ``"init": {"g_a_gain": g}``.

What every architecture provides (see architectures/aivc.py): ``system``,
``capture_decode``, ``judge``, ``control``, ``frame_flops``,
``init_tree``; and ``fault`` for the tools.

The judge (reference/elic.py, plain float32): per frame the reference
analyses the original, takes z from the stream's symbols and runs the
ten context steps on the stream's symbols, so each step's mu and sigma
are the reference's for what the decoder had.  Its tally holds
``latent_excess``, ``latent_mismatch``, ``recon_gap``, ``dc_gap`` and
``frames_judged`` as AIVC's (reference/judge.py), and
``scale_mismatch``: the share of coded y symbols whose sigma bin differs
from the reference's by more than one bin (a wrong scale path, which
the symbols alone cannot show).

``system`` wraps the codec's per-step calls (``_encode_step``,
``_decode_step``) in host spans named ``ctx`` (harness/trace.py's prefix),
so traced runs carry them for ``ctx_ms.encode`` / ``ctx_ms.decode``.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch
import torch.profiler

from harness.system import System
from harness.trace import SPAN_PREFIX
from reference.elic import RefElic, apply_dc, arithmetic, code_frame
from reference.msgpack import read_params

# The reference's precision below each configuration's.
LOWER = {"float32": "tf32", "bfloat16": "fp8"}


# ---------------------------------------------------------------------------
# The system under test
# ---------------------------------------------------------------------------

def ctx_spans(codec) -> None:
    """Host spans ``ctx`` around each context step of the encode and the
    decode, set on the instance."""
    for method in ("_encode_step", "_decode_step"):
        inner = getattr(codec, method)

        def wrapped(*a, _inner=inner, **kw):
            with torch.profiler.record_function(SPAN_PREFIX + "ctx"):
                return _inner(*a, **kw)
        setattr(codec, method, wrapped)


def system(root: Path, config: dict, traffic: dict, device,
           weights_dir: Path) -> System:
    """One ElicCodec for the cell's frame size from the parameters in
    ``weights_dir`` (their ``config.json`` selects the model)."""
    from aivc_tpu_torch.pipeline.codec import make_codec
    from aivc_tpu_torch.utils.checkpoint import model_from_params, read_tree

    device = torch.device(device)
    cfg, tree = read_tree(weights_dir)
    codec = make_codec(cfg, model_from_params(cfg, tree, device),
                       traffic["height"], traffic["width"], device=device)
    ctx_spans(codec)
    return System(codec, traffic, device)


def capture_decode(system: System, stream: bytes):
    """Decode ``stream`` with the symbols each batch reads recorded: per
    decode batch, in call order, the frame type, the z symbols ("z"),
    per context step the symbols and the sigma bins over the group's map
    ("steps": [(q, bins)], zero off the step's positions) and the DC
    offsets ("dc").  -> (decoded planes, batches)."""
    codec = system.codec
    batches: List[dict] = []
    pending: Dict = {}

    def on_batch(fb, *a, **kw):
        batches.append({"type": a[2], "steps": []})

    def on_z(out):
        batches[-1]["z"] = out[0].detach().clone()

    def on_params(out):
        pending["bins"] = out[1].detach().clone()

    def on_scatter(out):
        batches[-1]["steps"].append((out.detach().clone(), pending["bins"]))

    before = [(codec, "decode_frames_batch", on_batch)]
    after = [(codec, "_dec_z", on_z), (codec, "_step_params", on_params),
             (codec, "_scatter", on_scatter)]
    for obj, name, see in before:
        inner = getattr(obj, name)

        def wrapped(*a, _inner=inner, _see=see, **kw):
            _see(*a, **kw)
            return _inner(*a, **kw)
        setattr(obj, name, wrapped)
    for obj, name, see in after:
        inner = getattr(obj, name)

        def wrapped(*a, _inner=inner, _see=see, **kw):
            out = _inner(*a, **kw)
            _see(out)
            return out
        setattr(obj, name, wrapped)
    inner_dc = codec._apply_dc

    def apply_dc_(out, dc):
        batches[-1]["dc"] = dc.detach().clone()
        return inner_dc(out, dc)
    codec._apply_dc = apply_dc_
    try:
        planes = system.decode(stream)
    finally:
        for obj, name, _ in before + after:
            obj.__dict__.pop(name, None)
        codec.__dict__.pop("_apply_dc", None)
    return planes, batches


# ---------------------------------------------------------------------------
# Correctness: the judge and the control
# ---------------------------------------------------------------------------

class Tally:
    """Worst-case accumulation over the frames of a run."""

    def __init__(self):
        self.excess = 0.0
        self.mismatch = 0
        self.symbols = 0
        self.scale_off = 0
        self.y_symbols = 0
        self.recon_gap = 0.0
        self.dc_gap = 0
        self.frames = 0

    def numbers(self) -> Dict[str, float]:
        return {"latent_excess": self.excess,
                "latent_mismatch": self.mismatch / max(self.symbols, 1),
                "recon_gap": self.recon_gap, "dc_gap": float(self.dc_gap),
                "scale_mismatch": self.scale_off / max(self.y_symbols, 1),
                "frames_judged": float(self.frames)}

    def latents(self, net: RefElic, unrounded, symbols) -> None:
        acv = net.ac_max
        v = torch.clamp(unrounded, -acv, acv - 1)
        if symbols.numel():
            ex = float(torch.clamp((symbols - v).abs() - 0.5, min=0.0).max())
            self.excess = max(self.excess, ex)
        self.mismatch += int((symbols != net.quantize(unrounded)).sum())
        self.symbols += symbols.numel()


@torch.no_grad()
def judge_frame(net: RefElic, tally: Tally, orig, cand: Dict) -> None:
    """``cand``: {"z": symbols [1, N, hz, wz], "steps": per step (symbols,
    sigma bins) over the group's map [1, g, hy, wy], "dc": int32 [1, 3],
    "planes": uint8 planes [1, ...]}, the frame as the candidate coded
    and decoded it."""
    ref = code_frame(net, orig, z_syms=cand["z"],
                     step_syms=[q for q, _ in cand["steps"]])
    tally.latents(net, ref["z"], cand["z"])
    for step, (q, bins) in zip(ref["steps"], cand["steps"]):
        sel = step["mask"]
        tally.latents(net, step["r"][..., sel], q[..., sel])
        off = (bins[..., sel].long() - step["bins"][..., sel].long()).abs()
        tally.scale_off += int((off > 1).sum())
        tally.y_symbols += off.numel()
    mine = apply_dc(ref["pre_dc"], cand["dc"])
    diff = sum(float((cand["planes"][k].to(torch.int32)
                      - mine[k].to(torch.int32)).abs().sum())
               for k in ("y", "u", "v"))
    n_px = sum(mine[k].numel() for k in ("y", "u", "v"))
    tally.recon_gap = max(tally.recon_gap, diff / n_px)
    tally.dc_gap = max(tally.dc_gap,
                       int((cand["dc"] - ref["dc"]).abs().max()))
    tally.frames += 1


def _orig(clip, j, device):
    return {c: torch.from_numpy(clip.planes[c][j:j + 1]).to(device)
            for c in ("y", "u", "v")}


def judge(weights_dir: Path, config: Dict, traffic: Dict,
          kept: Dict[int, Dict], waves: List[List[int]], specs: Dict,
          device) -> Tally:
    """The reference's judgement of the judged clips, frame by frame."""
    def planes_t(p):
        return {k: torch.from_numpy(np.ascontiguousarray(p[k]))[None]
                .to(device) for k in ("y", "u", "v")}

    tally = Tally()
    net = RefElic(read_params(weights_dir), config["model"], device, "f32")
    for k in kept.values():
        clip, dec = k["clip"], k["decoded"]
        for wave, b in zip(waves, k["batches"]):
            for r, j in enumerate(wave):
                one = slice(r, r + 1)
                cand = {"z": b["z"][one].to(device).float(),
                        "steps": [(q[one].to(device).float(),
                                   bins[one].to(device))
                                  for q, bins in b["steps"]],
                        "dc": (b["dc"][one].to(device) if "dc" in b
                               else torch.zeros((1, 3), dtype=torch.int32,
                                                device=device)),
                        "planes": planes_t(dec[j])}
                judge_frame(net, tally, _orig(clip, j, device), cand)
    return tally


@torch.no_grad()
def control(weights_dir: Path, config: Dict, traffic: Dict, clips,
            waves: List[List[int]], specs: Dict, device,
            precision: str = None) -> tuple:
    """The reference in ``precision`` (default: ``LOWER`` of the
    configuration's) standing in for the program: it codes each frame of
    ``clips`` with its own roundings, and the float32 reference judges it
    as it judges the program's.  -> (precision, Tally)."""
    precision = precision or LOWER[config["peak_dtype"]]
    tree = read_params(weights_dir)
    ref = RefElic(tree, config["model"], device, "f32")
    low = RefElic(tree, config["model"], device, precision)
    tally = Tally()
    for clip in clips:
        for wave in waves:
            for j in wave:
                orig = _orig(clip, j, device)
                out = code_frame(low, orig)
                cand = {"z": out["zq"],
                        "steps": [(s["q"], s["bins"]) for s in out["steps"]],
                        "dc": out["dc"],
                        "planes": apply_dc(out["pre_dc"], out["dc"])}
                with arithmetic("f32"):
                    judge_frame(ref, tally, orig, cand)
    return precision, tally


# ---------------------------------------------------------------------------
# Planted faults
# ---------------------------------------------------------------------------

def fault(name: str, system: System) -> None:
    """Break ``system`` in place, in its encoder and decoder alike:
    ``nospatial`` (the non-anchors coded without the spatial context),
    ``token`` (the first channel's symbol at the first anchor of every
    group altered by +3 where the encoder rounds it) or ``unchanged``
    (the synthesis returns a black frame)."""
    codec = system.codec
    model = codec.model
    if name == "nospatial":
        inner_sc = model.spatial_context
        model.spatial_context = lambda k, anchors: torch.zeros_like(
            inner_sc(k, anchors))
    elif name == "token":
        inner = codec._quantize_y

        def altered(y, mu):
            q = inner(y, mu).clone()
            q[:, 0, 0, 0] = torch.clamp(q[:, 0, 0, 0] + 3,
                                        max=codec.ac_max - 1)
            return q
        codec._quantize_y = altered
    elif name == "unchanged":
        model.synthesize = lambda y_hat: torch.zeros(
            (y_hat.shape[0], 3, 16 * y_hat.shape[2], 16 * y_hat.shape[3]),
            device=y_hat.device)
    else:
        raise KeyError(f"no fault {name!r} in the elic architecture")


# ---------------------------------------------------------------------------
# FLOPs
# ---------------------------------------------------------------------------
#
# Frozen count of a frame's model FLOPs: two operations per multiply-add
# of every convolution as it runs, elementwise work left out, as
# ``torch.utils.flop_counter`` counts them (a transposed convolution by
# its input pixels; the masked spatial context as the whole 5x5 conv; the
# context nets over the group's whole map in each pass).  The frame is
# padded to a multiple of 64 first, as the codec pads it.
#
# ``part="encode"``: g_a, h_a, h_s, the ten context steps, g_s (the
# encoder's reconstruction); ``part="decode"``: h_s, the steps, g_s.

PAD = 64
SCALE_GAIN_KEY = "g_a_gain"


def _conv(cin, cout, k, px):
    return 2 * cin * cout * k * k * px


def _bottleneck(c, px):
    h = c // 2
    return _conv(c, h, 1, px) + _conv(h, h, 3, px) + _conv(h, c, 1, px)


def _attention(c, px):
    return 6 * _bottleneck(c, px) + _conv(c, c, 1, px)


def _parts(model: Dict, h: int, w: int) -> Dict[str, int]:
    """FLOPs of each stage of a frame padded to h x w."""
    n, m = model["n"], model["m"]
    px = [(h >> i) * (w >> i) for i in range(7)]
    g_a = (_conv(3, n, 5, px[1]) + 3 * _bottleneck(n, px[1])
           + _conv(n, n, 5, px[2]) + 3 * _bottleneck(n, px[2])
           + _attention(n, px[2]) + _conv(n, n, 5, px[3])
           + 3 * _bottleneck(n, px[3]) + _conv(n, m, 5, px[4])
           + _attention(m, px[4]))
    g_s = (_attention(m, px[4]) + _conv(m, n, 5, px[4])
           + 3 * _bottleneck(n, px[3]) + _conv(n, n, 5, px[3])
           + _attention(n, px[2]) + 3 * _bottleneck(n, px[2])
           + _conv(n, n, 5, px[2]) + 3 * _bottleneck(n, px[1])
           + _conv(n, 3, 5, px[1]))
    h_a = (_conv(m, n, 3, px[4]) + _conv(n, n, 5, px[5])
           + _conv(n, n, 5, px[6]))
    h_s = (_conv(n, n, 5, px[6]) + _conv(n, 3 * n // 2, 5, px[5])
           + _conv(3 * n // 2, 2 * m, 3, px[4]))
    ch, cc = model["ctx_hidden"]
    ah, ao = model["agg_hidden"]
    ctx, done = 0, 0
    for k, g in enumerate(model["groups"]):
        if k:
            ctx += (_conv(done, ch, 5, px[4]) + _conv(ch, cc, 5, px[4])
                    + _conv(cc, 2 * g, 5, px[4]))
        ctx += _conv(g, 2 * g, 5, px[4])
        cin = 2 * m + 2 * g * (2 if k else 1)
        ctx += 2 * (_conv(cin, ah, 1, px[4]) + _conv(ah, ao, 1, px[4])
                    + _conv(ao, 2 * g, 1, px[4]))
        done += g
    return {"g_a": g_a, "g_s": g_s, "h_a": h_a, "h_s": h_s, "ctx": ctx}


def frame_flops(model: Dict, frame_type: int, height: int, width: int,
                part: str = "encode") -> int:
    """Model FLOPs of one frame at height x width (every frame of the
    intra-only model is an intra frame, whatever ``frame_type``)."""
    if part not in ("encode", "decode"):
        raise ValueError(f"unknown part {part!r}")
    f = _parts(model, -(-height // PAD) * PAD, -(-width // PAD) * PAD)
    out = f["h_s"] + f["ctx"] + f["g_s"]
    if part == "encode":
        out += f["g_a"] + f["h_a"]
    return out


# ---------------------------------------------------------------------------
# Seeded parameters
# ---------------------------------------------------------------------------

LECUN_TRUNC = 0.87962566103423978   # std of a unit normal cut at +-2
PRIOR_FILTERS = (1, 3, 3, 3, 1)


def layout(model: Dict) -> Dict[tuple, tuple]:
    """{path: (shape, kind)} of every leaf of an Elic parameter tree:
    conv and transposed-conv kernels HWIO ("conv", "tconv"), biases
    ("zero"), the factorized prior's leaves ("prior")."""
    n, m = model["n"], model["m"]
    out: Dict[tuple, tuple] = {}

    def conv(path, k, cin, cout, kind="conv"):
        out[path + ("kernel",)] = ((k, k, cin, cout), kind)
        out[path + ("bias",)] = ((cout,), "zero")

    def bottleneck(path, c):
        conv(path + ("a",), 1, c, c // 2)
        conv(path + ("b",), 3, c // 2, c // 2)
        conv(path + ("c",), 1, c // 2, c)

    def attention(path, c):
        for i in range(3):
            bottleneck(path + (f"trunk_{i}",), c)
            bottleneck(path + (f"branch_{i}",), c)
        conv(path + ("gate",), 1, c, c)

    for i, (cin, cout) in enumerate(((3, n), (n, n), (n, n), (n, m))):
        conv(("g_a", f"conv_{i}"), 5, cin, cout)
    for i in range(9):
        bottleneck(("g_a", f"res_{i}"), n)
        bottleneck(("g_s", f"res_{i}"), n)
    attention(("g_a", "att_0"), n)
    attention(("g_a", "att_1"), m)
    attention(("g_s", "att_0"), m)
    attention(("g_s", "att_1"), n)
    for i, (cin, cout) in enumerate(((m, n), (n, n), (n, n), (n, 3))):
        conv(("g_s", f"up_{i}"), 5, cin, cout, "tconv")
    conv(("h_a", "conv_0"), 3, m, n)
    conv(("h_a", "conv_1"), 5, n, n)
    conv(("h_a", "conv_2"), 5, n, n)
    conv(("h_s", "up_0"), 5, n, n, "tconv")
    conv(("h_s", "up_1"), 5, n, 3 * n // 2, "tconv")
    conv(("h_s", "conv_0"), 3, 3 * n // 2, 2 * m)
    ch, cc = model["ctx_hidden"]
    ah, ao = model["agg_hidden"]
    done = 0
    for k, g in enumerate(model["groups"]):
        grp = (f"group_{k}",)
        if k:
            conv(grp + ("cc", "conv_0"), 5, done, ch)
            conv(grp + ("cc", "conv_1"), 5, ch, cc)
            conv(grp + ("cc", "conv_2"), 5, cc, 2 * g)
        conv(grp + ("sc",), 5, g, 2 * g)
        cin = 2 * m + 2 * g * (2 if k else 1)
        conv(grp + ("pa", "conv_0"), 1, cin, ah)
        conv(grp + ("pa", "conv_1"), 1, ah, ao)
        conv(grp + ("pa", "conv_2"), 1, ao, 2 * g)
        done += g
    f = PRIOR_FILTERS
    for i in range(len(f) - 1):
        out[("pdf_z", f"h{i}")] = ((n, f[i], f[i + 1]), "prior")
        out[("pdf_z", f"b{i}")] = ((n, f[i + 1]), "prior")
        if i < len(f) - 2:
            out[("pdf_z", f"a{i}")] = ((n, f[i + 1]), "prior")
    return out


def init_tree(config: Dict, generator: torch.Generator) -> Dict:
    """A parameter tree for ``config["model"]`` (nested dicts of float32
    numpy arrays, kernels HWIO) drawn from ``generator``, on its device,
    in two calls: one truncated normal for every kernel, one normal for
    every prior leaf, each cut into the leaves in the order of their
    sorted paths.  flax's initialisers, as architectures/aivc.py draws
    them: kernels lecun-normal (std sqrt(1 / fan_in) / 0.8796, cut at two
    stds; fan_in kh * kw * cin for a conv, kh * kw * cin / 4 for a
    transposed conv of stride 2, whose output pixel sums a quarter of the
    taps), biases 0, the prior's leaves normal of std sqrt(2 / (d_in *
    d_out)).  g_a's last kernel is then scaled by
    ``config["init"]["g_a_gain"]``: the latents' spread, and so the
    symbols' and the entropy coder's load."""
    leaves = sorted(layout(config["model"]).items())
    gain = float(config.get("init", {}).get(SCALE_GAIN_KEY, 1.0))
    dev = generator.device

    def draw(kinds, fn):
        n = sum(math.prod(s) for _, (s, k) in leaves if k in kinds)
        flat = torch.empty(n, dtype=torch.float32, device=dev)
        fn(flat)
        return flat.cpu().numpy()

    kern = draw(("conv", "tconv"), lambda t: torch.nn.init.trunc_normal_(
        t, 0.0, 1.0, -2.0, 2.0, generator=generator))
    prior = draw(("prior",), lambda t: t.normal_(generator=generator))
    at = {"kern": 0, "prior": 0}
    tree: Dict = {}
    for path, (shape, kind) in leaves:
        if kind == "zero":
            arr = np.zeros(shape, np.float32)
        else:
            src = "prior" if kind == "prior" else "kern"
            n = math.prod(shape)
            v = (prior if src == "prior" else kern)[at[src]:at[src] + n]
            at[src] += n
            if kind == "prior":
                fan = (shape[1] if path[-1][0] == "h" else 1) * shape[-1]
                std = math.sqrt(2.0 / fan)
            else:
                fan = shape[0] * shape[1] * shape[2]
                fan = fan / 4 if kind == "tconv" else fan
                std = math.sqrt(1.0 / fan) / LECUN_TRUNC
                if path[:2] == ("g_a", "conv_3"):
                    std *= gain
            arr = (v * np.float32(std)).reshape(shape)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = arr
    return tree
