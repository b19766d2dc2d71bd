"""Where the program and the reference part, frame by frame and stage by
stage, for one clip of a cell (the tool that reads an
``outputs_incorrect``).

    python3 codecbench/diagnose.py --workload f32.ra1080 --seed 274634358 \
        [--out chiprun_out/diagnose.json]

The clip is the one the cell's check takes at that seed.  The program
encodes it (its stages recorded on the codec instance); then the
reference runs each frame in coding order on the program's own inputs
(the original frame and the program's decoded references), and at every
stage the program's values are compared with the reference's:

  mofnet / codecnet: ``y`` (analysis, gained), ``z`` (hyper-analysis
  before rounding), ``z_sym`` and ``y_sym`` (the rounded latents the
  stream carries: the count that differ), ``r`` (y - mu before
  rounding);  ``maps`` (MOFNet's synthesis: masks and flows),
  ``warp`` (K3's prediction, pred), ``synth`` (the frame before the
  cast), ``recon`` (the uint8 frame that becomes the next reference:
  the pixels that differ).

After a rounded latent differs, the later stages are computed from the
program's symbols, so each stage is judged on like inputs.  It then
codes the clip with the reference alone, closed loop (its own
reconstructions as references), and prints how far that reconstruction
drifts from the program's, frame by frame: what a check that is not
built on the program's own state reads.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))
sys.path.append(str(ROOT))

from harness.bench import make_clips  # noqa: E402
from harness.manifest import Manifest  # noqa: E402
from harness.system import System  # noqa: E402
from reference.msgpack import read_params  # noqa: E402
from reference.net import (FRAME_B, FRAME_I, RefNet, apply_dc,  # noqa: E402
                           arithmetic, cast_planes, encode_frame, to_444,
                           warp)

NETS = ("mofnet", "codecnet")


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    man = Manifest(ROOT)
    cell = man.workload(args.workload)
    config, traffic = man.config(cell["config"]), man.traffic(cell["traffic"])
    t0 = time.perf_counter()
    system = System(ROOT, config, traffic, dev)
    clips, check_at = make_clips(traffic, args.seed, dev)
    clip = clips[check_at]
    specs, waves_idx = system.clip_specs(traffic["frames"])
    res, waves = record_encode(system, clip.frames)
    enc = {j: res.decoded_frames[j].planes for j in res.decoded_frames}
    dec = system.decode(res.bitstream)
    bit_exact = all(np.array_equal(enc[j][k], dec[j][k])
                    for j in enc for k in ("y", "u", "v"))
    del system, res
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    def pt(p):
        return {k: torch.from_numpy(np.ascontiguousarray(p[k]))[None].to(dev)
                for k in ("y", "u", "v")}

    idx_rate = float(traffic["idx_rate"])
    rows, first = [], None
    with arithmetic("f32"):
        net = RefNet(read_params(ROOT / config["checkpoint"]),
                     config["model"], dev, "f32")
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
    report = {"workload": args.workload, "seed": args.seed,
              "clip": clip.family, "decode_bit_exact": bit_exact,
              "first_part": first, "frames": rows, "closed_loop": drift,
              "seconds": time.perf_counter() - t0}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps({k: report[k] for k in ("workload", "seed", "clip",
                                             "decode_bit_exact",
                                             "seconds")}))
    print("first part:", json.dumps(first))
    for r in rows:
        print(json.dumps({k: (v if not isinstance(v, dict) else
                              round(v["max_abs"], 9)) for k, v in r.items()}))
    print("closed loop, reference alone vs the program, mean |levels|:",
          json.dumps([[d["frame"], d["type"], round(d["mean_abs_levels"], 5)]
                      for d in drift]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
