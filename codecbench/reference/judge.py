"""The comparison that decides ``correct``: frames coded by a candidate
(the program, or the reference itself in a lower precision as the
control) judged against the float32 reference.

For each frame the reference analyses the original frame against the
candidate's decoded references, takes the hyper-latents the candidate
coded to set mu, and then:

* ``latent_excess``: the most by which a coded symbol lies farther than
  half a step from the reference's unrounded latent (z, and y - mu), over
  both nets, clipped to the alphabet first: 0 where every symbol is a
  rounding of the reference's value, about 1 for a symbol off by one.
* ``latent_mismatch``: the share of coded symbols that differ from the
  reference's own rounding.
* ``recon_gap``: the mean absolute difference, in 8-bit levels over the
  three planes, between the candidate's decoded frame and the
  reference's synthesis of the candidate's symbols with the candidate's
  DC offsets; the worst frame.
* ``dc_gap``: the most by which a DC offset the candidate coded differs
  from the one the reference measures on its own synthesis.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from .net import FRAME_I, RefNet, apply_dc, encode_frame

NETS = ("mofnet", "codecnet")


class Tally:
    """Worst-case accumulation over the frames of a run."""

    def __init__(self):
        self.excess = 0.0
        self.mismatch = 0
        self.symbols = 0
        self.recon_gap = 0.0
        self.dc_gap = 0
        self.frames = 0

    def numbers(self) -> Dict[str, float]:
        return {"latent_excess": self.excess,
                "latent_mismatch": self.mismatch / max(self.symbols, 1),
                "recon_gap": self.recon_gap, "dc_gap": float(self.dc_gap),
                "frames_judged": float(self.frames)}


def _latents(net: RefNet, tally: Tally, unrounded, symbols) -> None:
    acv = net.ac_max
    v = torch.clamp(unrounded, -acv, acv - 1)
    ex = float(torch.clamp((symbols - v).abs() - 0.5, min=0.0).max())
    tally.excess = max(tally.excess, ex)
    tally.mismatch += int((symbols != net.quantize(unrounded)).sum())
    tally.symbols += symbols.numel()


@torch.no_grad()
def judge_frame(net: RefNet, tally: Tally, orig, prev, nxt, frame_type: int,
                idx_rate: float, cand: Dict) -> None:
    """``cand``: {"z": {net: symbols}, "y": {net: symbols} (float NCHW
    [1, ...]), "dc": int32 [1, 3], "planes": uint8 planes [1, ...]}, the
    frame as the candidate coded and decoded it."""
    nets = ("codecnet",) if frame_type == FRAME_I else NETS
    ref = encode_frame(net, orig, prev, nxt, frame_type, idx_rate,
                       z_syms=cand["z"], y_syms=cand["y"])
    for n in nets:
        _latents(net, tally, ref[n]["z"], cand["z"][n])
        _latents(net, tally, ref[n]["r"], cand["y"][n])
    mine = apply_dc(ref["pre_dc"], cand["dc"])
    diff = sum(float((cand["planes"][k].to(torch.int32)
                      - mine[k].to(torch.int32)).abs().sum())
               for k in ("y", "u", "v"))
    n_px = sum(mine[k].numel() for k in ("y", "u", "v"))
    tally.recon_gap = max(tally.recon_gap, diff / n_px)
    tally.dc_gap = max(tally.dc_gap,
                       int((cand["dc"] - ref["dc"]).abs().max()))
    tally.frames += 1


@torch.no_grad()
def control_frame(net: RefNet, orig, prev, nxt, frame_type: int,
                  idx_rate: float) -> Dict:
    """The reference in ``net``'s precision standing in for the program:
    a frame coded with its own roundings, as ``judge_frame`` takes it."""
    out = encode_frame(net, orig, prev, nxt, frame_type, idx_rate)
    nets: List[str] = ["codecnet"] if frame_type == FRAME_I else list(NETS)
    return {"z": {n: out[n]["zq"] for n in nets},
            "y": {n: out[n]["yq"] for n in nets},
            "dc": out["dc"], "planes": apply_dc(out["pre_dc"], out["dc"])}
