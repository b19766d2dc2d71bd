"""One-time checkpoint surgery: revive a dead motion path (the port of
scripts/reset_flow_head.py).

Checkpoints trained with the reference's unbounded linear flows ended
with every flow element near 1e32: the border-clamped warp has no
gradient outside the frame, so flows that escaped never came back, and
the weights sit too deep in softsign saturation for the bounded maps
(ModelConfig.flow_bound) to recover them.  This tool:

* sets ``flow_bound``, optionally ``ac_max_val``, and both nets'
  ``gdn_clamp`` in the config;
* re-initialises MOFNet's whole synthesis ``mofnet.g_s`` and its
  shortcut encoder ``mofnet.g_a_ref`` (the trunk, not only the head,
  carried the runaway activations), and keeps every other parameter;
* zeroes the 16 flow-head channels g*6 + c (g < 4, 2 <= c < 6: v_prev,
  v_next in the (ry, rx, c) order of depth_to_space2) of
  ``g_s.UpBlock_3.Conv_0``'s kernel and bias, so training restarts from
  the identity warp.

The surgery works on the checkpoint's numpy tree, in flax's layout
(utils/checkpoint.py:read_tree; a torch state_dict permutes the
depth-to-space channels, so its channel indices are other ones), and
writes it back with save_tree.  Stated departure: the JAX script draws
the fresh g_s and g_a_ref from jax.random.PRNGKey(17), which PyTorch
cannot reproduce; here they come from models/zoo.py:init_fullnet (flax's
initialisers as distributions) drawn from torch.Generator seed 17, on
the host, converted with params_to_jax.  Everything not drawn equals the
JAX script's output byte for byte.  Touches no device.

    python -m aivc_tpu_torch.scripts.reset_flow_head \\
        --ckpt models_ckpt/bf16-r3 --out models_ckpt/bf16-r3m \\
        --flow_bound 32 [--ac_max 128]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np

# The fresh draw's seed (the JAX script's PRNGKey).
SEED = 17
RESET = ("g_s", "g_a_ref")


def flow_head_channels(out_c: int) -> list:
    """Output channels of the head conv (JAX order) that carry v_prev and
    v_next: maps channels 2..5 of each of the 4 depth-to-space phases."""
    return [g * out_c + c for g in range(4) for c in range(2, 6)]


def reset_tree(cfg, params):
    """(params with MOFNet's g_s and g_a_ref drawn anew and the flow head
    zeroed, number of channels zeroed, old g_s's largest |w|)."""
    import torch

    from aivc_tpu_torch.models.zoo import init_fullnet
    from aivc_tpu_torch.utils.checkpoint import params_to_jax

    if cfg.mofnet.out_c != 6:
        raise ValueError("MOFNet must output alpha/beta/v_prev/v_next")
    fresh = params_to_jax(init_fullnet(
        cfg, torch.Generator().manual_seed(SEED), device="cpu").state_dict())
    mof = params["params"]["mofnet"]
    mag = float(max(np.abs(v).max() for v in _leaves(mof["g_s"])))
    for name in RESET:
        mof[name] = fresh["params"]["mofnet"][name]
    last = mof["g_s"]["UpBlock_3"]["Conv_0"]
    kern = np.asarray(last["kernel"]).copy()
    bias = np.asarray(last["bias"]).copy()
    v_idx = flow_head_channels(cfg.mofnet.out_c)
    kern[..., v_idx] = 0.0
    bias[v_idx] = 0.0
    last["kernel"], last["bias"] = kern, bias
    return params, len(v_idx), mag


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield np.asarray(v)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m aivc_tpu_torch.scripts.reset_flow_head",
        description="re-initialise MOFNet's synthesis and zero the flow "
                    "head")
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--flow_bound", type=float, default=32.0)
    ap.add_argument("--ac_max", type=int, default=0,
                    help="also set ModelConfig.ac_max_val (0 = leave)")
    ap.add_argument("--gdn_clamp", type=float, default=16.0,
                    help="GDN multiplier clamp for BOTH subnets (healthy "
                         "nets run ~0.8-1.2 so 16 never engages; it only "
                         "removes the runaway amplification fixed point)")
    args = ap.parse_args(argv)

    from aivc_tpu_torch.utils.checkpoint import read_tree, save_tree

    cfg, params = read_tree(args.ckpt)
    changes = {"flow_bound": args.flow_bound}
    if args.ac_max:
        changes["ac_max_val"] = args.ac_max
    cfg = dataclasses.replace(cfg, **changes)
    if args.gdn_clamp:
        cfg = dataclasses.replace(
            cfg,
            mofnet=dataclasses.replace(cfg.mofnet,
                                       gdn_clamp=args.gdn_clamp),
            codecnet=dataclasses.replace(cfg.codecnet,
                                         gdn_clamp=args.gdn_clamp))
        changes["gdn_clamp"] = args.gdn_clamp
    params, n_zeroed, mag = reset_tree(cfg, params)
    save_tree(args.out, cfg, params)
    print(f"reinitialized mofnet g_s (old max |w| {mag:.3g}) and zeroed "
          f"{n_zeroed} flow-head channels; config: {changes} -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
