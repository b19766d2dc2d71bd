"""The readings a cell's correctness limits are set from, beside the
sound runs' own (each run prints its numbers): the control and the
planted faults, at the cell's own size.

    python3 codecbench/control.py --workload r5.ra1080 --seeds 11 12 13 \
        [--fault token|unchanged|half_batch] [--seconds 2]

Without ``--fault``: the control, the ``control`` of the configuration's
architecture (``architectures/<name>.py``).  The reference stands in for
the program in the precision below the one the configuration states
(for AIVC: TF32 for float32, float8 e4m3 convolutions for bfloat16),
codes the clips that a run of the seed judges, closed loop on its own
reconstructions, and the float32 reference judges it as it judges the
program.  With ``--fault``: a run of the cell with the fault planted in
the program (harness/faults.py) and a short window.  Either way each
seed is judged by the cell's own limits (``limits/<cell>.json``) as a
run is: the numbers beside their limits on standard error, then one JSON
line with ``correct``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))
sys.path.append(str(ROOT))

from harness import weights  # noqa: E402
from harness.bench import make_clips, print_checks, run, verdict  # noqa: E402
from harness.faults import FAULTS, plant  # noqa: E402
from harness.manifest import Manifest  # noqa: E402
from harness.system import clip_specs  # noqa: E402


def gop_name(traffic) -> str:
    from aivc_tpu_torch.config import CodingConfig
    return CodingConfig(coding_config=traffic["coding"],
                        gop_size=traffic["gop_size"],
                        intra_period=traffic["intra_period"]
                        ).gop_struct_name()


@torch.no_grad()
def control(workload: str, seed: int, device, root: Path = ROOT,
            precision: str = None) -> dict:
    """The control of one seed, judged by the cell's limits.
    ``precision`` defaults to the one below the configuration's."""
    man = Manifest(root)
    cell = man.workload(workload)
    config, traffic = man.config(cell["config"]), man.traffic(cell["traffic"])
    arch = man.architecture(config)
    clips, _ = make_clips(traffic, seed, device)
    judged = clips[:traffic["check_within"]]
    specs, waves = clip_specs(gop_name(traffic), traffic["wave_batch"],
                              traffic["frames"])
    with weights.prepared(root, config, arch, device) as weights_dir:
        precision, tally = arch.control(weights_dir, config, traffic, judged,
                                        waves, specs, device, precision)
    # The control decodes by construction what it encoded.
    numbers = {"decode_vs_encoder_px": 0.0, **tally.numbers()}
    checks, correct = verdict(numbers, man.limits(workload))
    return {"workload": workload, "seed": seed, "control": precision,
            "clips": [c.family for c in judged], "correct": correct, "numbers": numbers,
            "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", choices=FAULTS)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for seed in args.seeds:
        t0 = time.perf_counter()
        if args.fault is None:
            res = control(args.workload, seed, torch.device(args.device))
            print_checks(res["checks"])
            sys.stderr.flush()
            print(json.dumps(res), flush=True)
            continue
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "fault": args.fault}), flush=True)
        run(["--workload", args.workload, "--seed", str(seed), "--seconds",
             str(args.seconds), "--trace", "0"], ROOT, t0,
            device=args.device, require_card=args.device == "cuda",
            break_system=plant(args.fault))
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
