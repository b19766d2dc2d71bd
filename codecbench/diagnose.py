"""Where the program and the reference part, frame by frame and stage by
stage, for one clip of a cell (the tool that reads an
``outputs_incorrect``).

    python3 codecbench/diagnose.py --workload f32.ra1080 --seed 274634358 \
        [--out chiprun_out/diagnose.json]

The clip is the one the cell's check takes at that seed; the
configuration's architecture (``architectures/<name>.py``, its
``diagnose``) does the rest.  For AIVC the program encodes the clip (its
stages recorded on the codec instance); then the reference runs each
frame in coding order on the program's own inputs (the original frame
and the program's decoded references), and at every stage the program's
values are compared with the reference's:

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

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))
sys.path.append(str(ROOT))

from control import gop_name  # noqa: E402
from harness import weights  # noqa: E402
from harness.bench import make_clips  # noqa: E402
from harness.manifest import Manifest  # noqa: E402
from harness.system import clip_specs  # noqa: E402


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
    arch = man.architecture(config)
    t0 = time.perf_counter()
    clips, check_at = make_clips(traffic, args.seed, dev)
    clip = clips[check_at]
    specs, waves = clip_specs(gop_name(traffic), traffic["wave_batch"],
                              traffic["frames"])
    with weights.prepared(ROOT, config, arch, dev) as weights_dir:
        found = arch.diagnose(ROOT, config, traffic, clip, specs, waves, dev,
                              weights_dir)
    bit_exact, first = found["decode_bit_exact"], found["first_part"]
    rows, drift = found["frames"], found["closed_loop"]
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
