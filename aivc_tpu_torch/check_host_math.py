"""The first call of torch.sqrt in fresh processes, with and without the
port's settling of the host's vector math (device.settle_host_math).

    python -m aivc_tpu_torch.check_host_math [--procs 600] [--parallel 6]

Starts ``--procs`` fresh Python processes, ``--parallel`` at a time: half
import only torch ("cold"), half import aivc_tpu_torch first
("settled").  Each limits PyTorch to 2 threads, takes the square root of
the same 122,880 float32 values once, and counts the values more than
1e-6 relative from the exact root (a correct one is within 6e-8), and
whether a second call gets them right.  The fault shows only with the
host's cores busy, so run it beside other work (a test run, say).
Prints one JSON line: per variant, the processes run and those whose
first call was wrong.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

CHILD = """
import sys
import numpy as np
import torch
if sys.argv[1] == "settled":
    import aivc_tpu_torch  # noqa: F401  (settles the vector math)
torch.set_num_threads(2)
a = np.random.default_rng(0).uniform(0.5, 40.0, (1, 128, 24, 40))
a = a.astype(np.float32)
exact = np.sqrt(a.astype(np.float64))
t = torch.from_numpy(a)
first = np.abs(torch.sqrt(t).numpy() / exact - 1)
second = np.abs(torch.sqrt(t).numpy() / exact - 1)
print(int((first > 1e-6).sum()), int((second > 1e-6).sum()),
      float(first.max()))
"""


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--procs", type=int, default=600)
    p.add_argument("--parallel", type=int, default=6)
    args = p.parse_args(argv)
    root = Path(__file__).resolve().parents[1]
    stats = {v: {"procs": 0, "wrong_first": 0, "wrong_second": 0,
                 "max_rel_err": 0.0} for v in ("cold", "settled")}
    variants = ["cold", "settled"] * (args.procs // 2)
    for start in range(0, len(variants), args.parallel):
        batch = variants[start:start + args.parallel]
        procs = [subprocess.Popen([sys.executable, "-c", CHILD, v],
                                  cwd=root, stdout=subprocess.PIPE,
                                  stderr=subprocess.DEVNULL, text=True)
                 for v in batch]
        for v, proc in zip(batch, procs):
            out, _ = proc.communicate(timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(f"a {v} process exited "
                                   f"{proc.returncode}")
            n1, n2, err = out.split()
            s = stats[v]
            s["procs"] += 1
            s["wrong_first"] += int(n1) > 0
            s["wrong_second"] += int(n2) > 0
            s["max_rel_err"] = max(s["max_rel_err"], float(err))
    print(json.dumps(stats))
    return 0


if __name__ == "__main__":
    sys.exit(main())
