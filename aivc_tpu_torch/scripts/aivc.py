"""The pipeline as separate OS processes: encode, decode, evaluate (the
port of scripts/aivc.py).

The reference's real-life demonstration is this process separation:
encoder and decoder share only the bitstream file, the model name and
the configuration (reference: src/aivc.py:117-139 spawns encode.py /
decode.py / evaluate.py).  Each stage is ``python -m aivc_tpu_torch
--mode <stage>`` with the caller's flags; the first stage that fails
ends the run with its exit code.  The stages run in the caller's working
directory (the JAX script moves them to the checkout's root), so
relative paths mean what the caller meant; the port is found through
PYTHONPATH.

    python -m aivc_tpu_torch.scripts.aivc -i in_416x240_50_420.yuv \\
        -o out.yuv --bitstream_out video.bin --coding_config RA \\
        --gop_size 16 --intra_period 32 --model models_ckpt/bf16-r5 \\
        [--cpu] [--bitstream_debug]

The stages run on the card unless ``--cpu`` is given; with no card and
no ``--cpu`` the encode stage exits 2, and so does this script.
"""

from __future__ import annotations

import subprocess
import sys

from aivc_tpu_torch.scripts import child_env

STAGES = ("encode", "decode", "evaluate")


def run_stage(mode: str, argv) -> int:
    cmd = [sys.executable, "-m", "aivc_tpu_torch", "--mode", mode] + list(argv)
    print(f"[aivc] running {mode}: {' '.join(cmd[3:])}", flush=True)
    return subprocess.call(cmd, env=child_env())


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    for mode in STAGES:
        rc = run_stage(mode, argv)
        if rc != 0:
            print(f"[aivc] stage {mode} failed with {rc}", file=sys.stderr)
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
