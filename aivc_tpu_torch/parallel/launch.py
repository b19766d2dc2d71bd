"""Run a function on N ranks, one process each, over torch.distributed.

    results = run_ranks("aivc_tpu_torch.smoke:rank_round_robin", world=2,
                        backend="gloo", workdir=d, kwargs={...})

Each rank is ``python -m aivc_tpu_torch.parallel.launch`` in a
subprocess from the checkout's root: it limits PyTorch to one thread,
starts the process group on the named backend with a file store in a
fresh directory under ``workdir`` (no port to collide on) and a timeout
of ``mesh.COLLECTIVE_TIMEOUT_S`` on every collective, calls
``fn(device=<its device>, **kwargs)`` (the kwargs written once with
torch.save, read by every rank) and saves the return value to its own
file.  Its standard output and error go to
``rank<i>.log`` beside them.  The launcher waits at most ``timeout_s``
for all of them; a rank that fails or does not finish ends the others,
and the launcher raises with the logs' tails.  ``device`` ("cpu") runs
the ranks on the host; by default each takes ``cuda:{rank % cards}``.
"""

from __future__ import annotations

import importlib
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

ROOT = Path(__file__).resolve().parents[2]


def _tail(path: Path, n: int = 3000) -> str:
    return path.read_text(errors="replace")[-n:] if path.exists() else ""


def run_ranks(entry: str, world: int, backend: str, workdir,
              kwargs: Optional[Dict[str, Any]] = None,
              device: Optional[str] = None, timeout_s: float = 60.0
              ) -> List[Any]:
    """``entry`` ("module:function") on ``world`` ranks; returns each
    rank's return value, in rank order."""
    run = Path(tempfile.mkdtemp(prefix="ranks-", dir=workdir))
    torch.save(kwargs or {}, run / "kwargs.pt")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    logs = [run / f"rank{r}.log" for r in range(world)]
    procs = []
    try:
        for r in range(world):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "aivc_tpu_torch.parallel.launch",
                     entry, str(r), str(world), backend, str(run),
                     device or ""],
                    cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout_s
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
    rcs = [p.returncode for p in procs]
    if any(rc != 0 for rc in rcs):
        tails = "\n".join(f"--- rank {r} (rc {rcs[r]}) ---\n{_tail(logs[r])}"
                          for r in range(world))
        raise RuntimeError(f"{entry} on {world} ranks failed or timed out "
                           f"after {timeout_s} s:\n{tails}")
    return [torch.load(run / f"result{r}.pt", weights_only=False)
            for r in range(world)]


def _main(argv: List[str]) -> int:
    entry, rank, world, backend, run, device = argv
    rank, world, run = int(rank), int(world), Path(run)
    torch.set_num_threads(1)
    from aivc_tpu_torch.parallel.mesh import init_distributed

    dev = init_distributed(backend, rank, world, str(run / "store"),
                           device=device or None)
    import torch.distributed as dist

    try:
        mod, fn = entry.split(":")
        kwargs = torch.load(run / "kwargs.pt", weights_only=False)
        out = getattr(importlib.import_module(mod), fn)(device=dev, **kwargs)
        torch.save(out, run / f"result{rank}.pt")
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
