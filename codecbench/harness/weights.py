"""The parameters a run's program and reference load.  A configuration
holds exactly one of:

* ``"checkpoint"``: a directory of the checkout with ``config.json`` and
  ``params.msgpack``;
* ``"weights": {"seed": n}``: the architecture's ``init_tree`` draws the
  raw parameter tree from a ``torch.Generator`` seeded with n, on the
  run's device, and it is written with the configuration's ``"model"``
  block as a checkpoint (reference/msgpack.py:write_params) into a
  temporary directory that lives as long as the run.

Either way the program reads the directory through its own loader and the
reference through reference/msgpack.py.  The weights are fixed by the
configuration, never by the run's ``--seed``; the program is never asked
for them."""

from __future__ import annotations

import contextlib
import json
import tempfile
from pathlib import Path
from typing import Dict, Iterator

import torch

from reference.msgpack import write_params


def seed_of(config: Dict):
    """The configuration's weight seed, or None where it names a
    checkpoint; anything else raises ValueError."""
    ckpt, weights = config.get("checkpoint"), config.get("weights")
    if (ckpt is None) == (weights is None):
        raise ValueError("a configuration holds exactly one of "
                         "'checkpoint' and 'weights'")
    if weights is None:
        return None
    seed = weights.get("seed") if isinstance(weights, dict) else None
    if (not isinstance(weights, dict) or set(weights) != {"seed"}
            or not isinstance(seed, int) or isinstance(seed, bool)
            or seed < 0):
        raise ValueError(f"'weights' must be {{'seed': <int >= 0>}}, not "
                         f"{weights!r}")
    return seed


@contextlib.contextmanager
def prepared(root: Path, config: Dict, arch, device) -> Iterator[Path]:
    """The directory that holds the configuration's checkpoint files."""
    seed = seed_of(config)
    if seed is None:
        yield Path(root) / config["checkpoint"]
        return
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(seed)
    tree = arch.init_tree(config, gen)
    with tempfile.TemporaryDirectory(prefix="codecbench-weights-") as d:
        write_params(d, tree)
        (Path(d) / "config.json").write_text(json.dumps(config["model"]))
        yield Path(d)
