"""The operational tooling of the port: the counterparts of the JAX
package's ``scripts/``, each under the name of its JAX script and with its
flags, run as ``python -m aivc_tpu_torch.scripts.<name>``:

* RD sweeps and checkpoint promotion: ``rd_sweep``, ``eval_ckpt``,
  ``bd_from_eval``;
* checkpoint surgery on the host's numpy trees: ``gain_smooth``,
  ``make_lowrate``, ``swa``, ``reset_flow_head``;
* probes of a checkpoint: ``latent_range``, ``probe_motion``;
* end-to-end checks and process runners: ``sanity`` (structural mode;
  the golden half is ``eval/golden.py``), ``aivc`` (encode, decode and
  evaluate as separate processes), ``train_supervised`` (the training
  supervisor).

The entry points that code on a device run on the card unless ``--cpu``
is given; with no card and no ``--cpu`` they exit 2 and name the flag.
"""

from __future__ import annotations

import sys
from pathlib import Path

# The checkout's root: a child process of a script imports the port from
# here whatever its working directory.
ROOT = Path(__file__).resolve().parents[2]


def pick_device(cpu: bool):
    """The host where ``cpu``, else the card; None, after naming the flag
    on stderr, where there is no card (the caller exits 2)."""
    from aivc_tpu_torch.device import resolve_device

    try:
        return resolve_device("cpu" if cpu else None)
    except RuntimeError:
        print("error: no CUDA device; pass --cpu to run on the host",
              file=sys.stderr)
        return None


def child_env(**overrides: str) -> dict:
    """The environment of a child ``python -m aivc_tpu_torch...``: this
    one, with the checkout's root first on PYTHONPATH."""
    import os

    env = dict(os.environ, **overrides)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT), env.get("PYTHONPATH", "")) if p)
    return env
