"""Shared pieces of the tooling tests (tests/test_torch_scripts_*.py): the
JAX side of a comparison, made on the host, and the port's entry points
run in this process.

``jax_script`` loads one of the JAX package's scripts/*.py as a module.
Several of them point JAX's persistent compilation cache at a fixed
directory when they are imported; the loader puts the cache settings
back, so a test process writes no cache outside its checkout.

``jax_init_memo`` memoises aivc_tpu.models.zoo.init_fullnet for the block
(a pure function of the config, key and size; each call gets fresh
containers over the same immutable arrays, so a script that edits the
tree it gets edits no other call's).  The JAX scripts' load_checkpoint
builds its template with it (a jit compile of ~14 s on the CPU), and
the memo makes one template serve every load of the same config.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import sys
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

import jax

ROOT = Path(__file__).resolve().parents[1]
TINY_TOY = ROOT / "models_ckpt" / "tiny-toy"
_CACHE_OPTIONS = ("jax_compilation_cache_dir",
                  "jax_persistent_cache_min_compile_time_secs")


def limit_threads():
    """Test workers share the host's cores: a small PyTorch pool keeps
    them from oversubscribing it (spinning OpenMP threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    return n


def jax_script(name: str):
    """scripts/<name>.py as a module, JAX's cache settings restored."""
    saved = {k: getattr(jax.config, k) for k in _CACHE_OPTIONS}
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


def run_jax_script(name: str, argv: List[str]) -> str:
    """scripts/<name>.py's main() with ``argv``: its standard output."""
    mod = jax_script(name)
    out = io.StringIO()
    saved = sys.argv
    sys.argv = [f"{name}.py"] + [str(a) for a in argv]
    try:
        with contextlib.redirect_stdout(out):
            mod.main()
    finally:
        sys.argv = saved
    return out.getvalue()


@contextlib.contextmanager
def jax_init_memo():
    from aivc_tpu.models import zoo

    fn = zoo.init_fullnet
    memo: Dict[Tuple, object] = {}

    def init_fullnet(cfg, rng=None, spatial=64):
        k = (cfg, None if rng is None else
             tuple(np.asarray(rng).ravel().tolist()), spatial)
        if k not in memo:
            memo[k] = fn(cfg, rng, spatial=spatial)
        return jax.tree_util.tree_map(lambda x: x, memo[k])

    zoo.init_fullnet = init_fullnet
    try:
        yield
    finally:
        zoo.init_fullnet = fn


def tiny7(path) -> str:
    """A 7-rate tiny checkpoint at ``path``: tiny-toy's tree with each
    gain matrix widened to a 7-row ladder made from its first row (the
    encoder's gain halving and the decoder's doubling at each step, so
    the rate falls along the ladder as a trained model's does), and
    bf16-r5's lambdas."""
    import dataclasses

    from aivc_tpu_torch.models.zoo import BASE
    from aivc_tpu_torch.utils.checkpoint import read_tree, save_tree

    cfg, tree = read_tree(TINY_TOY)
    step = 2.0 ** (3 - np.arange(7))[:, None]

    def widen(d):
        out = {}
        for k, v in d.items():
            if isinstance(v, dict):
                out[k] = widen(v)
            elif k in ("enc_gain", "dec_gain"):
                rows = np.abs(v[0])[None] * (step if k == "enc_gain"
                                             else 1.0 / step)
                out[k] = rows.astype(v.dtype)
            else:
                out[k] = v
        return out

    cfg = dataclasses.replace(
        cfg, mofnet=dataclasses.replace(cfg.mofnet, n_rates=7),
        codecnet=dataclasses.replace(cfg.codecnet, n_rates=7),
        lambda_tradeoff=BASE.lambda_tradeoff)
    save_tree(path, cfg, widen(tree))
    return str(path)


def run_port(main, argv: List[str]) -> Tuple[int, str]:
    """A port entry point's main(argv) in this process: (exit code,
    standard output)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main([str(a) for a in argv])
    return rc, out.getvalue()


def json_lines(text: str) -> List[Dict]:
    return [json.loads(ln) for ln in text.splitlines()
            if ln.startswith("{")]


def same_files(a: Path, b: Path) -> Dict[str, bool]:
    """config.json and params.msgpack of two checkpoints, byte for byte."""
    return {f: (Path(a) / f).read_bytes() == (Path(b) / f).read_bytes()
            for f in ("config.json", "params.msgpack")}
