"""Model registry (the port's copy of aivc_tpu/models/zoo.py): the
random-init configurations with their default rate index, and the
trained rate ladder.

One architecture serves the whole ladder: every named entry maps to a
ModelConfig (or a checkpoint) plus a default idx_rate into the
gain-vector ladder (reference: src/aivc.py:38-42,
src/layers/multi_rate/gain_matrix.py:159-194).  The trained ladder maps
its seven names onto three weight views: 1-4 the flagship's own gain
rows, 5-6 a load-time gain surgery of the same weights
(``ops/gain.py:shift_gain_tree``), 7 the low-rate checkpoint.
"""

from __future__ import annotations

import math
from dataclasses import replace
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from aivc_tpu_torch.config import ConditionalNetConfig, ModelConfig
from aivc_tpu_torch.ops import gdn as gdn_ops
from aivc_tpu_torch.ops.entropy_models import FactorizedPrior
from aivc_tpu_torch.ops.gain import GainMatrix, shift_gain_tree
from aivc_tpu_torch.ops.layers import Conv

BASE = ModelConfig()

# bfloat16 transform variant: the conv stacks run in bf16, the
# entropy-coding tensors stay float32 at module boundaries.
BASE_BF16 = replace(
    BASE,
    name="tpu-aivc-bf16",
    mofnet=replace(BASE.mofnet, dtype="bfloat16"),
    codecnet=replace(BASE.codecnet, dtype="bfloat16"),
)

# Small config for tests: same topology, tiny channel counts.
TINY = ModelConfig(
    name="tpu-aivc-tiny",
    mofnet=ConditionalNetConfig(
        nb_ft_y=12, nb_ft_z=8, nb_ft=12, in_c=9, in_c_shortcut=6,
        out_c_shortcut_y=8, out_c=6, n_rates=3, use_attention=False),
    codecnet=ConditionalNetConfig(
        nb_ft_y=16, nb_ft_z=8, nb_ft=16, in_c=6, in_c_shortcut=3,
        out_c_shortcut_y=8, out_c=3, n_rates=3, use_attention=False),
    lambda_tradeoff=(0.01, 0.05, 0.25),
)


def _ladder() -> Dict[str, Tuple[ModelConfig, float]]:
    zoo: Dict[str, Tuple[ModelConfig, float]] = {}
    for i in range(1, len(BASE.lambda_tradeoff) + 1):
        # Index 1 = highest rate = idx_rate 0 (gain_matrix.py:137).
        zoo[f"tpu-msssim-{i}"] = (BASE, float(i - 1))
    zoo["tpu-aivc-base"] = (BASE, 0.0)
    zoo["tpu-aivc-bf16"] = (BASE_BF16, 0.0)
    zoo["tpu-aivc-tiny"] = (TINY, 0.0)
    zoo["tpu-aivc-tiny-bf16"] = (
        replace(TINY, name="tpu-aivc-tiny-bf16",
                mofnet=replace(TINY.mofnet, dtype="bfloat16"),
                codecnet=replace(TINY.codecnet, dtype="bfloat16")),
        0.0)
    return zoo


MODEL_ZOO = _ladder()

TRAINED_LADDER: Dict[str, dict] = {
    "tpu-msssim-2021cc-1": {"ckpt": "models_ckpt/bf16-r5", "idx_rate": 0.0},
    "tpu-msssim-2021cc-2": {"ckpt": "models_ckpt/bf16-r5", "idx_rate": 2.0},
    "tpu-msssim-2021cc-3": {"ckpt": "models_ckpt/bf16-r5", "idx_rate": 4.0},
    "tpu-msssim-2021cc-4": {"ckpt": "models_ckpt/bf16-r5", "idx_rate": 6.0},
    "tpu-msssim-2021cc-5": {"ckpt": "models_ckpt/bf16-r5", "idx_rate": 4.0,
                            "surgery": {"shift": 3, "tail_boost": 1.5}},
    "tpu-msssim-2021cc-6": {"ckpt": "models_ckpt/bf16-r5", "idx_rate": 5.0,
                            "surgery": {"shift": 3, "tail_boost": 1.5}},
    "tpu-msssim-2021cc-7": {"ckpt": "models_ckpt/bf16-lr", "idx_rate": 6.0},
}

REPO_ROOT = Path(__file__).resolve().parents[2]


def checkpoint_for(name: str) -> Optional[Tuple[Path, float]]:
    """-> (checkpoint dir, idx_rate) of a trained-ladder name, or None for
    an unknown name or a checkpoint missing on disk."""
    entry = TRAINED_LADDER.get(name)
    if entry is None:
        return None
    ckpt = REPO_ROOT / entry["ckpt"]
    return (ckpt, entry["idx_rate"]) if ckpt.is_dir() else None


def load_trained(name: str, device=None):
    """-> (cfg, FullNet on ``device`` in eval mode, idx_rate) of a
    trained-ladder name, or None where ``checkpoint_for`` gives None.
    Surgery entries shift the gain rows of the checkpoint's tree before
    it is loaded and name the config "<name>-s<shift>", as the JAX
    package's load_trained does."""
    from aivc_tpu_torch.utils.checkpoint import model_from_params, read_params

    found = checkpoint_for(name)
    if found is None:
        return None
    ckpt, idx_rate = found
    cfg = ModelConfig.from_json((ckpt / "config.json").read_text())
    tree = read_params(ckpt)
    surgery = TRAINED_LADDER[name].get("surgery")
    if surgery:
        tree, _ = shift_gain_tree(tree, surgery["shift"],
                                  tail_boost=surgery["tail_boost"])
        cfg = replace(cfg, name=f"{cfg.name}-s{surgery['shift']}")
    return cfg, model_from_params(cfg, tree, device), idx_rate


def get_model(name: str) -> Tuple[ModelConfig, float]:
    """-> (config, default idx_rate).  Raises KeyError with the known
    names."""
    try:
        return MODEL_ZOO[name]
    except KeyError:
        raise KeyError(
            f"unknown model {name!r}; available: {sorted(MODEL_ZOO)}"
        ) from None


@torch.no_grad()
def init_fullnet(cfg: ModelConfig, generator: torch.Generator,
                 device=None) -> nn.Module:
    """A FullNet of ``cfg`` with freshly initialised parameters drawn from
    ``generator``, on ``device`` in eval mode.

    The initialisers are flax's, as distributions (``jax.random`` cannot
    be reproduced): conv kernels lecun-normal (a normal of std
    sqrt(1 / fan_in) / 0.8796 truncated at two of its stds), biases zero,
    gain rows one, GDN beta sqrt(1 + pedestal) and gamma sqrt(0.1 I +
    pedestal), the factorized prior's matrices and biases normal with
    std sqrt(2 / (d_in * d_out)) (aivc_tpu/ops/entropy_models.py:43-57).
    """
    from aivc_tpu_torch.device import resolve_device
    from aivc_tpu_torch.models.fullnet import FullNet

    dev = resolve_device(device)
    model = FullNet(cfg)
    for mod in model.modules():
        if isinstance(mod, Conv):
            cout, cin, kh, kw = mod.weight.shape
            std = math.sqrt(1.0 / (cin * kh * kw)) / .87962566103423978
            nn.init.trunc_normal_(mod.weight, 0.0, std, -2.0 * std,
                                  2.0 * std, generator=generator)
            mod.bias.zero_()
        elif isinstance(mod, gdn_ops.GDN):
            ch = mod.beta.shape[0]
            mod.beta.fill_(math.sqrt(1.0 + gdn_ops.PEDESTAL))
            mod.gamma.copy_(torch.sqrt(gdn_ops.GAMMA_INIT * torch.eye(ch)
                                       + gdn_ops.PEDESTAL))
        elif isinstance(mod, GainMatrix):
            mod.enc_gain.fill_(1.0)
            mod.dec_gain.fill_(1.0)
        elif isinstance(mod, FactorizedPrior):
            for name, p in mod.named_parameters(recurse=False):
                if name[0] == "h":
                    d_in, d_out = p.shape[1], p.shape[2]
                else:
                    d_in, d_out = 1, p.shape[1]
                nn.init.normal_(p, 0.0, math.sqrt(2.0 / (d_in * d_out)),
                                generator=generator)
    return model.to(dev).eval()
