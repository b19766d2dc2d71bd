"""Typed configuration for aivc_tpu_torch (a copy of aivc_tpu.config: the port keeps its own).

The reference drives everything through untyped ``param`` dicts validated
against per-function DEFAULT_PARAM dicts (reference:
src/func_util/nn_util.py:142-158) and hides model hyper-parameters inside
pickled module files.  Here every knob is a frozen dataclass that is
serialised next to checkpoints, so a bitstream/checkpoint pair is fully
self-describing.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Tuple

# ---------------------------------------------------------------------------
# Frame types (reference: src/func_util/GOP_structure.py:22-24)
# ---------------------------------------------------------------------------
FRAME_I = 0
FRAME_P = 1
FRAME_B = 2

# ---------------------------------------------------------------------------
# Numerical constants (reference: src/func_util/math_func.py:20-31)
# ---------------------------------------------------------------------------
PROBA_MIN = 2.0 ** -16
LOG_VAR_MIN = -18.4207  # sigma > exp(0.5 * -18.4207) ~ 1e-4
LOG_VAR_MAX = 10.0      # sigma < exp(0.5 * 10) ~ 148.4

# Latent symbols live in [-AC_MAX_VAL, AC_MAX_VAL - 1]
# (reference: src/real_life/bitstream.py:67-79).  This is the DEFAULT
# alphabet half-width; a model may declare a narrower one via
# ModelConfig.ac_max_val (recorded in the video header) — trained
# latents rarely reach +-256, and every entropy-coding lookup's cost
# scales with the alphabet width (the one-hot CDF contractions on TPU).
AC_MAX_VAL = 256

# Spatial padding multiple: g_a downsamples x16 to y, h_a a further x4 to z,
# so every input frame is replication-padded up to a multiple of 64 and the
# true size is carried in the video header (reference handles odd sizes via
# data_dim crops, src/real_life/decode.py:556-571).
PAD_MULTIPLE = 64
Y_DOWNSCALE = 16   # x -> y spatial reduction
Z_DOWNSCALE = 64   # x -> z spatial reduction


def ec_mode_parts(ec_mode: str) -> Tuple[int, bool]:
    """-> (K mixture components, with log-gamma) of an ec_mode: 'one',
    'two' or 'three', optionally with '_gamma'."""
    parts = ec_mode.split("_")
    k = 2 if "two" in parts else 3 if "three" in parts else 1
    return k, "gamma" in parts


@dataclass(frozen=True)
class ConditionalNetConfig:
    """Hyper-parameters of one conditional autoencoder (MOFNet or CodecNet).

    Mirrors the attributes the reference decoder reads from the pickled
    ConditionalNet (reference: src/real_life/decode.py:779-795), which are
    first-class config here.
    """

    # Channels of the main latent y and hyper-latent z.
    nb_ft_y: int = 128
    nb_ft_z: int = 64
    # Internal width of the conv stacks.
    nb_ft: int = 128
    # Input channels of the analysis transform g_a (3 for CodecNet's frame,
    # 6/9 for MOFNet which also sees the references).
    in_c: int = 3
    # Input channels of the shortcut/conditioning encoder g_a_ref
    # (0 disables the shortcut transform entirely).
    in_c_shortcut: int = 3
    # Output channels of the shortcut transform, concatenated to y_hat at
    # the synthesis input (reference: src/real_life/decode.py:894-896).
    out_c_shortcut_y: int = 64
    # Output channels of the synthesis transform g_s
    # (3 for CodecNet, 6 for MOFNet: alpha, beta, v_prev, v_next).
    out_c: int = 3
    # Parametric pdf family for y ('laplace' or 'normal'),
    # (reference: src/layers/entropy_coding/pdf_estimator.py:54-62).
    pdf_family: str = "laplace"
    # Entropy-coding mode: number of mixture components for the y pdf.
    # 'one' (default) | 'two' | 'three' [+ optional '_gamma'], matching
    # the reference's ec_mode grammar
    # (reference: src/layers/misc/misc_layers.py:172-269).  The deployed
    # coding path always uses component [0] (decode.py:853-856); K > 1
    # adds mixture capacity to the training-time rate model.
    ec_mode: str = "one"
    # Number of trained rate points (gain-vector pairs) per gain matrix
    # (reference: src/layers/multi_rate/gain_matrix.py:32-89).
    n_rates: int = 7
    # Use separate gain matrices for P and B frames in addition to I
    # (reference: src/real_life/decode.py:788-793).
    gain_p_b: bool = True
    # Insert simplified attention modules in g_a / g_s
    # (reference: src/layers/misc/attention.py:45-97).
    use_attention: bool = True
    # Kernel size of the conv stacks.
    k_size: int = 5
    # Compute dtype of the conv transforms ('float32' or 'bfloat16').
    # Latents, mu/sigma and everything feeding entropy coding stay float32
    # at the module boundaries regardless.
    dtype: str = "float32"
    # GDN multiplier clamp (0 = the reference's unclamped GDN).  Inverse
    # GDN multiplies by ~|x| outside the O(1) regime, so a deep IGDN
    # synthesis can amplify quadratically per stage into a runaway fixed
    # point with dead gradients (observed ~1e33 trunk activations after
    # training).  A clamp of 16 bounds the per-element multiplier to
    # [1/16, 16]; healthy nets run ~0.8-1.2, so it never engages for
    # them (ops/gdn.py:gdn_apply).
    gdn_clamp: float = 0.0
    # Lane-pack factor G for the synthesis OUTPUT head conv (0/1 = plain
    # conv).  The 4*out_c-channel head (24 maps / 12 pixels) uses 24/128
    # or 12/128 MXU lanes; packing G output columns into lanes runs it
    # ~3x faster at identical math (ops/layers.py:LanePackedConv).
    # INFERENCE-side switch: FrameCodec sets it from the
    # AIVC_PACKED_HEAD env (training keeps the plain conv); it is a
    # compute-schedule choice, not a model property, so checkpoints
    # saved with it set still decode identically without it.
    head_lane_pack: int = 0
    # Low-precision GDN parameter path (inference): cast beta/gamma to
    # the activation dtype so the norm einsum runs native bf16 instead
    # of materializing an f32 copy of x^2 (ops/gdn.py:gdn_apply lowp).
    # Like head_lane_pack this is a compute-schedule switch set by
    # FrameCodec, not a model property; training keeps f32 parameters.
    gdn_lowp: bool = False
    # Channel-major maps head (MOFNet only): the synthesis head returns
    # its conv output pre-depth-to-space and the alpha/beta/flow maps are
    # produced as [B, 6, H, W] planes instead of [B, H, W, 6].  Full-res
    # few-channel NHWC tensors put C (6, or 1-2 after slicing) in the
    # 128-lane minor dim, so every elementwise map op and every program
    # boundary they cross runs heavily lane-padded — measured ~30% of the
    # mof_synth stage as pure layout copies at 1080p (scripts/
    # trace_synth.py).  Channel-major planes tile (H sublanes, W lanes)
    # perfectly.  Inference-side compute-schedule switch like the two
    # above (AIVC_MAPS_CM); training keeps the channel-last path.
    maps_cm: bool = False
    # Space-to-depth first analysis conv (ops/layers.py:S2DConv): the
    # stride-2 k5 conv on the 3/6/9-channel full-res frame concats is
    # ~80x off the conv roofline (the top op of the mof_synth stage,
    # scripts/dump_synth_hlo.py); folding the 2x2 stride phases into
    # channels runs the same sums as a dense stride-1 3x3 conv.
    # Inference compute-schedule switch (AIVC_S2D); training keeps the
    # plain conv.
    s2d_analysis: bool = False

    @property
    def mixture_k(self) -> int:
        """Mixture components K from ec_mode
        (reference: misc_layers.py:190-195)."""
        return ec_mode_parts(self.ec_mode)[0]

    @property
    def sigma_cond_c(self) -> int:
        """Channels of the hyper-synthesis output: K*C mu, K*C log-var,
        optionally K*C log-gamma, (K-1)*C weight logits
        (reference channel layout: misc_layers.py:200-254)."""
        k, gamma = ec_mode_parts(self.ec_mode)
        n = 2 * k + (k - 1)
        if gamma:
            n += k
        return n * self.nb_ft_y


@dataclass(frozen=True)
class ModelConfig:
    """Full per-frame codec: MOFNet + CodecNet + motion compensation."""

    name: str = "tpu-aivc-base"
    # MOFNet sees both references (2 x 3 channels) and outputs 6 maps:
    # alpha, beta, v_prev(2), v_next(2)  (reference: decode.py:730-735).
    mofnet: ConditionalNetConfig = field(
        default_factory=lambda: ConditionalNetConfig(
            nb_ft_y=96,
            nb_ft_z=48,
            nb_ft=96,
            in_c=9,            # frame + prev_ref + next_ref
            in_c_shortcut=6,   # cat(prev_ref, next_ref), decode.py:710-712
            out_c_shortcut_y=48,
            out_c=6,
        )
    )
    # CodecNet codes the frame conditioned on the masked motion-compensated
    # prediction alpha * x_warp (reference: decode.py:539-549).
    codecnet: ConditionalNetConfig = field(
        default_factory=lambda: ConditionalNetConfig(
            nb_ft_y=128,
            nb_ft_z=64,
            nb_ft=128,
            in_c=6,            # frame + prediction
            in_c_shortcut=3,   # alpha * x_warp
            out_c_shortcut_y=64,
            out_c=3,
        )
    )
    # Rate-distortion lambdas per rate index (highest rate first, mirroring
    # model.model_param['lambda_tradeoff'] in the reference pickles,
    # reference: src/model_mngt/model_management.py:97,114).  The ladder is
    # geometric over ~440x so the 7 points span a rate range comparable to
    # the reference's 1-20 Mbit/s @1080p ladder (README.md:25); the round-1
    # ladder (0.0067..0.3477) only reached ~0.4 bpp at the low end.
    lambda_tradeoff: Tuple[float, ...] = (
        0.004, 0.011, 0.030, 0.083, 0.23, 0.63, 1.75
    )
    # Distortion used for training: 'mse' or 'ms_ssim'
    # (reference: src/model_mngt/loss_function.py:197-200).
    dist_loss: str = "ms_ssim"
    weight_i_frame_loss: float = 1.0
    # Optical-flow bound in pixels.  0 = the reference's unbounded linear
    # flow outputs (src/real_life/decode.py:730-739).  > 0 applies
    # v = bound * softsign(raw / bound): |v| < bound with a gradient that
    # NEVER vanishes — the unbounded parameterization was observed fully
    # degenerate after training (every flow ~1e32: the border-clamped
    # warp has zero gradient outside the frame, so flows that escape
    # early can never return; the codec silently became intra-only).
    # A bound also caps the warp's data window, enabling the windowed
    # TPU warp kernel.
    flow_bound: float = 0.0
    # Entropy-coding alphabet half-width: latent symbols are clipped to
    # [-ac_max_val, ac_max_val - 1] at coding time.  256 mirrors the
    # reference (src/real_life/bitstream.py:67-79); trained models whose
    # latents stay well inside can declare a narrower power of two — CDF
    # tables and the TPU one-hot lookups shrink proportionally.  Recorded
    # in the video header so mismatched decode fails loudly.
    ac_max_val: int = 256

    @property
    def full_float32(self) -> bool:
        """True where either net computes in float32: its convolutions
        and matmuls then run with TF32 off (the codec's
        configure_determinism, the train step's float32_precision); bf16
        models keep PyTorch's settings."""
        return "float32" in (self.mofnet.dtype, self.codecnet.dtype)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2) + "\n"

    @classmethod
    def from_json(cls, text: str) -> "ModelConfig":
        raw = json.loads(text)
        raw["mofnet"] = ConditionalNetConfig(**raw["mofnet"])
        raw["codecnet"] = ConditionalNetConfig(**raw["codecnet"])
        raw["lambda_tradeoff"] = tuple(raw["lambda_tradeoff"])
        return cls(**raw)


@dataclass(frozen=True)
class ElicConfig:
    """ELIC (He et al., CVPR 2022, arXiv 2203.10886): an intra-only image
    codec with a mean-scale hyperprior and the space-channel context
    model SCCTX (models/elic.py).  A checkpoint's ``config.json`` selects
    it with ``"arch": "elic"``."""

    name: str = "elic-n192m320"
    arch: str = "elic"
    # Width of the transforms (N) and of the latent y (M); z has N
    # channels.
    n: int = 192
    m: int = 320
    # The uneven channel groups of y, coded in this order; they sum to m.
    groups: Tuple[int, ...] = (16, 16, 32, 64, 192)
    # Hidden widths of each group's channel-context stack (two 5x5
    # convs) and of its 1x1 parameter-aggregation stack.
    ctx_hidden: Tuple[int, int] = (224, 128)
    agg_hidden: Tuple[int, int] = (640, 512)
    # Compute dtype of every convolution ('float32' or 'bfloat16');
    # parameters, latents, mu and sigma stay float32.
    dtype: str = "bfloat16"
    # Entropy-coding alphabet half-width (recorded in the video header).
    ac_max_val: int = 64

    def __post_init__(self):
        if sum(self.groups) != self.m:
            raise ValueError(f"ELIC groups {self.groups} do not sum to "
                             f"M = {self.m}")

    @property
    def full_float32(self) -> bool:
        """True where the model computes in float32 (TF32 then off, as
        ModelConfig.full_float32)."""
        return self.dtype == "float32"

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2) + "\n"

    @classmethod
    def from_json(cls, text: str) -> "ElicConfig":
        raw = json.loads(text)
        for key in ("groups", "ctx_hidden", "agg_hidden"):
            if key in raw:
                raw[key] = tuple(raw[key])
        return cls(**raw)


def model_config_from_json(text: str):
    """A checkpoint's ``config.json`` -> ElicConfig where its ``arch`` is
    "elic", else ModelConfig (AIVC's FullNet)."""
    if json.loads(text).get("arch") == "elic":
        return ElicConfig.from_json(text)
    return ModelConfig.from_json(text)


@dataclass(frozen=True)
class CodingConfig:
    """One encode/decode run (the reference CLI surface, src/aivc.py:16-76)."""

    coding_config: str = "RA"      # 'AI' | 'LDP' | 'RA'
    gop_size: int = 16
    intra_period: int = 32
    idx_rate: float = 0.0          # continuous in [0, n_rates - 1]
    start_frame: int = 0
    end_frame: int = -1            # -1: whole sequence
    flag_bitstream_debug: bool = False

    def gop_struct_name(self) -> str:
        """Map CLI parameters to a GOP-structure name.

        Same mapping and validation as the reference (src/aivc.py:80-107):
        AI -> '1_GOP_0'; LDP -> 'LDP_<intra_period>';
        RA -> '<intra_period/gop_size>_GOP_<gop_size>'.
        """
        cc = self.coding_config
        if cc == "AI":
            return "1_GOP_0"
        if cc == "LDP":
            if not (2 <= self.intra_period <= 65535):
                raise ValueError(
                    f"LDP intra_period must be in [2, 65535], got {self.intra_period}"
                )
            return f"LDP_{self.intra_period}"
        if cc == "RA":
            gs, ip = self.gop_size, self.intra_period
            if not (2 <= gs <= 65535) or (gs & (gs - 1)) != 0:
                raise ValueError(f"RA gop_size must be a power of two in [2, 65535], got {gs}")
            if ip % gs != 0:
                raise ValueError(f"intra_period ({ip}) must be a multiple of gop_size ({gs})")
            return f"{ip // gs}_GOP_{gs}"
        raise ValueError(f"unknown coding_config {cc!r} (expected AI, LDP or RA)")
