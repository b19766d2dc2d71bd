"""The GDN layers' route to kernel K4 (ops/gdn.py:GDN), held on the host.

On the card a GDN layer sends a bf16 input that autograd needs no graph
for, in a layer without a clamp, to K4 at gdn_apply's own rounding points
(``gdn_layer_cuda``).  Here:
  * its plain version, ``gdn_layer_plain`` (the tensor cores' sum
    emulated exact in float64 and rounded once to f32, gamma as hi + lo,
    hi alone with lowp), against gdn_apply on every GDN layer of bf16-r5
    (MOFNet's C = 96, CodecNet's 128), with and without lowp: each output
    within smoke.GDN_LAYER_RTOL of gdn_apply's, relative (2^-7 for f32
    outputs, measured 3.8e-3; 2^-5 for bf16, measured 9.0e-3), and at
    most smoke.GDN_LAYER_DIFFERING_SHARE = 2e-3 of them differing at all
    (measured 6.6e-4 and 8e-6);
  * the route rule, with the card's test of the device stood in for and
    the plain version in the kernel's place: on the host, under grad,
    with a clamp, for f32 inputs and for channel counts the kernel is not
    built for, the layer gives gdn_apply's tensor exactly, and counts a
    fallback where the input stands on the card;
  * the kernel's parameters are made once per version of beta and gamma
    and again after load_state_dict, an in-place update or an optimiser
    step; on every call where the parameters are inference tensors.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from aivc_tpu_torch import kernels, smoke
from aivc_tpu_torch.ops import gdn as tg
from aivc_tpu_torch.utils.checkpoint import read_params

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Test workers share the host's cores: a small PyTorch pool keeps
    them from oversubscribing it (spinning OpenMP threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _r5_gdns():
    """[(name, beta_r, gamma_r)] of every GDN layer of bf16-r5, in the
    checkpoint's order: CodecNet's nine (C = 128), then MOFNet's (96)."""
    found = []

    def walk(tree, name):
        if isinstance(tree, dict):
            if "beta" in tree and "gamma" in tree:
                found.append((name, torch.from_numpy(
                    np.asarray(tree["beta"], np.float32)),
                    torch.from_numpy(np.asarray(tree["gamma"], np.float32))))
            for k, v in tree.items():
                walk(v, f"{name}.{k}" if name else k)
    walk(read_params(ROOT / "models_ckpt" / "bf16-r5"), "")
    return found


R5_GDNS = 18


@pytest.fixture(scope="module")
def r5_gdns():
    found = _r5_gdns()
    assert len(found) == R5_GDNS
    assert sorted({g.shape[0] for _, _, g in found}) == [96, 128]
    return found


def _x(c, seed, b=2, h=24, w=40):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((b, c, h, w), generator=g) * 1.5).to(torch.bfloat16)


@pytest.mark.parametrize("lowp", [False, True])
@pytest.mark.parametrize("layer", range(R5_GDNS))
def test_layer_plain_within_gdn_apply(r5_gdns, layer, lowp):
    name, beta_r, gamma_r = r5_gdns[layer]
    inverse = ".g_s." in name
    x = _x(gamma_r.shape[0], 100 + layer)
    beta, gamma = tg.reparam(beta_r, gamma_r)
    out = tg.gdn_layer_plain(x, *tg.layer_params(beta, gamma, lowp),
                             inverse, lowp)
    ref = tg.gdn_apply(x, beta_r, gamma_r, inverse, 0.0, lowp)
    rel, share = smoke.gdn_layer_errors(out, ref)
    assert out.dtype == (torch.bfloat16 if lowp else torch.float32)
    assert rel <= smoke.GDN_LAYER_RTOL[out.dtype], (name, rel)
    assert share <= smoke.GDN_LAYER_DIFFERING_SHARE, (name, share)


def test_layer_params_split_and_cast():
    beta_r, gamma_r = _r5_gdns()[0][1:]
    beta, gamma = tg.reparam(beta_r, gamma_r)
    b, hi, lo = tg.layer_params(beta, gamma, False)
    assert torch.equal(b, beta) and torch.equal(hi, gamma.to(torch.bfloat16))
    assert torch.equal(lo, tg.split_gamma(gamma)[1])
    b, hi, lo = tg.layer_params(beta, gamma, True)
    assert b.dtype == torch.float32
    assert torch.equal(b, beta.to(torch.bfloat16).float())
    assert hi is lo and torch.equal(hi, gamma.to(torch.bfloat16))


class _Card:
    """The card stood in for: every tensor counts as on the card, and the
    kernel is its plain version, counting its calls."""

    def __init__(self, monkeypatch):
        self.calls = []
        monkeypatch.setattr(tg, "_on_card", lambda x: True)
        monkeypatch.setattr(tg, "gdn_layer_cuda", self.kernel)

    def kernel(self, x, beta, hi, lo, inverse, lowp):
        assert not x.requires_grad and x.is_contiguous()
        self.calls.append((beta, hi, lo))
        return tg.gdn_layer_plain(x, beta, hi, lo, inverse, lowp)


def _layer(c=128, inverse=False, clamp=0.0, lowp=False, seed=0):
    layer = tg.GDN(c, inverse=inverse, clamp=clamp, lowp=lowp)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        layer.beta.copy_(torch.sqrt(torch.rand(c, generator=g) + 0.5))
        layer.gamma.copy_(torch.sqrt(torch.rand(c, c, generator=g) * 0.05))
    return layer


def _want_kernel(layer, x):
    beta, gamma = tg.reparam(layer.beta.detach(), layer.gamma.detach())
    return tg.gdn_layer_plain(x.detach(), *tg.layer_params(
        beta, gamma, layer.lowp), layer.inverse, layer.lowp)


def _want_apply(layer, x):
    return tg.gdn_apply(x, layer.beta, layer.gamma, layer.inverse,
                        layer.clamp, layer.lowp)


# (case, layer arguments, x's channels and dtype, grad mode, whether the
# parameters require grad, whether x does, takes the kernel)
ROUTES = [
    ("bf16", {}, 128, torch.bfloat16, False, True, False, True),
    ("bf16 lowp", {"lowp": True}, 128, torch.bfloat16, False, True, False,
     True),
    ("bf16 C 96 inverse", {"inverse": True}, 96, torch.bfloat16, False,
     True, False, True),
    ("grad on, nothing requires it", {}, 128, torch.bfloat16, True, False,
     False, True),
    ("x requires grad, grad off", {}, 128, torch.bfloat16, False, True,
     True, True),
    ("grad on", {}, 128, torch.bfloat16, True, True, False, False),
    ("grad on, x requires it", {}, 128, torch.bfloat16, True, False, True,
     False),
    ("clamp", {"clamp": 16.0}, 128, torch.bfloat16, False, True, False,
     False),
    ("f32", {}, 128, torch.float32, False, True, False, False),
    ("f32 lowp", {"lowp": True}, 96, torch.float32, False, True, False,
     False),
    ("C 64", {}, 64, torch.bfloat16, False, True, False, False),
]


@pytest.mark.parametrize("case", ROUTES, ids=[r[0] for r in ROUTES])
def test_route_rule(monkeypatch, case):
    _, kw, c, dtype, grad, params_grad, x_grad, kernel = case
    card = _Card(monkeypatch)
    layer = _layer(c, **kw)
    layer.requires_grad_(params_grad)
    x = _x(c, 7).to(dtype).requires_grad_(x_grad)
    kernels.reset_launches()
    with torch.set_grad_enabled(grad):
        assert layer.takes_kernel(x) == kernel
        got = layer(x)
        want = _want_kernel(layer, x) if kernel else _want_apply(layer, x)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert len(card.calls) == int(kernel)
    assert kernels.FALLBACKS["gdn_layer"] == int(not kernel)


@pytest.mark.parametrize("case", ROUTES, ids=[r[0] for r in ROUTES])
def test_host_inputs_take_gdn_apply(case):
    """Without the stand-in every input lies on the host: gdn_apply,
    bit for bit, and nothing counted."""
    _, kw, c, dtype, grad, params_grad, x_grad, _ = case
    layer = _layer(c, **kw)
    layer.requires_grad_(params_grad)
    x = _x(c, 8).to(dtype).requires_grad_(x_grad)
    kernels.reset_launches()
    with torch.set_grad_enabled(grad):
        assert not layer.takes_kernel(x)
        got, want = layer(x), _want_apply(layer, x)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert kernels.FALLBACKS["gdn_layer"] == 0
    assert kernels.LAUNCHES["gdn_layer"] == kernels.LAUNCHES["gdn_fused"] == 0


def test_kernel_params_made_once(monkeypatch):
    card = _Card(monkeypatch)
    layer = _layer()
    x = _x(128, 9)
    with torch.no_grad():
        layer(x)
        layer(x)
    assert len(card.calls) == 2
    assert all(a is b for a, b in zip(*card.calls))


def test_kernel_params_follow_load_state_dict(monkeypatch):
    card = _Card(monkeypatch)
    layer, other = _layer(seed=1), _layer(seed=2)
    x = _x(128, 10)
    with torch.no_grad():
        first = layer(x)
        layer.load_state_dict(other.state_dict())
        got = layer(x)
    assert torch.equal(got, _want_kernel(other, x))
    assert not torch.equal(got, first)
    assert not torch.equal(card.calls[0][1], card.calls[1][1])


@pytest.mark.parametrize("which", ["beta", "gamma"])
def test_kernel_params_follow_in_place_update(monkeypatch, which):
    _Card(monkeypatch)
    layer = _layer(lowp=True)
    x = _x(128, 11)
    with torch.no_grad():
        before = layer(x)
        getattr(layer, which).mul_(1.5)
        got = layer(x)
    assert torch.equal(got, _want_kernel(layer, x))
    assert not torch.equal(got, before)


def test_kernel_params_follow_optimiser_step(monkeypatch):
    """A training step (grad on: gdn_apply) then an inference call (the
    kernel) sees the stepped parameters."""
    card = _Card(monkeypatch)
    layer = _layer(inverse=True)
    x = _x(128, 12)
    opt = torch.optim.SGD(layer.parameters(), lr=0.5)
    with torch.no_grad():
        before = layer(x)
    layer(x.float()).square().mean().backward()
    opt.step()
    with torch.no_grad():
        got = layer(x)
    assert len(card.calls) == 2
    assert torch.equal(got, _want_kernel(layer, x))
    assert not torch.equal(got, before)


def test_kernel_params_of_inference_tensors(monkeypatch):
    """Parameters made under inference mode have no version counter:
    the kernel's parameters are made on every call, and follow an
    in-place update there."""
    card = _Card(monkeypatch)
    with torch.inference_mode():
        layer = _layer(96, lowp=True).to(torch.float64).to(torch.float32)
        assert layer.beta.is_inference()
        x = _x(96, 13)
        before = layer(x)
        layer.gamma.mul_(1.5)
        got = layer(x)
        want = _want_kernel(layer, x)
    assert len(card.calls) == 2
    assert torch.equal(got, want) and not torch.equal(got, before)


def test_reset_launches_clears_fallbacks():
    kernels.FALLBACKS["gdn_layer"] = 3
    kernels.FALLBACKS["conv_stage"] = 4
    kernels.FALLBACKS["conv1x1"] = 6
    kernels.LAUNCHES["gdn_layer"] = 2
    kernels.LAUNCHES["conv_stage"] = 5
    kernels.LAUNCHES["conv1x1"] = 7
    kernels.reset_launches()
    assert kernels.FALLBACKS == {"gdn_layer": 0, "conv_stage": 0,
                                 "conv1x1": 0}
    assert kernels.LAUNCHES["gdn_layer"] == 0
    assert kernels.LAUNCHES["conv_stage"] == 0
    assert kernels.LAUNCHES["conv1x1"] == 0
