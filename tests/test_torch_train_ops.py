"""The training slice's operations against the JAX package's, on the host:

* ``quantize(training=True)`` with JAX's own noise injected: equal to
  the bit (one float32 addition on both sides).
* ``LowerBound``'s gradient against ``jax.vjp`` of ``lower_bound``,
  below, at and above the bound with gradients of both signs: equal to
  the bit.
* ``ops/ties.py``: the same values as PyTorch's clamp / abs / leaky_relu
  to the bit, and JAX's gradients at the ties, exactly.
* ``pdf_parameterize_mixture`` and ``mixture_bin_prob`` on random inputs
  (ec_mode two, three, three_gamma): mu and the weights' logits pass
  through unchanged; sigma, gamma and the softmax weights within 1e-6
  relative (exp and the softmax differ by an ulp or two), measured
  1.4e-7; the bin probability within 1e-6 relative + 2.5e-7 absolute
  (two float32 steps at 1), measured 0.63 of that limit (3.6e-7 on a
  sum of three components near 1.5).
* ``warp_plain``'s gradients with respect to x and to the flow against
  ``jax.grad`` of JAX's warp, on flows that reach past every border and
  sit exactly on it: within 1e-6 relative L2 (the scatter sums of the
  gradient with respect to x run in another order), measured 1.4e-8
  (x) and 0 (flow); the values equal to the bit.
* ``warp`` under AIVC_WARP=pallas at a shape inside JAX's rule refuses
  an input that requires grad (K5's wrapper does too: a card test).
"""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from aivc_tpu.ops import entropy_models as jem
from aivc_tpu.ops.gdn import lower_bound as j_lower_bound
from aivc_tpu.ops.quantizer import quantize as j_quantize
from aivc_tpu_torch.config import ec_mode_parts
from aivc_tpu_torch.ops import entropy_models as tem
from aivc_tpu_torch.ops import ties
from aivc_tpu_torch.ops import warp as tw
from aivc_tpu_torch.ops.gdn import (
    BETA_MIN,
    PEDESTAL,
    REPARAM_OFFSET,
    lower_bound,
    reparam,
)
from aivc_tpu_torch.ops.quantizer import (
    FixedNoise,
    GeneratorNoise,
    quantize,
)
from tests.torch_train_ref import limit_threads, rel_l2

jw = importlib.import_module("aivc_tpu.ops.warp")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = limit_threads()
    yield
    torch.set_num_threads(n)


def test_quantize_training_adds_jax_noise_exactly():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 5, (2, 4, 6, 8)).astype(np.float32)     # NHWC
    key = jax.random.PRNGKey(3)
    ref = np.asarray(j_quantize(jnp.asarray(x), training=True, rng=key))
    u = np.asarray(jax.random.uniform(key, x.shape, jnp.float32, -0.5, 0.5))
    noise = FixedNoise([torch.from_numpy(u.transpose(0, 3, 1, 2).copy())])
    out = quantize(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                   training=True, noise=noise)
    assert np.array_equal(out.permute(0, 2, 3, 1).numpy(), ref)
    assert len(noise) == 0
    with pytest.raises(RuntimeError, match="no noise tensor left"):
        noise.uniform(out)
    with pytest.raises(ValueError, match="shape"):
        FixedNoise([torch.zeros(3)]).uniform(out)
    with pytest.raises(ValueError, match="noise source"):
        quantize(out, training=True)


def test_generator_noise_draws_on_the_tensors_device():
    like = torch.zeros((3, 5, 7, 11))
    a = GeneratorNoise(5).uniform(like)
    b = GeneratorNoise(5).uniform(like)
    assert a.shape == like.shape and a.dtype == torch.float32
    assert a.device == like.device
    assert torch.equal(a, b)
    assert float(a.min()) >= -0.5 and float(a.max()) < 0.5
    assert abs(float(a.mean())) < 0.05
    n = GeneratorNoise(6)
    n.uniform(like)
    n.uniform(like[0])
    assert n.shapes == [tuple(like.shape), tuple(like[0].shape)]
    assert not torch.equal(n.uniform(like), a)


def test_lower_bound_gradient_matches_jax():
    bound = float((BETA_MIN + PEDESTAL) ** 0.5)
    b32 = float(np.float32(bound))
    x = np.array([b32 - 0.5, b32 - 1e-7, b32, b32 + 1e-7, 0.3, -2.0,
                  b32 - 0.1, b32, 4.0, -1e-9], np.float32)
    g = np.array([1.0, 2.0, 3.0, -1.0, 0.5, -0.25, -4.0, -2.0, 1.5, 0.0],
                 np.float32)
    val, vjp = jax.vjp(lambda v: j_lower_bound(v, bound), jnp.asarray(x))
    (ref,) = vjp(jnp.asarray(g))
    xt = torch.tensor(x, requires_grad=True)
    out = lower_bound(xt, bound)
    out.backward(torch.tensor(g))
    assert np.array_equal(out.detach().numpy(), np.asarray(val))
    assert np.array_equal(xt.grad.numpy(), np.asarray(ref))
    # below the bound a gradient that pushes up passes, one that pushes
    # down is stopped (x = b - 0.5 with g > 0; x = b - 0.1 with g < 0)
    assert xt.grad[0] == 0.0 and xt.grad[6] == -4.0


def test_reparam_gradients_pass_where_jax_passes():
    """beta and gamma at and below their bounds: the gradient through
    the reparameterisation is JAX's."""
    from aivc_tpu.ops.gdn import lower_bound as jlb

    beta_bound = (BETA_MIN + PEDESTAL) ** 0.5
    beta_r = np.array([0.0, 1.0, 1e-4, 2.0], np.float32)
    gamma_r = np.array([[0.0, 1.0], [REPARAM_OFFSET, 0.1]], np.float32)
    w_b = np.array([1.0, -1.0, -2.0, 0.5], np.float32)
    w_g = np.array([[1.0, 1.0], [-1.0, 1.0]], np.float32)

    def j_obj(b, gm):
        beta = jlb(b, beta_bound) ** 2 - PEDESTAL
        gamma = jlb(gm, REPARAM_OFFSET) ** 2 - PEDESTAL
        return jnp.sum(beta * w_b) + jnp.sum(gamma * w_g)

    jb, jg = jax.grad(j_obj, argnums=(0, 1))(jnp.asarray(beta_r),
                                             jnp.asarray(gamma_r))
    bt = torch.tensor(beta_r, requires_grad=True)
    gt = torch.tensor(gamma_r, requires_grad=True)
    beta, gamma = reparam(bt, gt)
    (torch.sum(beta * torch.tensor(w_b))
     + torch.sum(gamma * torch.tensor(w_g))).backward()
    assert np.array_equal(bt.grad.numpy(), np.asarray(jb))
    assert np.array_equal(gt.grad.numpy(), np.asarray(jg))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ties_values_equal_torch(dtype):
    rng = np.random.default_rng(1)
    v = np.concatenate([rng.normal(0, 2, 1000), [0.0, -0.0, 1.0, -1.0]])
    x = torch.tensor(v, dtype=torch.float32).to(dtype)
    assert torch.equal(ties.clip(x, -1.0, 1.0), torch.clamp(x, -1.0, 1.0))
    assert torch.equal(ties.floor_at(x, 0.25), torch.clamp_min(x, 0.25))
    assert torch.equal(ties.abs_(x), torch.abs(x))
    assert torch.equal(ties.leaky_relu(x, 0.01),
                       torch.nn.functional.leaky_relu(x, 0.01))


def test_ties_gradients_match_jax():
    x = np.array([-1.5, -1.0, -0.2, 0.0, 0.3, 1.0, 2.0], np.float32)
    cases = [
        (lambda v: jnp.clip(v, -1.0, 1.0), lambda v: ties.clip(v, -1.0, 1.0)),
        (lambda v: jnp.maximum(v, 0.3), lambda v: ties.floor_at(v, 0.3)),
        (jnp.abs, ties.abs_),
        (lambda v: jax.nn.leaky_relu(v, 0.01),
         lambda v: ties.leaky_relu(v, 0.01)),
    ]
    for jf, tf in cases:
        ref = np.asarray(jax.grad(lambda v: jnp.sum(jf(v) * 3.0))(
            jnp.asarray(x)))
        xt = torch.tensor(x, requires_grad=True)
        (tf(xt) * 3.0).sum().backward()
        assert np.array_equal(xt.grad.numpy(), ref), (jf, xt.grad, ref)


@pytest.mark.parametrize("ec_mode", ["two", "three", "three_gamma"])
def test_mixture_functions_match_jax(ec_mode):
    rng = np.random.default_rng(2)
    C = 6
    K, gamma = ec_mode_parts(ec_mode)
    n = (3 * K - 1 + (K if gamma else 0)) * C
    h = rng.normal(0, 3, (2, 5, 4, n)).astype(np.float32)     # NHWC
    y = (np.round(rng.normal(0, 4, (2, 5, 4, C)))
         + rng.uniform(-0.5, 0.5, (2, 5, 4, C))).astype(np.float32)
    jc = jem.pdf_parameterize_mixture(jnp.asarray(h), C, ec_mode)
    tc = tem.pdf_parameterize_mixture(
        torch.from_numpy(h.transpose(0, 3, 1, 2).copy()), C, ec_mode)
    assert len(tc) == len(jc) == K
    for j, t in zip(jc, tc):
        assert sorted(j) == sorted(t)
        for k in j:
            out = t[k].permute(0, 2, 3, 1).numpy()
            ref = np.asarray(j[k])
            if k == "mu":
                assert np.array_equal(out, ref)
            else:
                assert np.allclose(out, ref, rtol=1e-6, atol=0), k
    for family in ("laplace", "normal"):
        for zero_mu in (True, False):
            ref = np.asarray(jem.mixture_bin_prob(jnp.asarray(y), jc, family,
                                                  zero_mu))
            out = tem.mixture_bin_prob(
                torch.from_numpy(y.transpose(0, 3, 1, 2).copy()), tc, family,
                zero_mu).permute(0, 2, 3, 1).numpy()
            assert np.allclose(out, ref, rtol=1e-6, atol=2.5e-7)


def _border_flow(rng, B, H, W):
    """Flows that reach past every border, land exactly on it, or stay
    inside."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    u = rng.normal(0, 4, (B, H, W)).astype(np.float32)
    v = rng.normal(0, 4, (B, H, W)).astype(np.float32)
    u[:, 0, :] = -xx[0] - 3.0                    # past the left border
    u[:, 1, :] = (W - 1) - xx[1] + 2.5           # past the right
    u[:, 2, :] = -xx[2]                          # exactly on the left
    u[:, 3, :] = (W - 1) - xx[3]                 # exactly on the right
    v[:, :, 0] = -yy[:, 0] - 5.0                 # past the top
    v[:, :, 1] = (H - 1) - yy[:, 1] + 1.25       # past the bottom
    v[:, :, 2] = -yy[:, 2]                       # exactly on the top
    v[:, :, 3] = (H - 1) - yy[:, 3]              # exactly on the bottom
    u[:, 4, 4] = 0.0                             # integer sample points
    v[:, 4, 4] = 0.0
    return np.stack([u, v], axis=-1)             # [B, H, W, 2]


def test_warp_plain_gradients_match_jax():
    rng = np.random.default_rng(4)
    B, C, H, W = 2, 3, 12, 20
    x = rng.random((B, H, W, C)).astype(np.float32)
    flow = _border_flow(rng, B, H, W)
    w = rng.normal(0, 1, (B, H, W, C)).astype(np.float32)
    assert not jw._USE_PALLAS

    def j_obj(xv, fv):
        return jnp.sum(jw.warp(xv, fv) * w)

    jval = np.asarray(jw.warp(jnp.asarray(x), jnp.asarray(flow)))
    jgx, jgf = jax.grad(j_obj, argnums=(0, 1))(jnp.asarray(x),
                                               jnp.asarray(flow))
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_()
    ft = torch.from_numpy(flow.transpose(0, 3, 1, 2).copy()).requires_grad_()
    out = tw.warp_plain(xt, ft)
    (out * torch.from_numpy(w.transpose(0, 3, 1, 2).copy())).sum().backward()
    assert np.array_equal(out.detach().permute(0, 2, 3, 1).numpy(), jval)
    gx = xt.grad.permute(0, 2, 3, 1).numpy()
    gf = ft.grad.permute(0, 2, 3, 1).numpy()
    assert rel_l2(gx, np.asarray(jgx)) <= 1e-6
    assert rel_l2(gf, np.asarray(jgf)) <= 1e-6
    # the rows and columns clamped past a border have no flow gradient
    assert np.all(gf[:, 0, :, 0] == 0) and np.all(gf[:, :, 0, 1] == 0)


def test_warp_plain_nan_flow_gives_nan_samples_as_jax():
    """A NaN flow (a poisoned microbatch) samples NaN where JAX's gather
    does, and raises nothing: the train step's guard then drops it."""
    rng = np.random.default_rng(6)
    x = rng.random((1, 8, 8, 3)).astype(np.float32)
    flow = rng.normal(0, 2, (1, 8, 8, 2)).astype(np.float32)
    flow[0, 2, 3, 0] = np.nan
    flow[0, 5, 1, 1] = np.nan
    ref = np.asarray(jw.warp(jnp.asarray(x), jnp.asarray(flow)))
    out = tw.warp_plain(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                        torch.from_numpy(flow.transpose(0, 3, 1, 2).copy()))
    out = out.permute(0, 2, 3, 1).numpy()
    assert np.array_equal(np.isnan(out), np.isnan(ref))
    assert np.isnan(out).sum() == 6
    ok = ~np.isnan(ref)
    assert np.array_equal(out[ok], ref[ok])


def test_pallas_warp_refuses_gradients(monkeypatch):
    monkeypatch.setattr(tw, "_USE_PALLAS", True)
    x = torch.rand(1, 3, 16, 128)
    flow = torch.zeros(1, 2, 16, 128, requires_grad=True)
    with pytest.raises(ValueError, match="cannot be differentiated"):
        tw.warp(x, flow)
    with torch.no_grad():
        assert torch.equal(tw.warp(x, flow), tw.warp_vclamped(x, flow))
    # outside the shape rule the plain warp trains, as in JAX
    x2 = torch.rand(1, 3, 16, 96, requires_grad=True)
    tw.warp(x2, torch.zeros(1, 2, 16, 96)).sum().backward()
    assert x2.grad is not None
