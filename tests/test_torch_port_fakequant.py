"""PyTorch port vs the JAX package: fake-quant, SmoothQuant, the amax
methods and the sensitivity helpers.

Exactly equal to the reference's functions: ``fake_quant`` at 2/3/4/8/16
bits, per tensor and per axis, signed, unsigned and narrow-range (the
reference's jitted form rounds as its eager one, so there is one form);
``compute_amax_from_hist`` for "max", "percentile", "mse" and "entropy" on
seeded histograms (the port's entropy sweep builds its candidates with
``np.add.reduceat``: on integer counts every sum is exact, so it equals the
reference's loops); the fake-mode ``TensorQuantizer`` (dynamic per tensor,
per axis and per group of rows, calibration pass-through, static max and
histogram, amax 0 pass-through).

The sparse fake-quant conv fed the same inputs as the reference's flax
module agrees within 2e-6 of its output's scale (the quantized inputs are
equal; the f32 sums run in another order).  The dense SmoothQuant conv
agrees within 2e-3 of its output's scale: its per-column scale
``act_amax^alpha / w_amax^(1-alpha)`` comes from XLA's jitted ``pow``,
which rounds a third of its values an ulp away from PyTorch's (and from
the correctly rounded value), and an ulp in the scale moves the odd
activation across a rounding boundary of the fake-quant, by one step.

The two conv layers live in ``test_torch_port_fakequant_layers.py`` and
the fake-mode ``TensorQuantizer`` and the entropy amax on sparse
histograms in ``..._fakequant_calib.py``, so that each file keeps at most 5
tests and ``--dist loadfile`` dispatches ``test_accuracy_regression.py``
early.  The trained model under the dynamic recipe is held in
``test_torch_port_fakequant_dynamic.py``, under static entropy in
``test_torch_port_fakequant_static.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from q3d_tpu.quant import api as jax_api
from q3d_tpu.quant import sensitivity as jax_sens
from q3d_tpu.quant import tensor_quant as jax_tq
from q3d_tpu.quant.rules import QuantSpec as JaxQuantSpec

from q3d_tpu_torch.quant import api as port_api
from q3d_tpu_torch.quant import calib as port_calib
from q3d_tpu_torch.quant import sensitivity as port_sens
from q3d_tpu_torch.quant import tensor_quant as port_tq
from q3d_tpu_torch.quant.rules import LayerRule, SmoothQuantCfg
from torch_port_jax_cache import jax_compile_cache  # noqa: F401

torch.set_num_threads(2)
RECIPE = dict(sq=True, alpha=0.5, static=False)
SPARSE_RTOL = 2e-6      # equal quantized inputs, f32 sums in another order
DENSE_RTOL = 2e-3       # an ulp of XLA's pow flips the odd act rounding


# ------------------------------------------------------------ fake_quant

def _fake_cases():
    for bits in (2, 3, 4, 8, 16):
        for axis in (None, 0, 1):
            yield bits, axis, False, False
    yield 8, None, True, False
    yield 4, 1, True, False
    yield 8, None, False, True
    yield 3, 0, False, True


@pytest.mark.parametrize("bits,axis,unsigned,narrow", list(_fake_cases()))
def test_fake_quant_matches_reference(bits, axis, unsigned, narrow):
    """Dynamic amax (as the quantizer takes it) and a fixed amax with zero
    and tiny entries: equal to the reference's eager and jitted forms."""
    rng = np.random.RandomState(bits * 10 + (axis or 0))
    x = (rng.randn(512, 48) * rng.uniform(0.01, 10, (1, 48))).astype(np.float32)
    if unsigned:
        x = np.abs(x)
    fixed = np.abs(rng.randn(*([] if axis is None else [x.shape[axis]])))
    fixed = np.asarray(fixed, np.float32)
    if axis is not None:
        fixed[:3] = (0.0, 1e-13, 1e-6)
    for amax in (np.asarray(jax_tq._reduce_amax(jnp.asarray(x), axis)), fixed):
        def ref(a, m):
            return jax_tq.fake_quant(a, m, bits, unsigned, narrow, axis)
        want = np.asarray(ref(jnp.asarray(x), jnp.asarray(amax)))
        np.testing.assert_array_equal(
            np.asarray(jax.jit(ref)(jnp.asarray(x), jnp.asarray(amax))), want)
        got = port_tq.fake_quant(torch.from_numpy(x), torch.tensor(amax),
                                 bits, unsigned, narrow, axis)
        np.testing.assert_array_equal(got.numpy(), want)


def test_fake_quant_straight_through_gradient():
    x = torch.linspace(-2, 2, 101, requires_grad=True)
    port_tq.fake_quant(x, torch.tensor(1.5), 4).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.ones(101, np.float32))


# ------------------------------------------------------- amax from hist

def _histograms():
    rng = np.random.RandomState(7)
    out = []
    for keep, tail in ((0.9, None), (0.5, 400), (0.1, None), (0.99, 1500)):
        h = np.floor(rng.exponential(60, 2048) * (rng.rand(2048) < keep))
        if tail:
            h[tail:] = 0
        h[0] = rng.randint(0, 200000)
        out.append((h.astype(np.float32),
                    float(np.float32(rng.uniform(1e-4, 0.5)))))
    return out


@pytest.mark.parametrize("method,kwargs", [
    ("max", {}), ("percentile", {}), ("percentile", {"percentile": 99.0}),
    ("mse", {}), ("mse", {"start_bin": 64, "stride": 16}), ("entropy", {}),
    ("entropy", {"stride": 3, "start_bin": 300})])
def test_compute_amax_from_hist_matches_reference(method, kwargs):
    # the reference's entropy loops take seconds a histogram: one of them
    hists = _histograms()[:1] if method == "entropy" else _histograms()
    for hist, width in hists:
        want = jax_tq.compute_amax_from_hist(hist, width, method, **kwargs)
        got = port_calib.compute_amax_from_hist(hist, width, method, **kwargs)
        assert got == want, (method, kwargs, got, want)


# ------------------------------------------------- the fake-mode quantizer


def test_unported_rules_raise():
    """SmoothQuant on an int8 sparse conv and an int8 deploy rule on a
    Linear, Conv1d or transposed conv still raise (the reference has no
    int8 path for them); fake-quant on those three kinds, with SmoothQuant
    or without (TransFusion, held in ``test_torch_port_transfusion_quant.
    py``), the sparse gather-view SmoothQuant (VoxelNeXt, held in
    ``test_torch_port_voxelnext_quant.py``), group quantization (held below)
    and int8 deploy without residency or with dense SmoothQuant
    (``test_torch_port_deploy*.py``) are ported now, and their rules pass;
    groups stay fake-quant only."""
    for kind in ("linear", "conv1d", "conv_transpose2d"):
        for kw in (dict(), dict(smoothquant=SmoothQuantCfg())):
            port_api._check_rule(LayerRule((kind,), **kw), "x", kind)
            with pytest.raises(NotImplementedError, match="no int8 deploy"):
                port_api._check_rule(LayerRule((kind,), deploy_int8=True,
                                               **kw), "x", kind)
    for kind in ("subm_conv2d", "sparse_conv2d"):
        sq = LayerRule((kind,), smoothquant=SmoothQuantCfg())
        port_api._check_rule(sq, "x", kind)
        with pytest.raises(NotImplementedError, match="int8 sparse conv"):
            port_api._check_rule(dataclasses.replace(sq, deploy_int8=True),
                                 "x", kind)
    gq = port_tq.QuantSpec(8, group_size=16)
    for kw in (dict(act=gq), dict(deploy_int8=True),
               dict(deploy_int8=True, smoothquant=SmoothQuantCfg())):
        port_api._check_rule(LayerRule(("conv2d",), **kw), "x", "conv2d")
    with pytest.raises(ValueError, match="group"):
        port_api._check_rule(LayerRule(("conv2d",), act=gq, deploy_int8=True),
                             "x", "conv2d")
    with pytest.raises(NotImplementedError, match="groups"):
        port_tq.TensorQuantizer(port_tq.QuantSpec(8, group_size=4), mode="int")


@pytest.mark.parametrize("shape,group,bits", [((130, 16), 64, 8),
                                              ((300, 24), 16, 4),
                                              ((3, 8, 5, 5), 2, 8)])
def test_group_quantizer_matches_reference(shape, group, bits):
    """Group quantization (the reference's grouped dynamic branch,
    ``tensor_quant.py:122-131``): rows padded to a multiple of the group,
    each group fake-quantized with its own amax, exactly as the reference's
    eager and jitted forms; while calibrating, the batch passes through."""
    rng = np.random.RandomState(group + bits)
    x = rng.randn(*shape).astype(np.float32)
    x[shape[0] // 2:] *= 100.0          # groups of very different scales
    spec = dict(num_bits=bits, group_size=group)
    jq = jax_tq.TensorQuantizer(JaxQuantSpec(**spec))
    want = np.asarray(jq.apply({}, jnp.asarray(x)))
    np.testing.assert_array_equal(
        np.asarray(jax.jit(jq.apply)({}, jnp.asarray(x))), want)
    pq = port_tq.TensorQuantizer(port_tq.QuantSpec(**spec), mode="fake")
    got = pq(torch.from_numpy(x))
    assert got.shape == x.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        pq(torch.from_numpy(x), calibrating=True).numpy(), x)


# ------------------------------------- one layer against the flax module

def _calibrate_layer(mod, rule, batches):
    """Attach ``rule`` and run ``batches`` through ``mod`` calibrating (the
    first creates its quantizers, as ``quantize_model``'s seed pass)."""
    mod.rule = rule
    mod.calibrating = True
    with torch.no_grad():
        for b in batches:
            mod(*b)
    mod.calibrating = False


def test_sweep_helpers_match_reference():
    jrules = jax_sens.with_alpha(jax_sens.with_bits(
        jax_api.centerpoint_recipe(), 4, 16), 0.3)
    rules = port_sens.with_alpha(port_sens.with_bits(
        port_api.centerpoint_recipe(), 4, 16), 0.3)
    assert [dataclasses.asdict(r) for r in rules.rules] \
        == [dataclasses.asdict(r) for r in jrules.rules]
    assert rules.no_list == jrules.no_list
    seen = []
    port_sens.bit_sweep(lambda r: seen.append(r) or {"m": len(seen)}, rules,
                        weight_bits=(8, 4), act_bits=(8,))
    assert [r.rules[0].weight.num_bits for r in seen] == [8, 4]
    res = port_sens.alpha_sweep(lambda r: r.rules[1].smoothquant.alpha, rules,
                                alphas=(0.25, 0.5))
    assert res == {0.25: 0.25, 0.5: 0.5}
