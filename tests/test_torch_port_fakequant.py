"""PyTorch port vs the JAX package: fake-quant, SmoothQuant, the amax
methods and the sensitivity helpers.

Exactly equal to the reference's functions: ``fake_quant`` at 2/3/4/8/16
bits, per tensor and per axis, signed, unsigned and narrow-range (the
reference's jitted form rounds as its eager one, so there is one form);
``compute_amax_from_hist`` for "max", "percentile", "mse" and "entropy" on
seeded histograms (the port's entropy sweep builds its candidates with
``np.add.reduceat``: on integer counts every sum is exact, so it equals the
reference's loops); the fake-mode ``TensorQuantizer`` (dynamic per tensor
and per axis, calibration pass-through, static max and histogram, amax 0
pass-through).

The sparse fake-quant conv fed the same inputs as the reference's flax
module agrees within 2e-6 of its output's scale (the quantized inputs are
equal; the f32 sums run in another order).  The dense SmoothQuant conv
agrees within 2e-3 of its output's scale: its per-column scale
``act_amax^alpha / w_amax^(1-alpha)`` comes from XLA's jitted ``pow``,
which rounds a third of its values an ulp away from PyTorch's (and from
the correctly rounded value), and an ulp in the scale moves the odd
activation across a rounding boundary of the fake-quant, by one step.

The trained model under the dynamic recipe is held in
``test_torch_port_fakequant_dynamic.py``, under static entropy in
``test_torch_port_fakequant_static.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from q3d_tpu.models import layers as jax_layers
from q3d_tpu.ops.spconv import engine as jax_engine
from q3d_tpu.ops.spconv import modules as jax_spmodules
from q3d_tpu.quant import api as jax_api
from q3d_tpu.quant import sensitivity as jax_sens
from q3d_tpu.quant import tensor_quant as jax_tq
from q3d_tpu.quant.rules import (LayerRule as JaxLayerRule,
                                 QuantRules as JaxQuantRules,
                                 QuantSpec as JaxQuantSpec,
                                 SmoothQuantCfg as JaxSmoothQuantCfg,
                                 quant_rules_scope)
from tests.test_pallas_conv import _sorted_sparse

from q3d_tpu_torch.models.layers import Conv2d
from q3d_tpu_torch.ops.spconv import SparseConvTensor, SubMConv3d
from q3d_tpu_torch.quant import api as port_api
from q3d_tpu_torch.quant import calib as port_calib
from q3d_tpu_torch.quant import sensitivity as port_sens
from q3d_tpu_torch.quant import tensor_quant as port_tq
from q3d_tpu_torch.quant.rules import LayerRule, SmoothQuantCfg

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


def test_entropy_amax_equals_reference_loops_on_sparse_histograms():
    """Mostly-empty histograms (levels with no filled bin, an empty tail):
    the vectorised candidates equal the reference's Python loops."""
    rng = np.random.RandomState(3)
    for n_filled in (5, 700):
        h = np.zeros(2048)
        h[rng.choice(2048, n_filled, replace=False)] = rng.randint(1, 50,
                                                                   n_filled)
        assert port_calib._entropy_amax(h, 0.01) \
            == jax_tq._entropy_amax(h, 0.01)


# ------------------------------------------------- the fake-mode quantizer

@pytest.mark.parametrize("axis,calibrator", [(None, "max"), (1, "max"),
                                             (None, "histogram")])
def test_fake_quantizer_matches_reference(axis, calibrator):
    """Dynamic; then static: two calibration batches (passed through),
    committed by "max" (and "entropy" for the histogram), then quantizing."""
    rng = np.random.RandomState(5)
    batches = [rng.randn(300, 24).astype(np.float32) * s for s in (1.0, 3.0)]
    dyn = port_tq.QuantSpec(8, axis=axis, dynamic=True)
    jq = jax_tq.TensorQuantizer(JaxQuantSpec(8, axis=axis, dynamic=True))
    pq = port_tq.TensorQuantizer(dyn, mode="fake")
    want = jq.apply({}, jnp.asarray(batches[0]))
    np.testing.assert_array_equal(pq(torch.from_numpy(batches[0])).numpy(),
                                  np.asarray(want))

    spec = dict(axis=axis, dynamic=False, calibrator=calibrator)
    jq = jax_tq.TensorQuantizer(JaxQuantSpec(8, **spec))
    shape = () if axis is None else (24,)
    pq = port_tq.TensorQuantizer(port_tq.QuantSpec(8, **spec), shape,
                                 mode="fake")
    # never calibrated (amax 0): pass-through on both sides
    v = jq.init(jax.random.PRNGKey(0), jnp.asarray(batches[0]))
    v = {"quant": v["quant"]}
    np.testing.assert_array_equal(
        np.asarray(jq.apply(v, jnp.asarray(batches[1]))), batches[1])
    np.testing.assert_array_equal(pq(torch.from_numpy(batches[1])).numpy(),
                                  batches[1])
    v = {"quant": v["quant"], "calib": jax.tree_util.tree_map(
        jnp.zeros_like, jq.init(jax.random.PRNGKey(0),
                                jnp.asarray(batches[0]))["calib"])}
    for b in batches:
        y, mut = jq.apply(v, jnp.asarray(b), mutable=["calib"])
        v = {"quant": v["quant"], "calib": mut["calib"]}
        np.testing.assert_array_equal(np.asarray(y), b)
        np.testing.assert_array_equal(
            pq(torch.from_numpy(b), calibrating=True).numpy(), b)
    for method in ("max", "entropy") if calibrator == "histogram" else ("max",):
        quant = jax_tq.resolve_amax(v["calib"], v["quant"], method=method)
        pq.commit_amax(method)
        np.testing.assert_array_equal(pq.amax.numpy(),
                                      np.asarray(quant["amax"]))
        for b in batches:
            np.testing.assert_array_equal(
                pq(torch.from_numpy(b)).numpy(),
                np.asarray(jq.apply({"quant": quant}, jnp.asarray(b))))


def test_unported_rules_raise():
    gq = LayerRule(("conv2d",), act=port_tq.QuantSpec(8, group_size=16))
    with pytest.raises(NotImplementedError, match="group"):
        port_api._check_rule(gq, "x", "conv2d")
    sq = LayerRule(("subm_conv3d",), smoothquant=SmoothQuantCfg())
    with pytest.raises(NotImplementedError, match="VoxelNeXt"):
        port_api._check_rule(sq, "x", "subm_conv3d")
    for kw in (dict(deploy_int8=True), dict(deploy_int8=True,
               int8_residency=True, smoothquant=SmoothQuantCfg())):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            port_api._check_rule(LayerRule(("conv2d",), **kw), "x", "conv2d")
    with pytest.raises(NotImplementedError, match="group"):
        port_tq.TensorQuantizer(port_tq.QuantSpec(8, group_size=4), mode="fake")


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


@pytest.mark.parametrize("act_axis", [None, 1])
def test_sparse_fakequant_conv_matches_reference(act_axis):
    """A SubMConv3d (16 -> 32) under a fake-quant rule, the act per tensor
    or per input channel, pad rows present."""
    rng = np.random.RandomState(11)
    st, _ = _sorted_sparse(rng, 2, (4, 10, 16), 300, 16, 384)
    st = st.replace(features=st.features * 3.0)
    jrule = JaxLayerRule(("subm_conv3d",), act=JaxQuantSpec(8, axis=act_axis))
    jmod = jax_spmodules.SubMConv3d(32, 3, 1, 1, indice_key="k")
    with quant_rules_scope(JaxQuantRules(rules=(jrule,))):
        v = jmod.init(jax.random.PRNGKey(1), st, {})
        want = np.asarray(jax.jit(lambda v_, s: jmod.apply(v_, s, {}))(
            v, st).features)
    pst = SparseConvTensor(
        features=torch.from_numpy(np.array(st.features)),
        indices=torch.from_numpy(np.array(st.indices)),
        spatial_shape=tuple(st.spatial_shape), batch_size=2, sorted_rows=True)
    mod = SubMConv3d(16, 32, 3, 1, 1, indice_key="k")
    mod.weight.data = torch.from_numpy(np.array(v["params"]["weight"]))
    _calibrate_layer(mod, LayerRule(("subm_conv3d",),
                                    act=port_tq.QuantSpec(8, axis=act_axis)),
                     [(pst, {})])
    with torch.no_grad():
        got = mod(pst, {}).features.numpy()
    assert np.abs(want).max() > 1.0
    assert np.abs(got - want).max() <= SPARSE_RTOL * np.abs(want).max()
    # the float conv on the reference's fake-quantized operands, exactly
    valid = np.array(st.indices[:, 0] >= 0)[:, None]
    fq = jax_tq.fake_quant(st.features * valid, jax_tq._reduce_amax(
        st.features * valid, act_axis), axis=act_axis)
    w = v["params"]["weight"]
    wq = jax_tq.fake_quant(w, jax_tq._reduce_amax(w, 2), axis=2)
    book = jax_engine.subm_gather_indices(st.with_hash(), 3)
    again = np.asarray(jax_engine.gather_conv(fq, book, wq))
    assert np.abs(got - again).max() <= SPARSE_RTOL * np.abs(again).max()


@pytest.mark.parametrize("dynamic,method", [(True, None), (False, "max"),
                                            (False, "entropy")])
def test_smoothquant_conv_matches_reference(dynamic, method):
    """A 3x3 stride-2 Conv2d (24 -> 40, bias) under SmoothQuant, alpha 0.5:
    dynamic, or static with the column amax and the histogram act amax
    calibrated on two batches (the init pass first, as in the reference)."""
    rng = np.random.RandomState(13)
    xs = [np.maximum(rng.randn(2, 21, 19, 24), 0).astype(np.float32) * s
          for s in (1.0, 2.5, 1.5)]
    act = JaxQuantSpec(8, axis=None, dynamic=dynamic,
                       calibrator="max" if dynamic else "histogram")
    jrule = JaxLayerRule(("conv2d",), act=act,
                         smoothquant=JaxSmoothQuantCfg(0.5, dynamic))
    jmod = jax_layers.Conv2d(40, 3, 2, 1, bias_init=0.3)
    rules = JaxQuantRules(rules=(jrule,))
    with quant_rules_scope(rules):
        v = jmod.init(jax.random.PRNGKey(2), jnp.asarray(xs[0]))
        if not dynamic:
            for x in xs[1:]:
                _, mut = jmod.apply(v, jnp.asarray(x), mutable=["calib"])
                v = {**v, "calib": mut["calib"]}
            v = {**v, "quant": jax_tq.resolve_amax(v["calib"], v["quant"],
                                                   method=method)}
        want = np.asarray(jax.jit(jmod.apply)(
            {k: v[k] for k in v if k != "calib"}, jnp.asarray(xs[0])))
    mod = Conv2d(24, 40, 3, 2, 1)
    mod.weight.data = torch.from_numpy(
        np.array(v["params"]["kernel"]).transpose(3, 2, 0, 1).copy())
    mod.bias.data = torch.from_numpy(np.array(v["params"]["bias"]))
    rule = LayerRule(("conv2d",), act=port_tq.QuantSpec(
        8, axis=None, dynamic=dynamic,
        calibrator="max" if dynamic else "histogram"),
        smoothquant=SmoothQuantCfg(0.5, dynamic))
    nchw = [torch.from_numpy(x.transpose(0, 3, 1, 2).copy()) for x in xs]
    _calibrate_layer(mod, rule, [(nchw[0],)] + ([] if dynamic else
                                                [(x,) for x in nchw[1:]]))
    if not dynamic:
        port_api.compute_amax(mod, method=method)
        np.testing.assert_array_equal(mod.sq_act_amax.numpy(),
                                      np.asarray(v["quant"]["sq_act_amax"]))
        assert float(mod.act_quant.amax) == float(
            v["quant"]["act_quant"]["amax"])
    with torch.no_grad():
        got = mod(nchw[0]).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape and np.abs(want).max() > 1.0
    assert np.abs(got - want).max() <= DENSE_RTOL * np.abs(want).max()


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
