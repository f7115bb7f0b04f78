"""PyTorch port vs the JAX package: the fake-quant sparse conv and the
dense SmoothQuant conv, one layer each against the reference's flax
module (moved out of ``test_torch_port_fakequant.py``, whose module
docstring states their tolerances, so that each file keeps at most 5 tests
and ``--dist loadfile`` dispatches ``test_accuracy_regression.py`` early).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from q3d_tpu.models import layers as jax_layers
from q3d_tpu.ops.spconv import engine as jax_engine
from q3d_tpu.ops.spconv import modules as jax_spmodules
from q3d_tpu.quant import api as jax_api  # noqa: F401
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
from q3d_tpu_torch.quant import tensor_quant as port_tq
from q3d_tpu_torch.quant.rules import LayerRule, SmoothQuantCfg

from test_torch_port_fakequant import DENSE_RTOL, SPARSE_RTOL, _calibrate_layer
from torch_port_jax_cache import jax_compile_cache  # noqa: F401

torch.set_num_threads(2)


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
