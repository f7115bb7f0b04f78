"""PyTorch port vs the JAX package: the int8 deploy path's sparse convs
and dense SmoothQuant conv, one layer each, and the mixed recipes on the
trained tiny model (moved out of ``test_torch_port_deploy.py``, whose
module docstring states their tolerances, so that each file keeps at most
5 tests and ``--dist loadfile`` dispatches ``test_accuracy_regression.py``
early).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from q3d_tpu.ops.spconv import modules as jax_spmodules
from q3d_tpu.quant import api as jax_api
from q3d_tpu.quant.rules import (LayerRule as JaxLayerRule,
                                 QuantRules as JaxQuantRules,
                                 SmoothQuantCfg as JaxSmoothQuantCfg,
                                 quant_rules_scope)
from q3d_tpu.quant.tensor_quant import TensorQuantizer as JaxTensorQuantizer

from q3d_tpu_torch.models.layers import Conv2d
from q3d_tpu_torch.ops.spconv import SparseConvTensor, SparseConv3d, SubMConv3d
from q3d_tpu_torch.quant import api as port_api
from q3d_tpu_torch.quant.rules import LayerRule, SmoothQuantCfg

from test_torch_port_deploy import (RESCALE_RTOL, SQ_OFF_BY_ONE_SHARE, SQ_RTOL,
                                    SQ_SCALE_RTOL, _dense_inputs, _dense_pair,
                                    _port_tiny, _sparse_input)
from torch_port_jax_cache import jax_compile_cache  # noqa: F401

torch.set_num_threads(2)


def test_mixed_recipes_run():
    """``sq=True, residency=True``: the sparse convs emit int8 features
    (residency), the dense convs run SmoothQuant without residency and the
    head's DenseRequant stays a no-op; ``extra_no_list`` keeps the BEV
    backbone float while the rest is int8."""
    from q3d_tpu_torch.models.layers import QTensor

    model, batch = _port_tiny()
    port_api.quantize_model(model, port_api.int8_deploy_recipe(
        sq=True, residency=True), batch)
    port_api.collect_stats(model, [batch, batch], 2)
    port_api.compute_amax(model)
    sparse = [m for m in model.backbone_3d.modules()
              if isinstance(m, (SubMConv3d, SparseConv3d))]
    dense = [m for m in model.modules() if isinstance(m, Conv2d)
             and m.rule is not None]
    assert len(sparse) == 21 and sum(m.residency for m in sparse) == 20
    assert dense and all(m.rule.smoothquant is not None and not m.residency
                         for m in dense)
    assert not model.dense_head.shared_requant.residency
    dtypes = []
    hooks = [m.register_forward_hook(
        lambda m_, a, o: dtypes.append(
            "qtensor" if isinstance(o, QTensor) else
            str(getattr(o, "features", o).dtype))) for m in sparse + dense]
    with torch.no_grad():
        out = model(dict(batch))
    for h in hooks:
        h.remove()
    assert dtypes[:21] == ["torch.float32"] + ["torch.int8"] * 20
    # the BEV map is dequantized to bf16, as the reference's; each dense
    # conv returns its input's dtype, and the BNs f32
    assert dtypes[21:] == ["torch.bfloat16"] + ["torch.float32"] * (
        len(dense) - 1)
    assert torch.isfinite(out["final_scores"]).all()
    assert int(out["final_valid"].sum()) > 5

    model, batch = _port_tiny()
    port_api.quantize_model(model, port_api.int8_deploy_recipe(
        extra_no_list=("backbone_2d.*",)), batch)
    assert all(m.rule is None for m in model.backbone_2d.modules()
               if isinstance(m, Conv2d))
    assert model.dense_head.shared_conv[0].rule.deploy_int8
    with torch.no_grad():
        out = model(dict(batch))
    assert torch.isfinite(out["final_scores"]).all()
    assert int(out["final_valid"].sum()) > 5


@pytest.mark.parametrize("kind", ["subm", "strided"])
def test_dynamic_int8_sparse_conv_matches_reference(kind):
    jst, valid = _sparse_input(21, 16)
    if kind == "subm":
        jmod = jax_spmodules.SubMConv3d(32, 3, 1, 1, use_bias=True,
                                        indice_key="k")
        mod = SubMConv3d(16, 32, 3, 1, 1, bias=True, indice_key="k")
    else:
        jmod = jax_spmodules.SparseConv3d(32, 3, 2, 1)
        mod = SparseConv3d(16, 32, 3, 2, 1)
    rules = JaxQuantRules(rules=(JaxLayerRule((jmod.KIND,),
                                              deploy_int8=True),))
    with quant_rules_scope(rules):
        v = jmod.init(jax.random.PRNGKey(3), jst, {})
        if kind == "subm":
            v = {"params": {**v["params"], "bias": jnp.linspace(
                -0.5, 0.5, 32, dtype=jnp.float32)}}
        want = jax.jit(lambda v_, s: jmod.apply(v_, s, {}))(v, jst)
    pst = SparseConvTensor(
        features=torch.from_numpy(np.array(jst.features)),
        indices=torch.from_numpy(np.array(jst.indices)),
        spatial_shape=tuple(jst.spatial_shape), batch_size=2, sorted_rows=True)
    mod.weight.data = torch.from_numpy(np.array(v["params"]["weight"]))
    if kind == "subm":
        mod.bias.data = torch.from_numpy(np.array(v["params"]["bias"]))
    mod.rule = LayerRule((mod.QUANT_KIND,), deploy_int8=True)
    mod.calibrating = True                    # creates the quantizers
    with torch.no_grad():
        mod(pst, {})
    mod.calibrating = False
    with torch.no_grad():
        got = mod(pst, {})
        feats, wq, out_scale = mod._quantize(pst)
    # the int8 operands: the masked features' amax (pads unseen), the
    # weight per output channel
    masked = jnp.asarray(np.array(jst.features) * valid[:, None])

    def jquant(x, axis=None):       # jitted, as the reference's forward
        return jax.jit(JaxTensorQuantizer(jax_api.QuantSpec(8, axis=axis),
                                          mode="int").apply)({}, x)
    jq, js = jquant(masked)
    np.testing.assert_array_equal(feats.numpy(), np.asarray(jq))
    assert float(js) * 127 == pytest.approx(float(np.abs(masked).max()),
                                            rel=1e-6)
    jwq, _ = jquant(v["params"]["weight"], axis=2)
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq))
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    want_f = np.asarray(want.features)
    assert got.features.dtype == torch.float32 and want_f.dtype == np.float32
    assert np.abs(want_f).max() > 1.0
    # the largest output is ~3e4 units of s_act * s_w, so an s32 sum off by
    # one unit anywhere would break 1e-6 of it thirty times over
    err = np.abs(got.features.numpy() - want_f).max()
    assert err <= RESCALE_RTOL * np.abs(want_f).max(), err
    assert float(out_scale.max()) * 2e4 < np.abs(want_f).max()


def test_smoothquant_int8_dense_conv_matches_reference():
    x = _dense_inputs(6)[0]
    jrule = JaxLayerRule(("conv2d",), deploy_int8=True,
                         smoothquant=JaxSmoothQuantCfg(0.5))
    rule = LayerRule(("conv2d",), deploy_int8=True,
                     smoothquant=SmoothQuantCfg(0.5))
    port_api._check_rule(rule, "x", "conv2d")
    want, seen, mod = _dense_pair(jrule, rule, x)
    # the port's quantizers' inputs and outputs
    ours = {}
    hooks = [getattr(mod, n).register_forward_hook(
        lambda m, a, o, n=n: ours.__setitem__(n, (a[0], o)))
        for n in ("act_quant", "weight_quant")]
    with torch.no_grad():
        got = mod(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    for h in hooks:
        h.remove()
    w2d = mod.weight.detach().reshape(40, -1).t().numpy()
    nz = w2d != 0
    scale_j = np.asarray(seen["weight_quant"][0])[nz] / w2d[nz]
    scale_p = ours["weight_quant"][0].numpy()[nz] / w2d[nz]
    assert np.abs(scale_p - scale_j).max() <= SQ_SCALE_RTOL * np.abs(scale_j)\
        .max()
    pq = ours["act_quant"][1][0].reshape(-1).numpy().astype(np.int32)
    jq = np.asarray(seen["act_quant"][1][0]).reshape(-1).astype(np.int32)
    diff = np.abs(pq - jq)
    assert diff.max() <= 1 and (diff > 0).mean() <= SQ_OFF_BY_ONE_SHARE, \
        (int(diff.max()), float((diff > 0).mean()))
    assert float(ours["act_quant"][1][1]) == pytest.approx(
        float(seen["act_quant"][1][1]), rel=SQ_SCALE_RTOL)
    got = got.permute(0, 2, 3, 1).numpy()
    want = np.asarray(want)
    assert got.dtype == want.dtype == np.float32 and np.abs(want).max() > 1.0
    assert np.abs(got - want).max() <= SQ_RTOL * np.abs(want).max()
