"""PyTorch port vs the JAX package: VoxelNeXt's PTQ recipes, tiny
(``voxelnext_tiny.yaml`` with ``KERNEL_SIZE_HEAD: 1``, as the nuScenes
config has it, so that the heads' hidden convs are 1x1), f32, batch 2, on
the seeded weights of ``torch_port_anchor_common.build``.

* The gather-view SmoothQuant per layer (conv_out, shared_conv and a 1x1
  hidden head conv), each fed the reference's own input: dynamic, and
  static after one calibration pass of that input on both sides (method
  "max"), within 2e-3 of the output's scale (XLA's jitted ``pow`` rounds
  some column scales an ulp away, ``ROADMAP.md`` §3); the float layer and
  the same rule without SmoothQuant are both more than 4e-3 away, so a
  missing transform or a missing scale migration shows.
* ``voxelnext_recipe``: rules and no_list equal to the reference's for
  every (sq, static), and every conv's resolved rule equal to the one the
  reference's layers resolve.
* ``int8_deploy_recipe()`` (dynamic, without residency): every sparse
  conv (kernel 1's s8 entry for the 3x3 ones, the exact s8 product for the
  1x1 hidden head convs) fed the reference's own input within 1e-6 of its
  output's scale, as ``test_torch_port_deploy_model.py`` holds
  CenterPoint's, and the port's head, decode and NMS on the reference's
  encoded tensor give its detections slot for slot.  End to end the two
  runs part: conv_input's f32 output differs in the last bits (another
  summation order), which flips an int8 rounding of the next conv's input,
  and on these random weights the flips grow through the 30 int8 layers
  (the encoded tensor ~8% of its scale apart, measured), where the trained
  CenterPoint stays within 1e-6.
* The fault of the reference under int8 residency, not copied
  (``ROADMAP.md`` §3): its merged x4/x5/x6 tensor holds the stages' raw
  int8 codes without a scale, and ``bev_sum_pool`` sums them in int8,
  where they wrap; the port's merged tensor is the real values, and its
  scores stay within the JAX package's bound of its float model's (mean
  |fp - q| < 0.05, ``tests/test_quant_model_e2e.py``).
"""

import copy
import dataclasses
import inspect
import itertools
from unittest import mock

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from q3d_tpu.quant import api as jax_api
from q3d_tpu.quant.rules import QuantRules as JaxQuantRules
from q3d_tpu.quant.rules import quant_rules_scope
from q3d_tpu.models.backbones_3d import spconv_backbone_voxelnext as jvn
from q3d_tpu.ops.spconv import modules as jmodules

import torch_port_anchor_common as common
import torch_port_quant_common as qcommon
from test_quant import _RecordingRules
from test_torch_port_voxelnext import (OUT_KEYS, check_detections,
                                       first_frame, fresh_probes, jax_st,
                                       port_forward, rel_err)
from q3d_tpu_torch.models.backbones_3d import spconv_backbone_voxelnext as pvn
from q3d_tpu_torch.ops.spconv import modules as pmodules
from q3d_tpu_torch.quant import api as port_api
from q3d_tpu_torch.utils.weights import pcdet_name, reference_module_path
from torch_port_jax_cache import jax_compile_cache  # noqa: F401

torch.set_num_threads(2)
SQ_RTOL = 2e-3
LAYER_RTOL = 1e-6
SCORE_BOUND = 0.05
SQ_LAYERS = {"backbone_3d.conv_out.0": "backbone_3d.conv_out.conv",
             "backbone_3d.shared_conv.0": "backbone_3d.shared_conv.conv",
             "dense_head.heads_list.0.center.0.0":
             "dense_head.heads_list_0.center_0"}


_CONFIGS = common.configs


def _configs(name):
    cfgs = _CONFIGS(name)
    for cfg in cfgs:
        cfg.MODEL.DENSE_HEAD.KERNEL_SIZE_HEAD = 1
    return cfgs


def _recorded(ref, rules, variables, method=None):
    """One jitted reference forward under ``rules`` -> (final outputs or
    None, {path: (input, output)} of every sparse conv and 2D block,
    ``bev_sum_pool``'s (input, output)); ``method``: the part of the model
    applied.  ``variables`` without a quant collection: a dynamic recipe's,
    whose layers declare the leaves they would read as they run (none is
    read)."""
    kinds = (jmodules.SubMConv3d, jmodules.SparseConv3d, jmodules.SubMConv2d,
             jmodules.SparseConv2d, jvn._Sparse2dConvBNReLU)
    real_pool = jvn.bev_sum_pool

    def apply(v, b):
        store, pool = {}, []

        def record_pool(st, *a, **kw):
            out = real_pool(st, *a, **kw)
            pool.append((st, out))
            return out
        with quant_rules_scope(rules), fnn.intercept_methods(
                qcommon._record(store, kinds)), \
                mock.patch.object(jvn, "bev_sum_pool", record_pool), \
                fresh_probes():
            kw = {} if "quant" in v else {"mutable": ["quant"]}
            out = ref["model"].apply(v, b, train=False, **kw) \
                if method is None else ref["model"].apply(v, b, method=method,
                                                          **kw)
            out = out[0] if kw else out
        return {k: out[k] for k in OUT_KEYS if k in out}, store, pool[0]

    out, store, pool = jax.jit(apply)(variables, ref["batch"])
    layers = {p: (qcommon._arrays(i), qcommon._arrays(o))
              for p, (i, o) in store.items()}
    return ({k: np.asarray(v) for k, v in out.items()} or None, layers,
            tuple(qcommon._arrays(x) for x in pool))


def _backbone(model, batch):
    return model.backbone_3d(model.vfe(batch, False), False)


def _quant_tree(ref, rules, state, method=None):
    """The reference's variables under ``rules`` (``method``: for the part
    of the model it applies): its float params and BN statistics, and every
    quant leaf from the port's state dict ``state`` (zeros where the port
    has none)."""
    with quant_rules_scope(rules):
        shapes = jax.eval_shape(
            lambda k, b: ref["model"].init(k, b, train=False) if method
            is None else ref["model"].init(k, b, method=method),
            jax.random.PRNGKey(0), ref["batch"])
    out_index = lambda head, branch: 1                         # noqa: E731

    def fill(path, s):
        key = pcdet_name(("quant",) + tuple(p.key for p in path), out_index)
        if key in state:
            return state[key].numpy().reshape(s.shape).astype(s.dtype)
        return np.zeros(s.shape, s.dtype)
    quant = jax.tree_util.tree_map_with_path(
        fill, jax.tree_util.tree_map(lambda x: x, dict(shapes["quant"])))
    return {"params": ref["vars"]["params"],
            "batch_stats": ref["vars"]["batch_stats"], "quant": quant}


@pytest.fixture(scope="module")
def vq():
    with mock.patch.object(common, "configs", _configs):
        ref = common.build("voxelnext_tiny")
    # the (path, kind) of every lookup the reference's layers make
    rules = _RecordingRules(jax_api.int8_deploy_recipe())
    float_out, _ = port_forward(ref["port"], ref["port_batch"])
    jout, layers, _ = _recorded(ref, rules, {
        c: ref["vars"][c] for c in ("params", "batch_stats")})
    return ref, float_out, jout, layers, rules.calls


def _sq_rule(static):
    return port_api.voxelnext_recipe(static=static).rules[1]


def test_gather_view_smoothquant_per_layer(vq):
    """conv_out, shared_conv and a 1x1 hidden head conv under the recipe's
    sparse 2D rule (SmoothQuant), each fed the reference's recorded input
    as a standalone layer on both sides: dynamic, then static after one
    calibration pass of that input (method "max").  The float layer and the
    same rule without SmoothQuant (plain fake-quant, no scale migration)
    both land more than 2 x SQ_RTOL from the reference's output."""
    ref, _, _, layers = vq[:4]
    mods = dict(ref["port"].named_modules())
    cases = []
    for name, path in SQ_LAYERS.items():
        mod = mods[name]
        jmod = (jmodules.SubMConv2d if mod.SUBM else jmodules.SparseConv2d)(
            mod.weight.shape[2], mod.kernel_size[0], mod.stride, mod.padding,
            use_bias=mod.bias is not None)
        params = {"weight": mod.weight.detach().numpy()}
        if mod.bias is not None:
            params["bias"] = mod.bias.detach().numpy()
        cases.append((name, mod, jmod, params, layers[path][0]))
    jsts = [jax_st(x) for *_, x in cases]
    for static in (False, True):
        jrules = JaxQuantRules(
            rules=(jax_api.voxelnext_recipe(static=static).rules[1],))

        def apply(vs, sts, mutable):
            """Every layer in one call -> [(output, mutated collections)];
            a leaf a layer declares starts as the reference's init makes
            it (sq_act_amax ones, the rest zeros)."""
            with quant_rules_scope(jrules):
                return [jmod.apply(v, t, {}, mutable=mutable)
                        for (_, _, jmod, _, _), v, t in zip(cases, vs, sts)]
        vs = [{"params": params} for _, _, _, params, _ in cases]
        if static:
            muts = jax.jit(lambda vs, sts: [m for _, m in apply(
                vs, sts, ["calib", "quant"])])(vs, jsts)
            vs = [{c: t for c, t in jax_api.compute_amax(
                {**v, **m}, method="max").items() if c != "calib"}
                for v, m in zip(vs, muts)]
        wants = [np.asarray(w) for w in jax.jit(lambda vs, sts: [
            o.features for o, _ in apply(vs, sts, ["quant"])])(vs, jsts)]
        for (name, mod0, _, _, x), v, want in zip(cases, vs, wants):
            pst, cache = qcommon._st(x), {}         # one book for every run
            got = {}
            for key, rule in (("sq", _sq_rule(static)), ("plain", None),
                              ("no_sq", dataclasses.replace(
                                  _sq_rule(static), smoothquant=None))):
                mod = copy.deepcopy(mod0)
                with torch.no_grad():
                    if rule is not None:
                        # one calibration pass creates the quantizers (and,
                        # static, records the input)
                        mod.rule, mod.calibrating = rule, True
                        mod(pst, cache)
                        mod.calibrating = False
                        if static:
                            port_api.compute_amax(mod, method="max")
                    if key == "sq" and static:
                        np.testing.assert_allclose(
                            mod.sq_act_amax.numpy(),
                            np.asarray(v["quant"]["sq_act_amax"]), rtol=1e-6)
                    got[key] = rel_err(mod(pst, cache).features.numpy(),
                                       want)
            assert got["sq"] <= SQ_RTOL, (name, static, got)
            assert got["plain"] > 2 * SQ_RTOL, (name, static, got)
            assert got["no_sq"] > 2 * SQ_RTOL, (name, static, got)


def test_voxelnext_recipe_matches_reference(vq):
    """Rules and no_list equal to the reference's for every (sq, static),
    with its signature, every rule one the port runs; each of the model's
    convs resolves the rule the reference's layer resolves under
    ``voxelnext_recipe()`` (the reference's ``lookup`` on the path and kind
    that layer looked up in the fixture's forward): 29 3D convs and 10 2D
    ones quantized (conv_out, shared_conv, 4 hidden branch convs a head),
    conv_input and the heads' hm and output convs float."""
    for sq, static in itertools.product((False, True), repeat=2):
        kw = dict(sq=sq, static=static, alpha=0.4, w_bits=8, act_bits=8)
        ours, theirs = port_api.voxelnext_recipe(**kw), \
            jax_api.voxelnext_recipe(**kw)
        assert [dataclasses.asdict(r) for r in ours.rules] \
            == [dataclasses.asdict(r) for r in theirs.rules]
        assert ours.no_list == theirs.no_list
        for rule in ours.rules:
            for kind in rule.layer_kinds:
                port_api._check_rule(rule, "x", kind)
    assert inspect.signature(port_api.voxelnext_recipe) \
        == inspect.signature(jax_api.voxelnext_recipe)

    ref, calls = vq[0], vq[4]
    recipe = jax_api.voxelnext_recipe()
    model = copy.deepcopy(ref["port"])
    # a dynamic recipe: the seed pass only creates the quantizers
    port_api.quantize_model(model, port_api.voxelnext_recipe(),
                            first_frame(ref["port_batch"]))
    seen = {}
    for name, mod in port_api.quantizable_modules(model):
        path = reference_module_path(name)
        kind = calls[path][0]
        rule = recipe.lookup(path, kind)
        assert kind == mod.QUANT_KIND, name
        assert (rule is None) == (mod.rule is None), name
        if rule is not None:
            assert dataclasses.asdict(rule) == dataclasses.asdict(mod.rule)
        seen[path] = mod.rule is not None
    assert set(seen) == set(calls)
    assert sum(seen.values()) == 29 + 10
    assert not seen["backbone_3d.conv_input.conv"]


def test_int8_deploy_recipe_matches_reference(vq):
    """``int8_deploy_recipe()``, dynamic per-tensor int8 without residency:
    each of the 52 sparse convs fed the reference's input within 1e-6 of
    its output's scale (the 3x3 ones on kernel 1's route, 8 quantized 1x1
    hidden head convs on the exact s8 product, the heads' hm and output
    convs float); the head, decode and NMS on the reference's encoded
    tensor give the reference's detections slot for slot."""
    ref, _, jout, layers = vq[:4]
    model = copy.deepcopy(ref["port"])
    # a dynamic recipe: the seed pass only creates the quantizers
    port_api.quantize_model(model, port_api.int8_deploy_recipe(),
                            first_frame(ref["port_batch"]))
    pmodules.POINTWISE_CALLS.clear()
    n = quantized = 0
    with torch.no_grad():
        for name, mod in model.named_modules():
            if not isinstance(mod, pmodules._SparseConvBase):
                continue
            x, y = layers[reference_module_path(name)]
            ours = mod(qcommon._st(x), {}).features.numpy()
            assert rel_err(ours, y["features"]) <= LAYER_RTOL, name
            n += 1
            quantized += mod.rule is not None
        assert (n, quantized) == (52, 29 + 10)
        assert pmodules.POINTWISE_CALLS == {"int8": 8, "float": 12}
        enc = qcommon._st(layers["backbone_3d.shared_conv"][1])
        out = model.dense_head({"encoded_spconv_tensor": enc})
    check_detections({k: out[k].numpy() for k in OUT_KEYS}, jout)


def test_residency_merge_fault_not_copied(vq):
    """Under ``prepare_int8_deploy`` (residency, calibrated by the port on
    the batch's first frame, the same scales carried into the reference),
    on the whole batch: the reference's merged tensor is int8 without a
    scale and its BEV sums wrap (the int8 sums differ from the same codes
    summed in int32); the port's merged tensor is the
    x4 / x5 / x6 features dequantized, each with its own scale, and its
    final scores stay within mean |fp - q| < 0.05 of its float model's."""
    ref, float_out = vq[:2]
    model = copy.deepcopy(ref["port"])
    rules = port_api.prepare_int8_deploy(model,
                                         [first_frame(ref["port_batch"])])
    jrules = jax_api.int8_deploy_recipe(residency=True)
    assert [dataclasses.asdict(r) for r in rules.rules] \
        == [dataclasses.asdict(r) for r in jrules.rules]
    _, _, (merged, pooled) = _recorded(
        ref, jrules, _quant_tree(ref, jrules, model.state_dict(), _backbone),
        method=_backbone)
    assert merged["features"].dtype == np.int8 and merged["feat_scale"] is None
    assert pooled["features"].dtype == np.int8
    pst = qcommon._st(merged)
    true_sums = pvn.bev_sum_pool(pst.replace(
        features=pst.features.double())).features.numpy()
    assert np.abs(true_sums).max() > 127
    assert (true_sums != pooled["features"]).any()

    stages, pool_in = {}, []
    bb = model.backbone_3d
    names = {bb.conv4[-1]: "conv4", bb.conv5[-1]: "conv5",
             bb.conv6[-1]: "conv6"}
    hooks = [m.register_forward_hook(
        lambda mod, a, o: stages.__setitem__(names[mod], o)) for m in names]
    real_pool = pvn.bev_sum_pool

    def record_pool(st, *a, **kw):
        pool_in.append(st)
        return real_pool(st, *a, **kw)
    try:
        with mock.patch.object(pvn, "bev_sum_pool", record_pool):
            out, _ = port_forward(model, ref["port_batch"])
    finally:
        for h in hooks:
            h.remove()
    merged_port = pool_in[0].features
    assert merged_port.dtype == torch.float32 and pool_in[0].feat_scale is None
    parts = [stages[n] for n in ("conv4", "conv5", "conv6")]
    assert all(p.features.dtype == torch.int8 for p in parts)
    assert len({float(p.feat_scale) for p in parts}) == 3
    want = torch.cat([p.features.float() * p.feat_scale for p in parts])
    assert torch.equal(merged_port, want)
    diff = np.mean(np.abs(out["final_scores"] - float_out["final_scores"]))
    assert diff < SCORE_BOUND, diff
