"""PyTorch port vs the JAX package: TransFusion's PTQ recipe and the quant
kinds it brings (``linear``, ``conv1d``, ``conv_transpose2d``), tiny
(``transfusion_tiny.yaml``), f32, batch 2, on the seeded weights of
``torch_port_anchor_common.build``.

* SmoothQuant per layer on seeded inputs, dynamic and static (the column
  amax and the histogram act amax calibrated on two more batches, method
  "max"): a Linear (64 -> 128, the FFN's shape), a Conv1d (k 3, pad 1, so
  that its unfold has more than one tap), a ConvTranspose2d (k 2, stride
  2), each within 2e-3 of its output's scale (the dense SmoothQuant conv's
  hold for XLA's jitted ``pow``, ``ROADMAP.md`` §3); the static
  calibration's ``sq_act_amax`` (none for the Conv1d: the reference's
  takes the batch's column amax always) and act amax equal.  With both quantizers off the
  scale migration cancels: each layer within 1e-5 of its float output
  (``tests/test_quant.py::test_sqconvt2d_matches_plain_transposed_conv``).
* ``transfusion_recipe``: rules and no_list equal to the reference's for
  every (sq, static); every quantizable layer's resolved rule equal to the
  one the reference's layer resolves in its forward (the quantized and the
  excluded paths equal).
* The model under the dynamic and the static recipe (the port calibrating
  itself as the reference does, one pass of the batch, method "max":
  every weight amax within 1e-6 (SmoothQuant migrates the weight by
  XLA's ``pow`` first), the act and column amax within 1e-2, since fake-quant
  roundings flipped by f32 summation order move the statistics of the
  layers after them), then, with the reference's committed scales, every
  conv, Linear and Conv1d fed the reference's own input: SmoothQuant layers
  within 2e-3 of their output's scale, the rest within 1e-5.  End to end
  the two runs part: on these random weights flipped roundings spread
  through the layers (``ROADMAP.md`` §3).
* ``python -m q3d_tpu_torch.tools.quant_transfusion`` on the tiny config
  (``--device cpu``, 2 frames): the fp32 and the quantized evaluations.
"""

import copy
import dataclasses
import inspect
import itertools
import runpy
import sys
from unittest import mock

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from q3d_tpu.models import layers as jlayers
from q3d_tpu.ops.spconv import modules as jsp
from q3d_tpu.quant import api as jax_api
from q3d_tpu.quant import tensor_quant as jax_tq
from q3d_tpu.quant.rules import QuantRules as JaxQuantRules
from q3d_tpu.quant.rules import quant_rules_scope

import torch_port_anchor_common as common
import torch_port_quant_common as qcommon
from test_quant import _RecordingRules
from q3d_tpu_torch.models.layers import (Conv1d, Conv2d, ConvTranspose2d,
                                         Linear)
from q3d_tpu_torch.ops.spconv import SparseConv3d, SubMConv3d
from q3d_tpu_torch.quant import api as port_api
from q3d_tpu_torch.utils.weights import (reference_module_path,
                                         state_dict_from_jax)
from torch_port_jax_cache import jax_compile_cache  # noqa: F401

torch.set_num_threads(2)
SQ_RTOL = 2e-3
FLOAT_RTOL = 1e-5
AMAX_RTOL = 1e-2
RECORDED = (jsp.SubMConv3d, jsp.SparseConv3d, jlayers.Conv2d,
            jlayers.ConvTranspose2d, jlayers.Linear, jlayers.Conv1d)


def rel_err(ours, theirs):
    scale = float(np.abs(theirs).max())
    assert scale > 1e-3, scale                         # a signal, not zeros
    return float(np.abs(np.asarray(ours) - theirs).max()) / scale


# ------------------------------------------------------------ single layers

def _layer_cases(rng):
    """(kind, reference module, port module, reference param names ->
    port tensors, inputs in the reference's layout, -> port layout)."""
    def nchw(x):
        return torch.from_numpy(x.transpose(0, 3, 1, 2).copy())

    def rows(x):
        return torch.from_numpy(x.copy())
    lin, c1, ct = Linear(64, 128), Conv1d(24, 40, 3, 1, 1), \
        ConvTranspose2d(24, 16, 2, 2)
    return [
        ("linear", jlayers.Linear(128), lin,
         [np.maximum(rng.randn(2, 50, 64), 0).astype(np.float32) * s
          for s in (1.0, 2.5, 1.5)], rows,
         lambda k: k.T),
        ("conv1d", jlayers.Conv1d(40, 3, 1, 1), c1,
         [rng.randn(2, 31, 24).astype(np.float32) * s
          for s in (1.0, 2.5, 1.5)], rows,
         lambda k: k.transpose(2, 1, 0)),
        ("conv_transpose2d", jlayers.ConvTranspose2d(16, 2, 2, 0), ct,
         [np.maximum(rng.randn(2, 9, 11, 24), 0).astype(np.float32) * s
          for s in (1.0, 2.5, 1.5)], nchw,
         lambda k: k.transpose(3, 2, 0, 1)),
    ]


def _sq_rule(kind, static, quantizers=True):
    """The recipe's SmoothQuant rule for ``kind`` (the decoder's, or
    CenterPoint's dense one with the kind swapped), on both sides."""
    rules = []
    for api in (jax_api, port_api):
        rule = api.transfusion_recipe(static=static).rules[-1]
        rule = dataclasses.replace(rule, layer_kinds=(kind,), pattern="*")
        if not quantizers:
            rule = dataclasses.replace(rule, weight=None, act=None)
        rules.append(rule)
    return rules


def _calibrate(mod, rule, batches):
    """``rule`` on the port layer, one calibration pass per batch (the
    first creates its quantizers, as ``quantize_model``'s seed pass)."""
    mod.rule, mod.calibrating = rule, True
    with torch.no_grad():
        for b in batches:
            mod(b)
    mod.calibrating = False


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_smoothquant_layers_match_reference(static):
    """A Linear, a Conv1d and a ConvTranspose2d under SmoothQuant, alpha
    0.5, act per tensor: dynamic, or static after the init pass and two
    calibration batches (method "max"), within 2e-3 of the reference's
    output's scale; with the quantizers off, within 1e-5 of the float
    layer (the migration cancels)."""
    rng = np.random.RandomState(17)
    for kind, jmod, mod0, xs, to_port, layout in _layer_cases(rng):
        jrule, rule = _sq_rule(kind, static)
        with quant_rules_scope(JaxQuantRules(rules=(jrule,))):
            v = jmod.init(jax.random.PRNGKey(4), jnp.asarray(xs[0]))
            if static:
                for x in xs[1:]:
                    _, mut = jmod.apply(v, jnp.asarray(x), mutable=["calib"])
                    v = {**v, "calib": mut["calib"]}
                v = {**v, "quant": jax_tq.resolve_amax(
                    v["calib"], v["quant"], method="max")}
            want = np.asarray(jax.jit(jmod.apply)(
                {k: v[k] for k in v if k != "calib"}, jnp.asarray(xs[0])))
        params = v["params"]
        mod0.weight.data = torch.from_numpy(
            np.ascontiguousarray(layout(np.asarray(params["kernel"]))))
        mod0.bias.data = torch.from_numpy(np.array(params["bias"]))
        mod = copy.deepcopy(mod0)
        _calibrate(mod, rule, [to_port(x) for x in xs[:1 if not static
                                                       else 3]])
        if static:
            port_api.compute_amax(mod, method="max")
            assert float(mod.act_quant.amax) == float(
                v["quant"]["act_quant"]["amax"]), kind
            if kind == "conv1d":
                assert "sq_act_amax" not in v["quant"]
                assert not hasattr(mod, "sq_act_amax")
            else:
                np.testing.assert_array_equal(
                    mod.sq_act_amax.numpy(), v["quant"]["sq_act_amax"])
        with torch.no_grad():
            got = mod(to_port(xs[0]))
            plain = mod0(to_port(xs[0]))
        if kind == "conv_transpose2d":
            got, plain = got.permute(0, 2, 3, 1), plain.permute(0, 2, 3, 1)
        assert got.shape == want.shape and np.abs(want).max() > 1.0, kind
        assert rel_err(got.numpy(), want) <= SQ_RTOL, kind

        mod = copy.deepcopy(mod0)
        _calibrate(mod, _sq_rule(kind, static, quantizers=False)[1],
                   [to_port(x) for x in xs])
        if static:
            port_api.compute_amax(mod)
        with torch.no_grad():
            off = mod(to_port(xs[0]))
        off = off.permute(0, 2, 3, 1) if kind == "conv_transpose2d" else off
        assert rel_err(off.numpy(), plain.numpy()) <= FLOAT_RTOL, kind


# ------------------------------------------------------------ whole model

def _reference_run(ref, static):
    """The reference under ``transfusion_recipe(static=static)``: static,
    one calibration pass of the batch through the float model (its
    ``model.apply`` with the calib collection mutable, as a seed pass on
    the float weights would record), method "max"; then every quantizable
    layer's (input, output) in its forward, the (kind, rule) each layer
    resolved, the committed quant tree."""
    model, batch = ref["model"], ref["batch"]
    rules = _RecordingRules(jax_api.transfusion_recipe(static=static))
    v = {c: ref["vars"][c] for c in ("params", "batch_stats")}
    if static:
        def calib_pass(v, b):
            with quant_rules_scope(rules.inner):
                return model.apply(v, b, train=False,
                                   mutable=["calib", "quant"])[1]
        v = jax_api.compute_amax({**v, **jax.jit(calib_pass)(v, batch)},
                                 method="max")
        v.pop("calib")

    def apply(v, b):
        store = {}
        # a dynamic recipe's forward reads none of the quant leaves its
        # layers declare
        kw = {} if static else {"mutable": ["quant"]}
        with quant_rules_scope(rules), fnn.intercept_methods(
                qcommon._record(store, RECORDED)):
            model.apply(v, b, train=False, **kw)
        return store
    store = jax.jit(apply)(v, batch)
    layers = {p: (qcommon._arrays(i), qcommon._arrays(o))
              for p, (i, o) in store.items()}
    quant = jax.tree_util.tree_map(np.asarray, v.get("quant", {}))
    return {"layers": layers, "calls": rules.calls, "quant": quant}


def _port_run(ref, static):
    """The port's model under the recipe, calibrated by its own quant.api
    as ``_reference_run`` calibrates: its seed pass on the float weights,
    rounding as the jitted steps."""
    model = copy.deepcopy(ref["port"])
    seed = {k: v.clone() for k, v in model.state_dict().items()}
    seed_pass = port_api._calibration_pass
    with mock.patch.object(port_api, "_seed_state", lambda _: seed), \
            mock.patch.object(port_api, "_calibration_pass",
                              lambda m, b, eager=False: seed_pass(m, b)):
        port_api.quantize_model(model,
                                port_api.transfusion_recipe(static=static),
                                ref["port_batch"])
    if static:
        port_api.compute_amax(model, method="max")
    return model


@pytest.fixture(scope="module")
def tq():
    ref = common.build("transfusion_tiny")
    runs = {}
    for static in (False, True):
        run = _reference_run(ref, static)
        run["port"] = _port_run(ref, static)
        runs[static] = run
    return ref, runs


def test_transfusion_recipe_matches_reference(tq):
    """Rules and no_list equal to the reference's for every (sq, static),
    with its signature; each quantizable layer of the model resolves the
    rule the reference's layer resolved in its forward under
    ``transfusion_recipe()``: 20 sparse convs, 7 BEV convs (the stride-1
    deblock's 1x1 conv among them), the head's shared conv and heatmap
    block conv, and the decoder's 8 Linears and 4 Conv1ds quantized;
    conv_input, the heatmap's output conv, both out-projections, the class
    encoding, every prediction-head conv and the stride-2 deblock's
    transposed conv float."""
    for sq, static in itertools.product((False, True), repeat=2):
        kw = dict(sq=sq, static=static, alpha=0.4, w_bits=8, act_bits=8)
        ours, theirs = port_api.transfusion_recipe(**kw), \
            jax_api.transfusion_recipe(**kw)
        assert [dataclasses.asdict(r) for r in ours.rules] \
            == [dataclasses.asdict(r) for r in theirs.rules]
        assert ours.no_list == theirs.no_list
        for rule in ours.rules:
            for kind in rule.layer_kinds:
                port_api._check_rule(rule, "x", kind)
    assert inspect.signature(port_api.transfusion_recipe) \
        == inspect.signature(jax_api.transfusion_recipe)

    _, runs = tq
    calls, model = runs[False]["calls"], runs[False]["port"]
    recipe = jax_api.transfusion_recipe()
    seen = {}
    for name, mod in port_api.quantizable_modules(model):
        path = reference_module_path(name, mod)
        kind, rule = calls[path]
        assert kind == mod.QUANT_KIND, name
        assert (rule is None) == (mod.rule is None), name
        if rule is not None:
            assert dataclasses.asdict(rule) == dataclasses.asdict(mod.rule)
        assert rule == recipe.lookup(path, kind)
        seen[path] = mod.rule is not None
    assert set(seen) == set(calls)
    quantized = {p for p, q in seen.items() if q}
    assert len(quantized) == 20 + 7 + 2 + 8 + 4, sorted(quantized)
    for path in ("backbone_3d.conv_input.conv", "dense_head.heatmap_head_out",
                 "dense_head.decoder.self_attn.out_proj",
                 "dense_head.decoder.multihead_attn.out_proj",
                 "dense_head.class_encoding",
                 "dense_head.prediction_head.heatmap_0",
                 "dense_head.prediction_head.center_out",
                 "backbone_2d.deblocks_1.deconv"):
        assert not seen[path], path
    assert seen["backbone_2d.deblocks_0.conv"]


def _layer_output(mod, x):
    if isinstance(mod, SparseConv3d):
        return mod(qcommon._st(x), {}, None).features
    if isinstance(mod, SubMConv3d):
        return mod(qcommon._st(x), {}).features
    if isinstance(mod, (Conv2d, ConvTranspose2d)):
        return mod(qcommon._dense(x)).permute(0, 2, 3, 1)
    return mod(torch.from_numpy(np.array(x)))


def test_model_layers_under_recipe_match_reference(tq):
    """The model under the dynamic, then the static recipe; static: the
    port's own calibration (every quantizer the reference has, weight amax
    within 1e-6, act and column amax within 1e-2), then the reference's
    committed scales loaded.  Each conv, Linear and Conv1d fed the reference's input:
    SmoothQuant layers within 2e-3 of the output's scale, the rest within
    1e-5."""
    for static, run in tq[1].items():
        _check_model_layers(run, static)


def _check_model_layers(run, static):
    model = run["port"]
    if static:
        ours = {k: v.numpy() for k, v in model.state_dict().items()
                if k.endswith("amax")}
        theirs = {k: v.numpy() for k, v in
                  state_dict_from_jax({"quant": run["quant"]}).items()}
        assert set(ours) == set(theirs), sorted(set(ours) ^ set(theirs))
        assert sum(k.endswith("sq_act_amax") for k in ours) == 2 + 7 + 8
        for key, want in theirs.items():
            if ".weight_quant." in key:
                # a SmoothQuant layer's weight is migrated by the column
                # scale first, in which XLA's pow may round an ulp away
                np.testing.assert_allclose(ours[key], want, rtol=1e-6,
                                           err_msg=key)
            else:
                np.testing.assert_allclose(ours[key], want, rtol=AMAX_RTOL,
                                           err_msg=key)
        model = copy.deepcopy(model)
        model.load_state_dict(state_dict_from_jax({"quant": run["quant"]}),
                              strict=False)
    n = 0
    with torch.no_grad():
        for name, mod in port_api.quantizable_modules(model):
            path = reference_module_path(name, mod)
            if path not in run["layers"]:
                continue
            x, want = run["layers"][path]
            want = want["features"] if isinstance(want, dict) else want
            got = _layer_output(mod, x).numpy()
            assert got.shape == want.shape, path
            sq = mod.rule is not None and mod.rule.smoothquant is not None
            assert rel_err(got, want) <= (SQ_RTOL if sq else FLOAT_RTOL), \
                (path, rel_err(got, want))
            n += 1
    # 21 sparse, 8 BEV, 3 head convs, 10 Linears, 15 Conv1ds
    assert n == 21 + 8 + 3 + 10 + 15, n


def test_quant_transfusion_entry(monkeypatch):
    """``python -m q3d_tpu_torch.tools.quant_transfusion`` on the tiny
    config (seeded weights, 2 frames, the CPU): the driver evaluates the
    fp32 model, quantizes it under ``transfusion_recipe`` (dynamic
    SmoothQuant) and evaluates it again, with the same metrics."""
    from q3d_tpu_torch.tools import quant_driver
    runs = []
    real_run = quant_driver.run
    monkeypatch.setattr(quant_driver, "run",
                        lambda name, **kw: runs.append(real_run(name, **kw)))
    monkeypatch.setattr(sys, "argv", [
        "quant_transfusion", "--cfg_file",
        str(common.CFG_DIR / "transfusion_tiny.yaml"), "--device", "cpu",
        "--set", "DATA_CONFIG.NUM_FRAMES", "2"])
    runpy.run_module("q3d_tpu_torch.tools.quant_transfusion",
                     run_name="__main__")
    (fp, q), = runs
    assert fp and set(q) == set(fp)
    assert all(np.isfinite(v) for v in q.values()
               if isinstance(v, (int, float)))
