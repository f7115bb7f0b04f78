"""Shared body of the int8 deploy parity tests (``test_torch_port_quant*.py``,
``test_torch_port_deploy*.py``) and the fake-quant ones.

One recipe per test file, so that ``--dist loadfile`` gives them to
separate workers.  Each builds the reference on ``centerpoint_tiny`` with
the trained fixture (test split, batch 2, f32 inputs), calibrates it with
the reference's own ``quantize_model`` -> ``collect_stats`` (the batch
given twice) -> ``compute_amax(method="max")`` (a dynamic recipe needs
none), and applies it once while recording every layer's input and
output.  The port is
calibrated on the same batch by its own ``quant.api``, with the reference's
initial weights for the seed pass (the reference's ``quantize_model`` runs
``model.init``, whose pass fixes the histogram's first bin width; the port's
``quant.api._seed_state`` is replaced for that).
"""

import copy
import pickle
from unittest import mock

import flax
import flax.linen as fnn
import jax
import numpy as np
import torch

from q3d_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
from q3d_tpu.config import EDict as JaxEDict
from q3d_tpu.datasets import build_dataloader as jax_build_dataloader
from q3d_tpu.models import build_network as jax_build_network
from q3d_tpu.models import load_data_to_device as jax_load_data_to_device
from q3d_tpu.models import layers as jax_layers
from q3d_tpu.models.backbones_2d import base_bev_backbone as jax_bev
from q3d_tpu.models.backbones_3d import spconv_backbone as jax_sparse
from q3d_tpu.ops.spconv import modules as jax_spmodules
from q3d_tpu.quant import api as jax_quant
from q3d_tpu.quant.rules import quant_rules_scope
from q3d_tpu.utils.checkpoint import load_checkpoint

from q3d_tpu_torch.config import cfg_from_yaml_file, EDict
from q3d_tpu_torch.datasets import build_dataloader
from q3d_tpu_torch.models import build_network, load_data_to_device
from q3d_tpu_torch.models.backbones_3d.spconv_backbone import (
    _capacity_schedule)
from q3d_tpu_torch.models.layers import QTensor, requant_epilogue
from q3d_tpu_torch.ops.spconv import SparseConvTensor, SparseConv3d
from q3d_tpu_torch.ops.spconv.modules import Requant
from q3d_tpu_torch.quant import api as port_quant
from q3d_tpu_torch.utils.weights import state_dict_from_jax

from test_torch_port_centerpoint import CFG_DIR, CKPT

BENCH = dict(quantize_first_conv=True, extra_no_list=("dense_head.*",))
ENTRY = {}
# (c): at most this share of a layer's int8 outputs may differ, each by
# exactly 1 (rsqrt rounds differently by an ulp in XLA and PyTorch, which
# moves the BN fold's k and so y / s across a rounding boundary)
OFF_BY_ONE_SHARE = 1e-3
_RECORDED = (jax_spmodules.SubMConv3d, jax_spmodules.SparseConv3d,
             jax_sparse._SparseConvBNReLU, jax_sparse.SparseBasicBlock,
             jax_layers.Conv2d, jax_layers.DenseRequant, jax_bev._Block)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(
        jax.device_get(tree)))


def _record(store, recorded=_RECORDED):
    """flax interceptor: the first positional input of every recorded
    module call, and its output, by the module's dotted path."""
    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        mod = context.module
        if context.method_name == "__call__" and isinstance(mod, recorded):
            path = ".".join(str(p) for p in mod.path)
            store[path] = (args[0], out)
        return out
    return interceptor


def _arrays(x):
    """A recorded value -> numpy: SparseConvTensor / QTensor -> dict, an
    int-mode quantizer's (int8, scale) -> tuple."""
    if isinstance(x, tuple) and not hasattr(x, "_fields"):
        return tuple(np.asarray(v) for v in x)
    if isinstance(x, jax_layers.QTensor):
        return {"data": np.asarray(x.data), "scale": np.asarray(x.scale)}
    if hasattr(x, "features"):
        return {"features": np.asarray(x.features),
                "indices": np.asarray(x.indices),
                "feat_scale": None if x.feat_scale is None
                else np.asarray(x.feat_scale),
                "spatial_shape": tuple(x.spatial_shape),
                "batch_size": x.batch_size}
    if isinstance(x, dict):
        return None
    return np.asarray(x)


def reference(recipe):
    """The int8 deploy recipe ``recipe`` (residency), calibrated on the
    batch given twice, method "max" -> see ``_reference_run``."""
    return _reference_run(
        lambda: jax_quant.int8_deploy_recipe(residency=True, **recipe),
        calib_batches=2, method="max")


def reference_fake(recipe, calib_batches=0, method="max", jit_init=False):
    """``centerpoint_recipe(**recipe)``, calibrated on the batch given
    ``calib_batches`` times (0: dynamic, none) -> see ``_reference_run``.
    ``jit_init``: build the quantized variables with a jitted
    ``model.init`` under the rules instead of ``quantize_model``'s eager
    one (the same tree; only the seed pass's calibration state may round
    differently)."""
    return _reference_run(lambda: jax_quant.centerpoint_recipe(**recipe),
                          calib_batches, method, jit_init)


def reference_static(recipe, calib_batches, method):
    """The static ``int8_deploy_recipe(**recipe)``, its seed pass a jitted
    ``model.init``, calibrated on the batch given ``calib_batches`` times
    -> see ``_reference_run``."""
    return _reference_run(lambda: jax_quant.int8_deploy_recipe(**recipe),
                          calib_batches, method, jit_init=True)


def reference_model(template=True):
    """The reference's centerpoint_tiny model with the trained fixture, its
    first test batch (frames 0-1) and (``template``) its initial variables,
    whose jitted ``model.init`` also gives ``load_checkpoint`` its tree;
    without, the fixture is read by flax's ``msgpack_restore`` alone."""
    cfg = jax_cfg_from_yaml(str(CFG_DIR / "centerpoint_tiny.yaml"), JaxEDict())
    ds, loader, _ = jax_build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                         batch_size=2, training=False)
    model = jax_build_network(cfg.MODEL, num_class=len(cfg.CLASS_NAMES),
                              dataset=ds)
    raw = next(iter(loader))
    batch = jax_load_data_to_device(raw)
    ref = {"raw": raw, "cfg": cfg, "model": model, "batch": batch}
    if not template:
        with open(CKPT, "rb") as f:
            variables = flax.serialization.msgpack_restore(
                pickle.load(f)["model_state"])
        return {**ref, "variables": variables, "float": _np(variables)}
    template = jax.jit(lambda k, b: model.init(k, b, train=False))(
        jax.random.PRNGKey(0), batch)
    variables, _, _, _ = load_checkpoint(str(CKPT), template)
    return {**ref, "variables": variables,
            "float": _np({k: variables[k] for k in ("params", "batch_stats")}),
            "init": _np({k: template[k] for k in ("params", "batch_stats")})}


def _reference_run(make_rules, calib_batches, method, jit_init=False):
    """-> dict: float variables, initial variables, the committed quant
    tree, per-layer records {path: (input, output)}, final outputs."""
    ref = reference_model(template=not jit_init)
    model, batch, variables = ref["model"], ref["batch"], ref.pop("variables")
    rules = make_rules()
    if jit_init:
        with quant_rules_scope(rules):
            v8 = dict(jax.jit(lambda k, b: model.init(k, b, train=False))(
                jax.random.PRNGKey(0), batch))
        ref["init"] = _np({k: v8[k] for k in ("params", "batch_stats")})
        v8.update({k: variables[k] for k in ("params", "batch_stats")})
    else:
        v8 = jax_quant.quantize_model(model, variables, rules, batch)
    if calib_batches:
        v8 = jax_quant.collect_stats(model, v8, rules, [batch] * calib_batches,
                                     num_batches=calib_batches,
                                     loader_to_device=lambda b: b)
        v8 = jax_quant.compute_amax(v8, method=method)
    calib = _np(v8["calib"]) if calib_batches else None
    v8 = {k: v for k, v in v8.items() if k != "calib"}

    return {**ref, "calib": calib, "rules": rules, "vars": v8,
            "quant": _np(v8["quant"]),
            **_recorded_forward(model, rules, v8, batch)}


def _recorded_forward(model, rules, variables, batch, extra=()):
    """One jitted reference forward under ``rules`` -> {"layers": per-layer
    records {path: (input, output)} of the ``_RECORDED`` module types and
    ``extra`` ones, "out": the final outputs}."""
    def apply(v, b):
        store = {}
        with quant_rules_scope(rules), fnn.intercept_methods(
                _record(store, _RECORDED + tuple(extra))):
            out = model.apply(v, b, train=False)
        keep = ("spatial_features", "spatial_features_2d", "final_boxes",
                "final_scores", "final_labels", "final_valid")
        return {k: out[k] for k in keep}, store

    out, store = jax.jit(apply)(variables, batch)
    return {"layers": {p: (_arrays(i), _arrays(o))
                       for p, (i, o) in store.items()},
            "out": {k: np.asarray(v) for k, v in out.items()}}


def reference_dynamic(recipe, extra=()):
    """The reference under ``int8_deploy_recipe(**recipe)``, a dynamic
    recipe, which has nothing to calibrate: its float variables applied
    under the rules -> ``reference_model``'s dict with the rules, the
    per-layer records (``extra``: more module types recorded) and the
    outputs."""
    ref = reference_model(template=False)
    rules = jax_quant.int8_deploy_recipe(**recipe)
    return {**ref, "rules": rules,
            **_recorded_forward(ref["model"], rules, ref["variables"],
                                ref["batch"], extra)}


def port(ref, recipe):
    """-> (port model under ``int8_deploy_recipe(residency=True,
    **recipe)``, calibrated by its own quant.api, its batch)."""
    def prepare(model, batch):
        port_quant.prepare_int8_deploy(model, [batch, batch],
                                       recipe_kwargs=recipe)
    return _port_run(ref, prepare)


def port_dynamic(ref, recipe):
    """-> (port model under the dynamic ``int8_deploy_recipe(**recipe)``,
    its batch).  The seed pass only creates the quantizers here, so it
    runs on the port's own initial weights."""
    model, batch = port_model(ref)
    port_quant.quantize_model(model, port_quant.int8_deploy_recipe(**recipe),
                              batch)
    return model, batch


def port_fake(ref, recipe, calib_batches=0, method="max"):
    """-> (port model under ``centerpoint_recipe(**recipe)``, calibrated by
    its own quant.api as ``reference_fake`` calibrates, its batch)."""
    def prepare(model, batch):
        port_quant.quantize_model(model,
                                  port_quant.centerpoint_recipe(**recipe), batch)
        if calib_batches:
            port_quant.collect_stats(model, [batch] * calib_batches,
                                     calib_batches)
            port_quant.compute_amax(model, method=method)
    return _port_run(ref, prepare)


def port_static(ref, recipe, calib_batches, method):
    """-> (port model under the static ``int8_deploy_recipe(**recipe)``,
    calibrated by its own quant.api as ``reference_static`` calibrates, its
    batch).  The reference's seed pass is jitted there, so the port's seed
    pass rounds as the jitted steps do (``eager=False``)."""
    seed_pass = port_quant._calibration_pass

    def prepare(model, batch):
        with mock.patch.object(port_quant, "_calibration_pass",
                               lambda m, b, eager=False: seed_pass(m, b)):
            port_quant.quantize_model(
                model, port_quant.int8_deploy_recipe(**recipe), batch)
        port_quant.collect_stats(model, [batch] * calib_batches,
                                 calib_batches)
        port_quant.compute_amax(model, method=method)
    return _port_run(ref, prepare)


def port_model(ref):
    """-> (the port's float centerpoint_tiny with the reference's trained
    weights, on the CPU, its first test batch)."""
    cfg = cfg_from_yaml_file(str(CFG_DIR / "centerpoint_tiny.yaml"), EDict())
    ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                     batch_size=2, training=False)
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), ds, device="cpu")
    model.load_state_dict(state_dict_from_jax(ref["float"]), strict=True)
    return model, load_data_to_device(next(iter(loader)), device="cpu")


def _port_run(ref, prepare):
    model, batch = port_model(ref)
    seed = state_dict_from_jax(ref["init"])
    with mock.patch.object(port_quant, "_seed_state", lambda _: seed):
        prepare(model, batch)
    return model, batch


def amax_pairs(model, ref):
    """{port buffer: (port amax, reference amax)} and the two key sets."""
    ours = {k: v.numpy() for k, v in model.state_dict().items()
            if k.endswith(".amax")}
    theirs = {k: v.numpy() for k, v in
              state_dict_from_jax({"quant": ref["quant"]}).items()}
    return ours, theirs


def _st(rec):
    return SparseConvTensor(
        features=torch.from_numpy(rec["features"].copy()),
        indices=torch.from_numpy(rec["indices"].copy()),
        spatial_shape=rec["spatial_shape"], batch_size=rec["batch_size"],
        sorted_rows=True,
        feat_scale=None if rec["feat_scale"] is None
        else torch.from_numpy(rec["feat_scale"].copy()))


def _dense(rec):
    """A recorded NHWC input -> the port's NCHW (QTensor or tensor)."""
    if isinstance(rec, dict):
        data = torch.from_numpy(rec["data"].copy()).permute(0, 3, 1, 2)
        return QTensor(data, torch.from_numpy(rec["scale"].copy()))
    x = torch.from_numpy(rec.astype(np.float32)).permute(0, 3, 1, 2)
    return x.to(torch.bfloat16) if rec.dtype.name == "bfloat16" else x


def residency_layers(model, ref):
    """Each residency layer fed the reference's own input (int8, or the
    float map a chain starts from) -> list of (name, port int8 output,
    reference int8 output) as numpy (NHWC for the dense maps).  The head's
    shared conv -> BN -> ReLU -> DenseRequant counts as one layer, whose
    int8 output is the DenseRequant's."""
    layers = ref["layers"]
    bb3 = model.backbone_3d
    caps = _capacity_schedule(bb3.model_cfg, 2 * int(
        ref["raw"]["voxel_coords"].shape[1]))
    cap_of = {"conv2": caps["x_conv2"], "conv3": caps["x_conv3"],
              "conv4": caps["x_conv4"], "conv_out": caps["out"]}
    results = []
    with torch.no_grad():
        for name, mod in bb3.named_children():
            blocks = [("", mod)] if name in ("conv_input", "conv_out") \
                else [(f"_{i}", b) for i, b in enumerate(mod)]
            for suffix, blk in blocks:
                path = f"backbone_3d.{name}{suffix}"
                if path not in layers:
                    continue
                x_in, y_out = layers[path]
                if hasattr(blk, "conv1"):                 # SparseBasicBlock
                    if not blk.conv1.residency:
                        continue
                    spec = blk.conv1.rule.act
                    x1 = layers[f"{path}.conv2"][0]
                    y1 = blk.conv1(_st(x_in), {},
                                   requant=Requant(*blk.bn1.fold(), spec))
                    results.append((f"{path}.conv1", y1.features.numpy(),
                                    x1["features"]))
                    y2 = blk.conv2(_st(x1), {}, requant=Requant(
                        *blk.bn2.fold(), spec, _st(x_in)))
                    results.append((f"{path}.conv2", y2.features.numpy(),
                                    y_out["features"]))
                    continue
                conv = blk[0]
                if not conv.residency:
                    continue
                args = (cap_of[name],) if isinstance(conv, SparseConv3d) else ()
                y = blk(_st(x_in), {}, *args)
                results.append((path, y.features.numpy(), y_out["features"]))
        for b, blk in enumerate(model.backbone_2d.blocks):
            conv0 = blk[1]
            if not conv0.residency:
                continue
            spec = conv0.rule.act
            for j in range(1, len(blk), 3):
                c = (j - 1) // 3
                path = f"backbone_2d.blocks_{b}.conv{c}"
                nxt = f"backbone_2d.blocks_{b}.conv{c + 1}"
                want = layers[nxt][0] if nxt in layers \
                    else layers[f"backbone_2d.blocks_{b}"][1]
                y = requant_epilogue(blk[j], blk[j](_dense(layers[path][0])),
                                     *blk[j + 1].fold(), spec)
                results.append((path, y.data.permute(0, 2, 3, 1).numpy(),
                                want["data"]))
        head = model.dense_head
        if getattr(head, "shared_requant", None) is not None \
                and head.shared_requant.residency:
            x = _dense(layers["dense_head.shared_conv"][0])
            y = head.shared_requant(head.shared_conv(x))
            results.append(("dense_head.shared_requant",
                            y.data.permute(0, 2, 3, 1).numpy(),
                            layers["dense_head.shared_requant"][1]["data"]))
    return results


def head_branch_convs(model, ref):
    """Each int8 hidden conv of the head's branches fed the reference's own
    input (the int8 shared map) -> list of (path, port f32 output,
    reference f32 output), NHWC: a residency Conv2d hands back its raw f32
    (+ bias) for the float BN after it."""
    layers = ref["layers"]
    results = []
    with torch.no_grad():
        for h, sep in enumerate(model.dense_head.heads_list):
            for name in sep.names:
                for k, blk in enumerate(getattr(sep, name)[:-1]):
                    if blk[0].rule is None:
                        continue
                    path = f"dense_head.heads_list_{h}.{name}_{k}"
                    x_in, y_out = layers[path]
                    y = blk[0](_dense(x_in))
                    results.append((path, y.permute(0, 2, 3, 1).numpy(),
                                    y_out))
    return results


def check_head_branch_convs(model, ref, expected_layers, rtol):
    """Every int8 hidden branch conv's f32 output within ``rtol`` of the
    reference's largest magnitude."""
    results = head_branch_convs(model, ref)
    assert len(results) == expected_layers, [r[0] for r in results]
    worst = 0.0
    for name, ours, theirs in results:
        assert ours.dtype == np.float32 and ours.shape == theirs.shape, name
        err = float(np.abs(ours - theirs).max() / np.abs(theirs).max())
        assert err <= rtol, (name, err)
        worst = max(worst, err)
    return worst


def with_reference_amax(model, ref):
    """A copy of ``model`` carrying the reference's committed amax, loaded
    through the weights carry-over (every amax key must match)."""
    m = copy.deepcopy(model)
    res = m.load_state_dict(state_dict_from_jax({"quant": ref["quant"]}),
                            strict=False)
    assert not res.unexpected_keys, res.unexpected_keys
    assert not [k for k in res.missing_keys if k.endswith(".amax")], res
    return m


def check_same_layers(model, ref):
    """(a): one port quantizer per reference amax leaf, none extra."""
    ours, theirs = amax_pairs(model, ref)
    assert set(ours) == set(theirs), sorted(set(ours) ^ set(theirs))
    return len(ours)


def check_amax(model, ref, act_rtol):
    """(b): the port's own calibration -> weight amax equal, activation and
    output amax within ``act_rtol``."""
    ours, theirs = amax_pairs(model, ref)
    worst = 0.0
    for key, want in theirs.items():
        got = ours[key]
        if ".weight_quant." in key:
            np.testing.assert_array_equal(got, want, err_msg=key)
        else:
            np.testing.assert_allclose(got, want, rtol=act_rtol, atol=0,
                                       err_msg=key)
            worst = max(worst, float(np.abs(got - want).max() / np.abs(want).max()))
    return worst


def check_residency_layers(model, ref, expected_layers):
    """(c): every residency layer's int8 output equals the reference's but
    at <= OFF_BY_ONE_SHARE of its elements, each off by exactly 1."""
    results = residency_layers(model, ref)
    assert len(results) == expected_layers, [r[0] for r in results]
    report = {}
    for name, ours, theirs in results:
        assert ours.dtype == np.int8 and ours.shape == theirs.shape, name
        diff = np.abs(ours.astype(np.int32) - theirs.astype(np.int32))
        assert diff.max() <= 1, (name, int(diff.max()))
        share = float((diff > 0).mean())
        assert share <= OFF_BY_ONE_SHARE, (name, share)
        report[name] = share
    return report


def forward(model, batch, ref):
    """One port forward; asserts spatial_features (bf16, as the reference
    dequantizes) within 1e-2 of their max, and the same valid count."""
    with torch.no_grad():
        out = model(dict(batch))
    jout = ref["out"]
    sf = out["spatial_features"].float().numpy()
    jsf = jout["spatial_features"].astype(np.float32).transpose(0, 3, 1, 2)
    assert out["spatial_features"].dtype == torch.bfloat16
    assert np.abs(sf - jsf).max() <= 1e-2 * np.abs(jsf).max()
    np.testing.assert_array_equal(out["final_valid"].numpy(),
                                  jout["final_valid"])
    assert jout["final_valid"].sum() > 5                # it detects
    return {k: v.numpy() for k, v in out.items()
            if k.startswith("final_")}, jout


def check_detections_equal(out, jout, tol):
    """(d), slot for slot: validity and labels equal, boxes and scores
    within ``tol`` where valid."""
    valid = jout["final_valid"]
    np.testing.assert_array_equal(out["final_labels"][valid],
                                  jout["final_labels"][valid])
    for key in ("final_boxes", "final_scores"):
        np.testing.assert_allclose(out[key][valid], jout[key][valid],
                                   rtol=tol, atol=tol, err_msg=key)


def check_detections_matched(out, jout, box_tol, score_tol):
    """(d), as sets: every valid reference detection has a port detection
    of the same frame and label with its box within ``box_tol`` and score
    within ``score_tol`` (two near-equal scores may swap slots)."""
    worst = [0.0, 0.0]
    for i in range(jout["final_valid"].shape[0]):
        va, vb = jout["final_valid"][i], out["final_valid"][i]
        for box, label, score in zip(jout["final_boxes"][i][va],
                                     jout["final_labels"][i][va],
                                     jout["final_scores"][i][va]):
            same = out["final_labels"][i][vb] == label
            assert same.any(), (i, label)
            db = np.abs(out["final_boxes"][i][vb][same] - box).max(-1)
            ds = np.abs(out["final_scores"][i][vb][same] - score)
            k = int(np.argmin(db))
            assert db[k] <= box_tol and ds[k] <= score_tol, \
                (i, label, float(db[k]), float(ds[k]))
            worst = [max(worst[0], float(db[k])), max(worst[1], float(ds[k]))]
    return worst


def _capacities(model, ref):
    caps = _capacity_schedule(model.backbone_3d.model_cfg, 2 * int(
        ref["raw"]["voxel_coords"].shape[1]))
    return {"conv2_0": caps["x_conv2"], "conv3_0": caps["x_conv3"],
            "conv4_0": caps["x_conv4"], "conv_out": caps["out"]}


def conv_layers(model, ref):
    """Every conv of the port (sparse and dense, quantized or not) fed the
    reference's own input -> list of (reference path, quantized?, port
    output, reference output), numpy, dense maps NHWC."""
    from q3d_tpu_torch.models.layers import Conv2d
    from q3d_tpu_torch.ops.spconv import SubMConv3d
    from q3d_tpu_torch.utils.weights import reference_module_path

    layers = ref["layers"]
    caps = _capacities(model, ref)
    results = []
    with torch.no_grad():
        for name, mod in model.named_modules():
            path = reference_module_path(name)
            if path not in layers:
                continue
            x, y = layers[path]
            if isinstance(mod, SparseConv3d):
                out = mod(_st(x), {}, caps[path.split(".")[1]]).features
                want = y["features"]
            elif isinstance(mod, SubMConv3d):
                out, want = mod(_st(x), {}).features, y["features"]
            elif isinstance(mod, Conv2d):
                out, want = mod(_dense(x)).permute(0, 2, 3, 1), y
            else:
                continue
            results.append((path, mod.rule is not None, out.numpy(), want))
    return results


def check_conv_layers(model, ref, expected, sparse_rtol, dense_rtol):
    """Each conv fed the reference's own input: sparse convs and float
    dense convs within ``sparse_rtol`` of the output's largest magnitude
    (f32 summation order), quantized dense convs within ``dense_rtol`` ->
    {path: relative max error}."""
    results = conv_layers(model, ref)
    assert len(results) == expected, [r[0] for r in results]
    report = {}
    for path, quantized, ours, theirs in results:
        assert ours.shape == theirs.shape, path
        err = float(np.abs(ours - theirs).max() / np.abs(theirs).max())
        tol = dense_rtol if quantized and path.startswith(
            ("backbone_2d", "dense_head")) else sparse_rtol
        assert err <= tol, (path, err, tol)
        report[path] = err
    return report


def check_detections_near(out, jout, box_tol, score_tol, min_score,
                          max_count_diff, min_share):
    """(d), as sets, for recipes whose float fake-quant flips roundings:
    the valid counts differ by at most ``max_count_diff``, and at least
    ``min_share`` of the valid detections of either run scoring >=
    ``min_score`` have a partner of the same frame and label in the other
    within ``box_tol`` and ``score_tol`` -> (matched share, worst box
    diff, worst score diff)."""
    assert abs(int(out["final_valid"].sum()) - int(jout["final_valid"].sum())) \
        <= max_count_diff
    worst = [0.0, 0.0]
    n = matched = 0
    for a, b in ((jout, out), (out, jout)):
        for i in range(a["final_valid"].shape[0]):
            va, vb = a["final_valid"][i], b["final_valid"][i]
            for box, label, score in zip(a["final_boxes"][i][va],
                                         a["final_labels"][i][va],
                                         a["final_scores"][i][va]):
                if score < min_score:
                    continue
                n += 1
                same = b["final_labels"][i][vb] == label
                if not same.any():
                    continue
                db = np.abs(b["final_boxes"][i][vb][same] - box).max(-1)
                ds = np.abs(b["final_scores"][i][vb][same] - score)
                k = int(np.argmin(db))
                if db[k] <= box_tol and ds[k] <= score_tol:
                    matched += 1
                    worst = [max(worst[0], float(db[k])),
                             max(worst[1], float(ds[k]))]
    assert n > 10 and matched >= min_share * n, (matched, n)
    return matched / n, *worst


def float_copy(model):
    """A copy of a quantized port model with every rule detached (float)."""
    m = copy.deepcopy(model)
    for _, mod in port_quant.quantizable_modules(m):
        mod.rule = None
    return m


def reference_l1_rows(ref):
    """The reference's ``layer_l1_diff`` rows on its quantized variables
    and batch (its captures jitted, as its eval step is)."""
    from q3d_tpu.quant import sensitivity as jax_sens
    capture = jax_sens.capture_layer_outputs
    jitted = jax.jit(lambda v, b, rules: capture(ref["model"], v, b,
                                                 rules=rules),
                     static_argnums=2)
    with mock.patch.object(jax_sens, "capture_layer_outputs",
                           lambda m, v, b, rules=None: jitted(v, b, rules)):
        return jax_sens.layer_l1_diff(ref["model"], ref["vars"], ref["batch"],
                                      ref["rules"], top=1000)
