"""Shared body of the anchor-head parity tests (``test_torch_port_second.py``,
``test_torch_port_pointpillar.py``): both packages on one tiny model.

No trained SECOND or PointPillars weights are in the repository, so the
reference's variable tree (``jax.eval_shape`` of ``model.init``) is filled
from a seeded numpy generator as the reference initialises it, carried to
the port with ``state_dict_from_jax`` and then made to carry a signal: every BN's
running statistics are set to the batch statistics of its input on the
first test batch (taken by the port, written back into the reference's
variables, so that both hold the same values), and ``conv_cls``'s bias is
0 (the initialiser's) instead of the trained head's -4.6, so that scores
sit around 0.5 and the score threshold, the sort and NMS all have work.
The same variables then go through both packages on that batch, in f32;
under a (dynamic) recipe the reference's quant collections are zeros of
the shapes its ``model.init`` under the rules gives (its forward reads
none of them) and every conv's input and output is recorded.
"""

import copy

import flax
import flax.linen as fnn
import jax
import numpy as np
import torch

from q3d_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
from q3d_tpu.config import EDict as JaxEDict
from q3d_tpu.datasets import build_dataloader as jax_build_dataloader
from q3d_tpu.models import build_network as jax_build_network
from q3d_tpu.models import layers as jax_layers
from q3d_tpu.models import load_data_to_device as jax_load_data_to_device
from q3d_tpu.ops.spconv import modules as jax_spmodules
from q3d_tpu.quant.rules import quant_rules_scope

from q3d_tpu_torch.config import cfg_from_yaml_file, EDict
from q3d_tpu_torch.datasets import build_dataloader
from q3d_tpu_torch.models import build_network, load_data_to_device
from q3d_tpu_torch.models.layers import Conv2d
from q3d_tpu_torch.ops.spconv import SparseConv3d, SubMConv3d
from q3d_tpu_torch.quant import api as port_api
from q3d_tpu_torch.utils.bn_calibration import calibrate_bns
from q3d_tpu_torch.utils.weights import pcdet_name, reference_module_path
from q3d_tpu_torch.utils.weights import state_dict_from_jax

import torch_port_quant_common as common
from test_torch_port_centerpoint import CFG_DIR

MAP_RTOL = 1e-5         # each map: f32 sums in another order
# decoded and final boxes: within BOX_ATOL + BOX_RTOL * |value|; the
# relative term carries the maps' 1e-6-of-scale differences through the
# decode (x = xt * diagonal + xa at |x| up to 40 m: a few ulps of x)
BOX_ATOL, BOX_RTOL = 1e-4, 1e-5
SCORE_ATOL = 1e-5
HEAD_CONVS = ("conv_cls", "conv_box", "conv_dir_cls")
OUT_KEYS = ("spatial_features", "spatial_features_2d", "batch_cls_preds",
            "batch_box_preds", "final_boxes", "final_scores", "final_labels",
            "final_valid")


def configs(name, keep_roi_head=False):
    """Both packages' configs of ``synthetic_models/<name>.yaml``, each read
    by its own reader; second_iou_tiny becomes plain SECOND unless
    ``keep_roi_head``."""
    cfgs = (jax_cfg_from_yaml(str(CFG_DIR / f"{name}.yaml"), JaxEDict()),
            cfg_from_yaml_file(str(CFG_DIR / f"{name}.yaml"), EDict()))
    if name == "second_iou_tiny" and not keep_roi_head:
        for cfg in cfgs:
            cfg.MODEL.NAME = "SECONDNet"
            del cfg.MODEL["ROI_HEAD"]
    return cfgs


def _set_leaves(tree, state, prefix=()):
    """Write the port's state into the reference's numpy variables, leaf by
    leaf, through the same naming rules."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _set_leaves(v, state, prefix + (k,))
        elif prefix[0] == "batch_stats":
            v[...] = state[pcdet_name(prefix + (k,), None)].numpy()


def _seeded_variables(shapes, seed=0):
    """The reference's variable tree (shapes from ``jax.eval_shape``) filled
    from numpy as the reference initialises it: kernels U(-1/sqrt(fan_in),
    1/sqrt(fan_in)) (its variance_scaling(1/3, fan_in, uniform)), biases 0,
    BN scales 1, running means 0 and variances 1."""
    rng = np.random.RandomState(seed)

    def fill(path, s):
        leaf = path[-1].key
        if leaf in ("kernel", "weight"):
            bound = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
            return rng.uniform(-bound, bound, s.shape).astype(s.dtype)
        return (np.ones if leaf in ("scale", "var") else np.zeros)(
            s.shape, s.dtype)
    return flax.core.unfreeze(jax.tree_util.tree_map_with_path(fill, shapes))


def build(name, keep_roi_head=False):
    """-> dict: the reference's model, batch and variables, the port's model
    (holding the same variables) and batch, and both configs."""
    # a one-argument ``configs`` stays patchable (test_torch_port_voxelnext_
    # quant.py swaps in its own)
    jcfg, pcfg = configs(name, keep_roi_head=True) if keep_roi_head \
        else configs(name)
    jds, jloader, _ = jax_build_dataloader(jcfg.DATA_CONFIG, jcfg.CLASS_NAMES,
                                           batch_size=2, training=False)
    jmodel = jax_build_network(jcfg.MODEL, num_class=len(jcfg.CLASS_NAMES),
                               dataset=jds)
    jbatch = jax_load_data_to_device(next(iter(jloader)))
    variables = _seeded_variables(jax.eval_shape(
        lambda k, b: jmodel.init(k, b, train=False), jax.random.PRNGKey(0),
        jbatch))

    ds, loader, _ = build_dataloader(pcfg.DATA_CONFIG, pcfg.CLASS_NAMES,
                                     batch_size=2, training=False)
    model = build_network(pcfg.MODEL, len(pcfg.CLASS_NAMES), ds, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    batch = load_data_to_device(next(iter(loader)), device="cpu")
    calibrate_bns(model, batch)
    _set_leaves(variables, model.state_dict())
    return {"model": jmodel, "batch": jbatch, "vars": variables,
            "port": model, "port_batch": batch, "cfg": pcfg}


def build_for_training(name):
    """-> dict: the reference's model and its seeded variables as a
    training run starts them (BN statistics 0 and 1), the port's model
    holding the same variables, and the port's config."""
    jcfg, pcfg = configs(name)
    jds, jloader, _ = jax_build_dataloader(jcfg.DATA_CONFIG, jcfg.CLASS_NAMES,
                                           batch_size=1, training=False)
    jmodel = jax_build_network(jcfg.MODEL, num_class=len(jcfg.CLASS_NAMES),
                               dataset=jds)
    variables = _seeded_variables(jax.eval_shape(
        lambda k, b: jmodel.init(k, b, train=False), jax.random.PRNGKey(0),
        jax_load_data_to_device(next(iter(jloader)))))
    ds, _, _ = build_dataloader(pcfg.DATA_CONFIG, pcfg.CLASS_NAMES,
                                batch_size=1, training=False)
    model = build_network(pcfg.MODEL, len(pcfg.CLASS_NAMES), ds, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return {"model": jmodel, "vars": variables, "port": model, "cfg": pcfg}


def reference_forward(ref, rules=None, variables=None):
    """One jitted reference forward -> (outputs, the head's conv maps NCHW,
    {path: (input, output)} of every conv)."""
    recorded = (jax_spmodules.SubMConv3d, jax_spmodules.SparseConv3d,
                jax_layers.Conv2d)

    def apply(v, b):
        store = {}
        with quant_rules_scope(rules), fnn.intercept_methods(
                common._record(store, recorded)):
            out = ref["model"].apply(v, b, train=False)
        return {k: out[k] for k in OUT_KEYS}, store

    out, store = jax.jit(apply)(variables or ref["vars"], ref["batch"])
    layers = {p: (common._arrays(i), common._arrays(o))
              for p, (i, o) in store.items()}
    maps = {k: layers[f"dense_head.{k}"][1].transpose(0, 3, 1, 2)
            for k in HEAD_CONVS}
    return {k: np.asarray(v) for k, v in out.items()}, maps, layers


def port_forward(model, batch):
    with torch.no_grad():
        out = model(dict(batch))
    return {k: v.numpy() for k, v in out.items()
            if isinstance(v, torch.Tensor)}


def check_maps(out, jout, jmaps):
    """Every intermediate map within MAP_RTOL of its largest magnitude ->
    {map: relative max error}."""
    pairs = {k: (out[k], jout[k].transpose(0, 3, 1, 2))
             for k in ("spatial_features", "spatial_features_2d")}
    pairs.update({k: (out[p], jmaps[k]) for k, p in (
        ("conv_cls", "cls_preds"), ("conv_box", "box_preds"),
        ("conv_dir_cls", "dir_cls_preds"))})
    report = {}
    for key, (ours, theirs) in pairs.items():
        assert ours.shape == theirs.shape, key
        scale = float(np.abs(theirs).max())
        assert scale > 1e-2, (key, scale)             # a signal, not zeros
        err = float(np.abs(ours - theirs).max()) / scale
        assert err <= MAP_RTOL, (key, err)
        report[key] = err
    return report


def check_decoded(out, jout):
    """The decoded per-anchor predictions within BOX_ATOL + BOX_RTOL."""
    for key in ("batch_cls_preds", "batch_box_preds"):
        assert out[key].shape == jout[key].shape, key
        np.testing.assert_allclose(out[key], jout[key], rtol=BOX_RTOL,
                                   atol=BOX_ATOL, err_msg=key)


def check_detections(out, jout):
    """Slot for slot: valid and labels equal, boxes within BOX_ATOL +
    BOX_RTOL and scores within SCORE_ATOL where valid."""
    valid = jout["final_valid"]
    np.testing.assert_array_equal(out["final_valid"], valid)
    assert valid.sum() > 10
    np.testing.assert_array_equal(out["final_labels"][valid],
                                  jout["final_labels"][valid])
    np.testing.assert_allclose(out["final_boxes"][valid],
                               jout["final_boxes"][valid], rtol=BOX_RTOL,
                               atol=BOX_ATOL)
    np.testing.assert_allclose(out["final_scores"][valid],
                               jout["final_scores"][valid], rtol=0,
                               atol=SCORE_ATOL)


def quantized(ref, port_rules, jax_rules):
    """The recipe on both sides -> (the reference's outputs and per-conv
    records, the port's quantized model)."""
    with quant_rules_scope(jax_rules):
        shapes = jax.eval_shape(
            lambda k, b: ref["model"].init(k, b, train=False),
            jax.random.PRNGKey(0), ref["batch"])
    # a dynamic recipe's forward reads none of its quant / calib values
    v8 = {k: jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                    flax.core.unfreeze(shapes[k]))
          for k in shapes if k not in ("params", "batch_stats")}
    v8.update({k: ref["vars"][k] for k in ("params", "batch_stats")})
    jout, _, layers = reference_forward(ref, jax_rules, v8)
    model = copy.deepcopy(ref["port"])
    port_api.quantize_model(model, port_rules, ref["port_batch"])
    return jout, layers, model


def check_quantized_layers(model, layers, expected, sparse_rtol, dense_rtol):
    """Each conv fed the reference's own input: sparse convs and float dense
    convs within ``sparse_rtol`` of the output's largest magnitude, the
    quantized dense convs within ``dense_rtol`` -> the number of quantized
    convs."""
    n = quantized_convs = 0
    with torch.no_grad():
        for name, mod in model.named_modules():
            path = reference_module_path(name)
            if path not in layers:
                continue
            x, y = layers[path]
            if isinstance(mod, SparseConv3d):
                ours, want = mod(common._st(x), {}, None).features, \
                    y["features"]
            elif isinstance(mod, SubMConv3d):
                ours, want = mod(common._st(x), {}).features, y["features"]
            elif isinstance(mod, Conv2d):
                ours, want = mod(common._dense(x)).permute(0, 2, 3, 1), y
            else:
                continue
            ours = ours.numpy()
            assert ours.shape == want.shape, path
            err = float(np.abs(ours - want).max() / np.abs(want).max())
            dense_q = mod.rule is not None and isinstance(mod, Conv2d)
            assert err <= (dense_rtol if dense_q else sparse_rtol), (path, err)
            n += 1
            quantized_convs += mod.rule is not None
    assert n == expected, n
    return quantized_convs


def recipe_detections(model, jout):
    """The port's quantized head and post-processing on the reference's own
    quantized BEV map (``spatial_features_2d``) -> the port's outputs.  The
    recipes keep the head's three convs float, so from here on both
    packages compute the same float function: the detections are held slot
    for slot (``check_detections``).  End to end the two runs part: on
    these untrained weights each flipped fake-quant rounding grows through
    the layers (spatial_features_2d 2-7% of its scale apart, measured), so
    each quantized layer is held fed the reference's input instead
    (``check_quantized_layers``)."""
    x = torch.from_numpy(np.ascontiguousarray(
        jout["spatial_features_2d"].transpose(0, 3, 1, 2)))
    with torch.no_grad():
        bd = model.post_processing(model.dense_head(
            {"spatial_features_2d": x}))
    return {k: v.numpy() for k, v in bd.items()
            if isinstance(v, torch.Tensor)}
