"""PyTorch port vs the JAX package: TransFusion-LiDAR, tiny
(``transfusion_tiny.yaml``), batch 2.

MeanVFE -> VoxelResBackBone8x -> HeightCompression -> BaseBEVBackbone (its
stride-1 deblock a 1x1 conv, ``USE_CONV_FOR_NO_STRIDE``) -> TransFusionHead
(shared conv, heatmap, peak NMS, top-50 queries, one decoder layer, Conv1d
branches, the query-score decode), on the reference's seeded weights with
every BN's statistics set from the batch (``torch_port_anchor_common.
build``), f32.  Tolerances: each transformer piece (``Linear``,
``Conv1d``, ``LayerNorm``, ``MultiheadAttention``,
``PositionEmbeddingLearned``, ``TransformerDecoderLayer``) fed the
reference's recorded input within 1e-5 of its output's largest magnitude
(f32 sums in another order); the head's ``predict`` at nuScenes' 10
classes (so the small-object classes 8 and 9 skip the peak NMS) on a
seeded BEV map, its top-K indices equal and its maps within 1e-5 of their
scale; the whole model's final boxes, scores, labels and valid flags
within 1e-4 of their scale, query for query.

A bf16 forward of that head, on the same BEV map in bf16 on both sides:
the reference's BNs and LayerNorms return f32 for a bf16 input (flax
promotes it with their f32 parameters), so its shared conv and its heatmap
block's conv are the only bf16 products, and the port's are the same.
Their f32 sums run in another order and round to bf16 on either side, so
an element may land one bf16 step (2^-8 relative) apart; the dense heatmap
is held within 2^-6 of its scale (four steps), and the top-K is held
equal.  Each query's outputs through the decoder (self-attention mixes all
50) are held within 2^-6 of each output's scale.
"""

import copy
import tempfile
from pathlib import Path
from unittest import mock

import flax
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from q3d_tpu.models import layers as jlayers
from q3d_tpu.models.dense_heads import transfusion_head as jth
from q3d_tpu.models.model_utils import transfusion_utils as jtu
from q3d_tpu.utils import checkpoint as jckpt

import torch_port_anchor_common as common
from q3d_tpu_torch.models.dense_heads.transfusion_head import TransFusionHead
from q3d_tpu_torch.quant import api as port_api
from q3d_tpu_torch.utils.checkpoint import (load_params_from_file,
                                            save_checkpoint)
from q3d_tpu_torch.utils.weights import (reference_module_path,
                                         state_dict_from_jax)
from torch_port_jax_cache import jax_compile_cache  # noqa: F401

torch.set_num_threads(2)
LAYER_RTOL = 1e-5
MAP_RTOL = 1e-5
DET_RTOL = 1e-4
BF16_RTOL = 2.0 ** -6
OUT_KEYS = ("final_boxes", "final_scores", "final_labels", "final_valid")
RES_KEYS = ("center", "height", "dim", "rot", "heatmap",
            "query_heatmap_score", "dense_heatmap")
NUSCENES = ("car", "truck", "construction_vehicle", "bus", "trailer",
            "barrier", "motorcycle", "bicycle", "pedestrian", "traffic_cone")
RECORDED = (jlayers.Linear, jlayers.Conv1d, fnn.LayerNorm,
            jtu.MultiheadAttention, jtu.PositionEmbeddingLearned,
            jtu.TransformerDecoderLayer)


def rel_err(ours, theirs):
    theirs = np.asarray(theirs, np.float32)
    scale = float(np.abs(theirs).max())
    assert scale > 1e-3, scale                         # a signal, not zeros
    return float(np.abs(np.asarray(ours, np.float32) - theirs).max()) / scale


def _recorder(store, tops):
    """flax interceptor (every positional input and the output of each
    recorded module call, by its dotted path) and a ``jax.lax.top_k`` that
    records its indices."""
    real_top_k = jax.lax.top_k

    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if context.method_name == "__call__" \
                and isinstance(context.module, RECORDED):
            store[".".join(str(p) for p in context.module.path)] = (args, out)
        return out

    def top_k(x, k):
        vals, idx = real_top_k(x, k)
        tops.append(idx)
        return vals, idx
    return interceptor, top_k


def reference_forward(ref):
    """One jitted reference forward -> (final outputs, {path: (inputs,
    output)} of the transformer pieces)."""
    def apply(v, b):
        store, tops = {}, []
        interceptor, top_k = _recorder(store, tops)
        with fnn.intercept_methods(interceptor), \
                mock.patch.object(jax.lax, "top_k", top_k):
            out = ref["model"].apply(v, b, train=False)
        return {k: out[k] for k in OUT_KEYS}, store
    out, store = jax.jit(apply)(ref["vars"], ref["batch"])
    return ({k: np.asarray(v) for k, v in out.items()},
            jax.tree_util.tree_map(np.asarray, store))


def port_forward(model, batch):
    with torch.no_grad():
        out = model(dict(batch))
    return {k: out[k].numpy() for k in OUT_KEYS}


def head_pair(num_class=10, hw=(24, 20), seed=3):
    """The reference's and the port's TransFusionHead at ``num_class``
    classes (nuScenes' names and rule) over a seeded (B, H, W, 64) BEV
    map, on one seeded set of weights (identity BN statistics) -> (jax
    head, variables, port head, BEV map (numpy, NHWC))."""
    jcfg, pcfg = common.configs("transfusion_tiny")
    for cfg in (jcfg, pcfg):
        cfg.MODEL.DENSE_HEAD.TARGET_ASSIGNER_CONFIG.DATASET = "nuScenes"
    names = NUSCENES[:num_class]
    geo = dict(grid_size=(hw[1] * 8, hw[0] * 8, 1),
               point_cloud_range=(-10.0, -30.0, -3.0, 50.0, 30.0, 1.0),
               voxel_size=(0.3, 0.3, 4.0))
    bev = np.maximum(np.random.RandomState(seed).randn(2, *hw, 64), 0) \
        .astype(np.float32)
    jhead = jth.TransFusionHead(jcfg.MODEL.DENSE_HEAD, 64, num_class, names,
                                **geo)
    shapes = jax.eval_shape(lambda k, x: jhead.init(k, x, method="predict"),
                            jax.random.PRNGKey(0), jnp.asarray(bev))
    variables = common._seeded_variables(shapes, seed)
    port = TransFusionHead(pcfg.MODEL.DENSE_HEAD, 64, num_class, names,
                           **geo).eval()
    state = state_dict_from_jax({c: {"dense_head": t}
                                 for c, t in variables.items()})
    port.load_state_dict({k.split(".", 1)[1]: v for k, v in state.items()},
                         strict=True)
    return jhead, variables, port, bev


def reference_predict(jhead, variables, bev):
    """-> (the reference head's ``predict`` res as numpy, its top-K
    indices, {path: (inputs, output)} of its transformer pieces)."""
    def apply(v, x):
        store, tops = {}, []
        interceptor, top_k = _recorder(store, tops)
        with fnn.intercept_methods(interceptor), \
                mock.patch.object(jax.lax, "top_k", top_k):
            res = jhead.apply(v, x, method="predict")
        return res, tops[0], store
    res, top, store = jax.jit(apply)(variables, jnp.asarray(bev))
    return (jax.tree_util.tree_map(np.asarray, res), np.asarray(top),
            jax.tree_util.tree_map(np.asarray, store))


def port_predict(head, bev):
    """``bev``: (B, H, W, C), numpy or a tensor -> (the port head's
    ``predict`` res as numpy, its top-K indices)."""
    x = torch.as_tensor(bev).permute(0, 3, 1, 2)
    with torch.no_grad():
        res = head.predict(x)
        _, top_class, top_spatial = head.proposals(res["dense_heatmap"])
    top = top_class * x.shape[2] * x.shape[3] + top_spatial
    return ({k: v.float().numpy() for k, v in res.items()}, top.numpy())


def _nhwc(res):
    return {k: v.transpose(0, 2, 3, 1) if k == "dense_heatmap" else v
            for k, v in res.items()}


@pytest.fixture(scope="module")
def tf():
    ref = common.build("transfusion_tiny")
    jout, layers = reference_forward(ref)
    return ref, jout, layers, port_forward(ref["port"], ref["port_batch"])


def test_transformer_pieces_match_reference(tf):
    """Every Linear (10), Conv1d (15), LayerNorm (3), MultiheadAttention
    (2), PositionEmbeddingLearned (2) and the TransformerDecoderLayer of the
    model, each fed the inputs the reference's recorded in its forward,
    within 1e-5 of its output's scale."""
    ref, _, layers, _ = tf
    mods = {reference_module_path(n, m): m
            for n, m in port_api.quantizable_modules(ref["port"])}
    mods.update(ref["port"].named_modules())
    counts = {}
    for path, (args, want) in layers.items():
        mod = mods[path]
        arrays = [torch.from_numpy(np.array(a)) for a in args
                  if np.ndim(a)]                      # not the train flag
        with torch.no_grad():
            got = mod(*arrays)
        assert rel_err(got.numpy(), want) <= LAYER_RTOL, path
        counts[type(mod).__name__] = counts.get(type(mod).__name__, 0) + 1
    assert counts == {"Linear": 10, "Conv1d": 15, "LayerNorm": 3,
                      "MultiheadAttention": 2, "PositionEmbeddingLearned": 2,
                      "TransformerDecoderLayer": 1}, counts


def test_head_predict_matches_reference(tf):
    """The head alone at 10 classes, nuScenes (classes 8 and 9 keep every
    cell through the peak NMS), on a seeded 24 x 20 BEV map: the top-50
    (class, cell) indices equal, every output map within 1e-5 of its
    scale; the small classes hold queries, as they would not under the
    3 x 3 peak NMS alone."""
    jhead, variables, port, bev = head_pair()
    res, top, _ = reference_predict(jhead, variables, bev)
    ours, our_top = port_predict(port, bev)
    np.testing.assert_array_equal(our_top, top)
    np.testing.assert_array_equal(ours["query_labels"], res["query_labels"])
    assert np.isin(res["query_labels"], (8, 9)).any()
    ours = _nhwc(ours)
    for key in RES_KEYS:
        assert ours[key].shape == res[key].shape, key
        assert rel_err(ours[key], res[key]) <= MAP_RTOL, key


def test_model_matches_reference(tf):
    """The whole tiny model on ``state_dict_from_jax`` weights: boxes,
    scores, labels and valid flags of the 2 x 50 queries, in the
    reference's query order, within 1e-4 of their scale (labels and valid
    flags equal)."""
    _, jout, _, out = tf
    np.testing.assert_array_equal(out["final_labels"], jout["final_labels"])
    np.testing.assert_array_equal(out["final_valid"], jout["final_valid"])
    assert jout["final_valid"].sum() > 10
    for key in ("final_boxes", "final_scores"):
        assert out[key].shape == jout[key].shape, key
        assert rel_err(out[key], jout[key]) <= DET_RTOL, key


def test_bf16_head_matches_reference(tf):
    """The head of ``test_head_predict_matches_reference`` on the BEV map
    in bf16 on both sides (see the module docstring): the top-K equal,
    the dense heatmap and every query output within 2^-6 of its scale,
    and the dtypes the reference's: a bf16 shared conv, f32 from the
    heatmap block's BN on."""
    jhead, variables, port, bev = head_pair()
    bev16 = jnp.asarray(bev).astype(jnp.bfloat16)
    res, top, _ = reference_predict(jhead, variables, bev16)
    x = torch.from_numpy(np.asarray(bev16.astype(jnp.float32))).bfloat16()
    with torch.no_grad():
        feat, dense = port.dense_heatmap(x.permute(0, 3, 1, 2))
    assert feat.dtype == torch.bfloat16 and dense.dtype == torch.float32
    ours, our_top = port_predict(port, x)
    np.testing.assert_array_equal(our_top, top)
    ours = _nhwc(ours)
    for key in RES_KEYS:
        assert ours[key].shape == res[key].shape, key
        assert rel_err(ours[key], res[key]) <= BF16_RTOL, key


def test_weight_names_and_pth_import(tf):
    """``state_dict_from_jax`` names every TransFusion leaf after OpenPCDet
    (the fixture's model loads it strictly), Conv1d kernels as torch's
    (O, I, k), LayerNorm scale as weight; a ``.pth`` the port writes
    loads back equal through ``load_params_from_file``.

    The reference's ``.pth`` import on the same pcdet-named tensors, pinned:
    it has no TransFusion rule, so its suffix matcher fills the head's 2D
    convs, BNs, LayerNorms and its non-square Linears with them; it keeps
    its initial value for every Conv1d kernel with more than one output
    channel (its adapter has no (O, I, k) -> (k, I, O) rule); and it loads
    each square Linear (the attention's four d_model x d_model projections)
    without the transpose, because ``adapt_torch_tensor`` returns a tensor
    whose shape already fits as it is (a fault of the reference,
    ``ROADMAP.md`` §3).  The port's import adds no TransFusion rule either:
    it looks each tensor up by its own name, in the port's (torch's)
    layouts, so it reads OpenPCDet's (O, I) Linears and (O, I, k) Conv1ds
    as they are."""
    ref = tf[0]
    state = ref["port"].state_dict()
    keys = set(state)
    for key in ("dense_head.shared_conv.weight",
                "dense_head.heatmap_head.0.conv.weight",
                "dense_head.heatmap_head.0.bn.running_var",
                "dense_head.heatmap_head.1.bias",
                "dense_head.class_encoding.weight",
                "dense_head.decoder.self_attn.q_proj.weight",
                "dense_head.decoder.multihead_attn.out_proj.bias",
                "dense_head.decoder.norm3.weight",
                "dense_head.decoder.cross_posembed."
                "position_embedding_head.1.running_mean",
                "dense_head.decoder.self_posembed.position_embedding_head.3"
                ".weight",
                "dense_head.prediction_head.heatmap.0.1.weight",
                "dense_head.prediction_head.center.1.bias",
                "backbone_2d.deblocks.0.0.weight"):
        assert key in keys, key
    params = ref["vars"]["params"]["dense_head"]
    np.testing.assert_array_equal(
        state["dense_head.class_encoding.weight"].numpy(),
        np.asarray(params["class_encoding"]["kernel"]).transpose(2, 1, 0))
    np.testing.assert_array_equal(
        state["dense_head.decoder.norm2.weight"].numpy(),
        np.asarray(params["decoder"]["norm2"]["scale"]))

    with tempfile.TemporaryDirectory() as tmp:
        path = save_checkpoint(Path(tmp) / "checkpoint_epoch_1.pth",
                               ref["port"])
        model = copy.deepcopy(ref["port"])
        for p in model.parameters():
            p.data.zero_()
        load_params_from_file(model, path)
    for key, value in model.state_dict().items():
        torch.testing.assert_close(value, state[key], rtol=0, atol=0)

    flat = {k: v.numpy() for k, v in state.items()}
    template = flax.core.unfreeze(jax.tree_util.tree_map(
        np.zeros_like, {c: ref["vars"][c] for c in ("params", "batch_stats")}))
    imported = jckpt.import_torch_state_dict(flat, template)
    head = imported["params"]["dense_head"]
    for attn in ("self_attn", "multihead_attn"):
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            want = np.asarray(params["decoder"][attn][proj]["kernel"])
            assert want.shape[0] == want.shape[1]
            np.testing.assert_array_equal(
                head["decoder"][attn][proj]["kernel"], want.T)
    np.testing.assert_array_equal(head["decoder"]["linear1"]["kernel"],
                                  params["decoder"]["linear1"]["kernel"])
    np.testing.assert_array_equal(head["decoder"]["norm1"]["scale"],
                                  params["decoder"]["norm1"]["scale"])
    np.testing.assert_array_equal(head["shared_conv"]["kernel"],
                                  params["shared_conv"]["kernel"])
    assert not head["class_encoding"]["kernel"].any()
    assert not head["prediction_head"]["center_out"]["kernel"].any()
