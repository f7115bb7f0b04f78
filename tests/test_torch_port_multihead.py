"""PyTorch port vs the JAX package: SECOND-MultiHead (``AnchorHeadMulti``
and the multi-class NMS), on the small model that
``torch_port_multihead_common`` makes from the Lyft yaml, f32, batch 2.

* the reference's variables carried across (strict load) and every map
  within MAP_RTOL (1e-5) of its largest magnitude: the BEV maps end to
  end, the shared conv and each tower's cls / box convs fed the
  reference's BEV map; the assembled class map equal to ABSENT_LOGIT in
  every channel a tower does not predict;
* the decoded boxes within BOX_ATOL / BOX_RTOL (1e-4 / 1e-5) and the final
  detections slot for slot (``torch_port_anchor_common.check_detections``),
  the reference's fill patched to the port's (``patched_fill``);
* ``multi_classes_nms``, ``class_specific_nms`` and ``nms_normal_bev`` on
  seeded crowded boxes: indices, valid flags and scores exactly equal;
* the reference's 0.5-score fault pinned on its unpatched head, and the
  port's absent channels scoring exactly 0 in f32 and bf16, with a focal
  loss term and gradient of exactly 0;
* the reference's box coder read from where the yaml does not put it, and
  its focal-loss gradient at a logit of exactly 0, pinned.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from q3d_tpu.config import EDict as JaxEDict
from q3d_tpu.models.dense_heads.anchor_head_template import \
    AnchorHeadTemplate as JaxAnchorHeadTemplate
from q3d_tpu.utils import loss_utils as jax_loss
from q3d_tpu.models.model_utils import model_nms_utils as jax_nms
from q3d_tpu.ops.iou3d_nms import iou3d_nms_utils as jax_iou

import torch_port_anchor_common as anchor_common
import torch_port_multihead_common as common
from q3d_tpu_torch.config import EDict
from q3d_tpu_torch.models.dense_heads.anchor_head_multi import ABSENT_LOGIT
from q3d_tpu_torch.models.model_utils import model_nms_utils
from q3d_tpu_torch.ops.iou3d_nms import nms_normal_bev
from q3d_tpu_torch.utils import loss_utils
from q3d_tpu_torch.utils.weights import reference_module_path
from torch_port_jax_cache import jax_compile_cache  # noqa: F401

torch.set_num_threads(2)

MAP_RTOL = anchor_common.MAP_RTOL
GROUPS = 5


def _head_maps():
    names = ["dense_head.shared_conv.0"]
    for g in range(GROUPS):
        names += [f"dense_head.heads.{g}.conv_cls",
                  f"dense_head.heads.{g}.conv_box"]
    return names


@pytest.fixture(scope="module")
def multihead():
    ref = common.build()
    with common.patched_fill():
        jout, layers = common.reference_forward(ref)
    out, _ = common.port_forward(ref["port"], ref["port_batch"])
    # the head on the reference's own BEV map: the end-to-end maps reach the
    # head ~6e-6 of scale apart, which its BNs (calibrated on this batch)
    # carry to 1.4e-5 at a tower's output and to 1.7e-4 in a decoded box
    # (measured), as recipe_detections describes for the recipes
    bev = torch.from_numpy(np.ascontiguousarray(
        jout["spatial_features_2d"].transpose(0, 3, 1, 2)))
    model = ref["port"]
    head_out, maps = common.port_forward(
        lambda b: model.post_processing(model.dense_head(b)),
        {"spatial_features_2d": bev}, _head_maps(), modules=model)
    # the fault, as the reference has it, with the towers' conv_cls bias at
    # its prior -log 99 (a trained model's scores are mostly low): its head
    # and post-processing on its own BEV map (the fill is in the head)
    prior = common.with_cls_bias(ref["vars"], -np.log(99.0))
    raw_out = jax.jit(lambda v, b: ref["model"].apply(
        v, b, method=lambda m, d: m.post_processing(m.dense_head(d, False))))(
        prior, {"spatial_features_2d": jout["spatial_features_2d"]})
    raw_out = {k: np.asarray(raw_out[k]) for k in (
        "batch_cls_preds", "batch_box_preds", "final_boxes", "final_labels",
        "final_valid")}
    return ref, jout, layers, raw_out, out, head_out, maps


def test_multihead_maps_match_reference(multihead):
    ref, jout, layers, _, out, head_out, maps = multihead
    head = ref["port"].dense_head
    assert len(head.heads) == GROUPS
    assert [len(ids) for ids, _ in head.groups] == [1, 2, 2, 2, 2]
    pairs = {k: (out[k], jout[k].transpose(0, 3, 1, 2))
             for k in ("spatial_features", "spatial_features_2d")}
    for name, ours in maps.items():
        path = reference_module_path(name)
        assert path in layers, (name, path)
        pairs[name] = (ours, layers[path][1])
    assert len(pairs) == 2 + 1 + 2 * GROUPS
    for key, (ours, theirs) in pairs.items():
        assert ours.shape == theirs.shape, key
        scale = float(np.abs(theirs).max())
        assert scale > 1e-2, (key, scale)
        err = float(np.abs(ours - theirs).max()) / scale
        assert err <= MAP_RTOL, (key, err)
    # the assembled class map: each anchor scored for its own class only
    cls = head_out["batch_cls_preds"]                # (B, Na, 9)
    own = np.eye(9, dtype=bool)[head.anchor_cls.numpy() - 1]
    assert (cls[:, ~own] == ABSENT_LOGIT).all()
    assert (cls[:, own] != ABSENT_LOGIT).all()


def test_multihead_detections_match_reference(multihead):
    """The head and post-processing on the reference's BEV map: decoded
    boxes within BOX_ATOL + BOX_RTOL, detections slot for slot, of more
    than one class."""
    _, jout, _, _, _, head_out, _ = multihead
    anchor_common.check_decoded(head_out, jout)
    anchor_common.check_detections(head_out, jout)
    valid = head_out["final_valid"]
    assert set(np.unique(head_out["final_labels"][valid])) > {1}


def _crowded(rng, b, n):
    boxes = np.zeros((b, n, 7), np.float32)
    boxes[..., 0:2] = rng.uniform(-4, 4, (b, n, 2))
    boxes[..., 2] = rng.uniform(-1, 1, (b, n))
    boxes[..., 3:6] = rng.uniform(0.5, 4.5, (b, n, 3))
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (b, n))
    boxes[:, 10:20] = boxes[:, 0:10]                 # duplicates
    return boxes


def test_nms_functions_match_reference():
    """On seeded crowded boxes (duplicates, tied scores), batch 2: the
    reference's per-frame functions against the port's batched ones,
    rotated and axis-aligned: indices, valid flags and scores equal."""
    rng = np.random.RandomState(3)
    b, n, c = 2, 300, 4
    boxes = _crowded(rng, b, n)
    scores = rng.uniform(0, 1, (b, n, c)).astype(np.float32)
    scores[:, 30:40] = scores[:, 40:50]              # ties
    labels = rng.randint(1, c, (b, n)).astype(np.int32)
    tb, ts, tl = (torch.from_numpy(x) for x in (boxes, scores, labels))
    for nms_type in ("nms_gpu", "nms_normal_gpu"):
        cfg = {"NMS_TYPE": nms_type, "NMS_THRESH": 0.2,
               "NMS_PRE_MAXSIZE": 250, "NMS_POST_MAXSIZE": 150}
        idx, val, sc = model_nms_utils.multi_classes_nms(
            ts, tb, EDict(cfg), score_thresh=0.1)
        fn = jax.jit(lambda s, x, cfg=cfg: jax_nms.multi_classes_nms(
            s, x, JaxEDict(cfg), 0.1))
        for f in range(b):
            ridx, rval, rsc = fn(scores[f], boxes[f])
            np.testing.assert_array_equal(val[f].numpy(), np.asarray(rval))
            np.testing.assert_array_equal(idx[f].numpy(), np.asarray(ridx))
            np.testing.assert_array_equal(sc[f].numpy(), np.asarray(rsc))
            assert 0 < int(rval.sum()) < rval.size, nms_type
    # nms_normal_bev alone, pre_maxsize not a multiple of 128
    mine = nms_normal_bev(tb, ts[..., 0], 0.3, pre_maxsize=200,
                          post_maxsize=120)
    for f in range(b):
        theirs = jax_iou.nms_normal_bev(jnp.asarray(boxes[f]),
                                        jnp.asarray(scores[f, :, 0]), 0.3,
                                        pre_maxsize=200, post_maxsize=120)
        for m, t in zip(mine, theirs):
            np.testing.assert_array_equal(m[f].numpy(), np.asarray(t))
    # class_specific_nms: per-class thresholds (two classes share one, so
    # they run as sets of one call) and a per-class score threshold
    for thresh in ([0.3, 0.5, 0.3], 0.4):
        cfg = {"NMS_THRESH": thresh, "NMS_PRE_MAXSIZE": 250,
               "NMS_POST_MAXSIZE": 90}
        mi, mv = model_nms_utils.class_specific_nms(
            ts[..., 0], tb, tl, EDict(cfg), score_thresh=[0.1, 0.2, 0.3])
        fn = jax.jit(lambda s, x, lab, cfg=cfg: jax_nms.class_specific_nms(
            s, x, lab, JaxEDict(cfg), score_thresh=[0.1, 0.2, 0.3]))
        for f in range(b):
            ri, rv = fn(scores[f, :, 0], boxes[f], labels[f])
            np.testing.assert_array_equal(mv[f].numpy(), np.asarray(rv))
            np.testing.assert_array_equal(mi[f].numpy()[np.asarray(rv)],
                                          np.asarray(ri)[np.asarray(rv)])
            assert int(rv.sum()) > 0


def _source_class(out, anchor_cls):
    """Each valid final detection's anchor class (the anchor whose decoded
    box it is) -> (anchor classes, labels)."""
    src, lab = [], []
    for f in range(out["final_boxes"].shape[0]):
        for box, label, v in zip(out["final_boxes"][f], out["final_labels"][f],
                                 out["final_valid"][f]):
            if not v:
                continue
            rows = np.flatnonzero((out["batch_box_preds"][f] == box).all(1))
            assert len(rows) >= 1
            src.append(anchor_cls[rows[0]])
            lab.append(label)
    return np.asarray(src), np.asarray(lab)


def test_reference_fault_not_copied(multihead):
    """The reference (unpatched) scores each anchor 0.5 (a logit of 0) for
    the 8 classes its tower does not predict: 8/9 of its scores are
    exactly 0.5, above SCORE_THRESH 0.1, and its final detections are
    mostly boxes of other classes' anchors labelled with the class whose
    column scored them.  The port's absent channels score exactly 0 in f32
    and bf16; every final detection of the port comes from an anchor of
    its label's class; the focal loss of an absent channel (target 0) is
    exactly 0, with a gradient of exactly 0."""
    ref, _, _, raw, _, out, _ = multihead
    anchor_cls = ref["port"].dense_head.anchor_cls.numpy()
    scores = 1 / (1 + np.exp(-raw["batch_cls_preds"].astype(np.float64)))
    assert np.isclose((scores == 0.5).mean(), 8 / 9, atol=1e-3)
    src, lab = _source_class(raw, anchor_cls)
    assert len(lab) > 0 and (src != lab).mean() > 0.5
    src, lab = _source_class(out, anchor_cls)
    assert len(lab) > 0 and (src == lab).all()

    own = np.eye(9, dtype=bool)[anchor_cls - 1]
    model, batch = ref["port"], ref["port_batch"]
    for dtype in (torch.float32, torch.bfloat16):
        m = model.to(dtype) if dtype == torch.bfloat16 else model
        b = {k: v.to(dtype) if torch.is_tensor(v) and v.is_floating_point()
             else v for k, v in batch.items()}
        with torch.no_grad():
            bd = m.dense_head(m.backbone_2d(m.map_to_bev_module(
                m.backbone_3d(m.vfe(dict(b))))))
        s = torch.sigmoid(bd["batch_cls_preds"])
        assert s.dtype == torch.float32     # f32 past the head's first BN
        assert (s[:, torch.from_numpy(~own)] == 0).all(), dtype
    model.float()
    x = torch.full((2, 5, 9), ABSENT_LOGIT, requires_grad=True)
    loss = loss_utils.sigmoid_focal_cls_loss(x, torch.zeros(2, 5, 9),
                                             torch.ones(2, 5))
    loss.sum().backward()
    assert (loss == 0).all() and (x.grad == 0).all()
    xb = torch.full((3,), ABSENT_LOGIT, dtype=torch.bfloat16)
    assert (torch.sigmoid(xb) == 0).all()


def test_reference_coder_and_bce_faults_not_copied():
    """Two more readings of the reference, pinned.  (1) Its anchor head
    reads BOX_CODER / BOX_CODER_CONFIG from the head's own level
    (``anchor_head_template.py:32-33``), while the Lyft yaml puts them, as
    every config and OpenPCDet do, in TARGET_ASSIGNER_CONFIG: the
    reference drops ``encode_angle_by_sincos`` (code size 7, conv_box 7
    codes an anchor) and its loss then raises on the yaml's 8 code
    weights; the port reads TARGET_ASSIGNER_CONFIG (code size 8).  (2) At
    a logit of exactly 0 the stable BCE's pieces have no derivative: the
    reference's clip and abs take 0.5 and 1 there, which gives the focal
    loss's gradient without its BCE term; the port's equals the true
    derivative (a central difference)."""
    jcfg = common.jax_cfg_from_yaml(str(common.LYFT_CFG), JaxEDict())
    pcfg = common.cfg_from_yaml_file(str(common.LYFT_CFG), EDict())
    geo, _ = common.data(common.configs()[1])
    jhead = common.jax_build_network(
        jcfg.MODEL, 9, common.JaxDatasetInfo(**geo)).bind({}).dense_head
    jhead.setup()
    assert jhead.box_coder.code_size == 7
    ns = types.SimpleNamespace(model_cfg=jcfg.MODEL.DENSE_HEAD, num_class=9)
    labels = jnp.zeros((1, 4), jnp.int32).at[0, 0].set(1)
    with pytest.raises((ValueError, TypeError)):
        JaxAnchorHeadTemplate.get_loss(types.SimpleNamespace(
            **vars(ns), add_sin_difference=JaxAnchorHeadTemplate.
            add_sin_difference), {
            "cls_preds": jnp.zeros((1, 4, 9)), "box_preds": jnp.zeros(
                (1, 4, 7)), "box_cls_labels": labels,
            "box_reg_targets": jnp.zeros((1, 4, 7)),
            "reg_weights": jnp.ones((1, 4))})
    port = common.build_network(pcfg.MODEL, 9, common.DatasetInfo(**geo),
                                device="cpu")
    assert port.dense_head.box_coder.code_size == 8

    def focal(x):
        return float(0.75 / (1 + np.exp(-x)) ** 2 * np.log1p(np.exp(x)))
    true = (focal(1e-3) - focal(-1e-3)) / 2e-3
    x = torch.zeros((1, 1, 1), requires_grad=True)
    loss_utils.sigmoid_focal_cls_loss(x, torch.zeros(1, 1, 1),
                                      torch.ones(1, 1)).sum().backward()
    assert abs(float(x.grad) - true) <= 1e-6
    theirs = np.asarray(jax.grad(lambda v: jax_loss.sigmoid_focal_cls_loss(
        v, jnp.zeros((1, 1, 1)), jnp.ones((1, 1))).sum())(
        jnp.zeros((1, 1, 1)))).item()
    assert abs(theirs - true) > 0.05
