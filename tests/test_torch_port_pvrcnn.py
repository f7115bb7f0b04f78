"""PyTorch port vs the JAX package: PV-RCNN, tiny (``pvrcnn_tiny.yaml``),
f32, batch 2, on the reference's seeded weights with every BN's statistics
set from the batch (``torch_port_anchor_common.build``).

The PointNet++ primitives, the keypoint set abstraction (VSA), the point
head, the proposal layer and PVRCNNHead, and two readings of the
reference, pinned on it.  Tolerances: FPS and ball-query indices and masks,
``ingroup_inds`` and ``_regroup`` exactly equal; ``_bilinear``, one
``_SAMLPBlock`` and ``get_voxel_centers`` within 1e-5 of their output's
largest magnitude; each module fed the reference's own input within
``LAYER_RTOL`` of its output's largest magnitude (f32 sums in another
order); the whole forward: the rois the same keep set (valid flags and
labels equal, boxes within 1e-4 slot for slot), the final boxes within 1e-3
and the scores within 1e-4, slot for slot.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from q3d_tpu.models import build_network as jax_build_network
from q3d_tpu.models.backbones_3d.pfe import voxel_set_abstraction as jax_vsa
from q3d_tpu.ops import pointnet2_utils as jax_pn2
from q3d_tpu.ops.ingroup_inds import ingroup_inds as jax_ingroup_inds
from q3d_tpu.utils import common_utils as jax_common

import torch_port_anchor_common as common
from q3d_tpu_torch.models.backbones_3d.pfe import voxel_set_abstraction as vsa
from q3d_tpu_torch.ops import pointnet2_utils as pn2
from q3d_tpu_torch.ops.ingroup_inds import ingroup_inds
from q3d_tpu_torch.ops.iou3d_nms import boxes_iou_bev
from q3d_tpu_torch.ops.spconv import SparseConvTensor
from q3d_tpu_torch.utils import common_utils
from q3d_tpu_torch.utils.weights import state_dict_from_jax
from torch_port_jax_cache import jax_compile_cache  # noqa: F401

torch.set_num_threads(2)
OP_RTOL = 1e-5
LAYER_RTOL = 1e-5
ROI_TOL = 1e-4
BOX_TOL, SCORE_TOL = 1e-3, 1e-4
FINAL = ("final_boxes", "final_scores", "final_labels", "final_valid")
ROIS = ("rois", "roi_scores", "roi_labels", "roi_valid")
KEPT = FINAL + ROIS + (
    "keypoints", "point_features", "point_coords", "point_cls_scores",
    "point_features_before_fusion", "spatial_features")


def _rel(ours, theirs):
    scale = float(np.abs(theirs).max())
    assert scale > 1e-3, scale                 # a signal, not zeros
    return float(np.abs(np.asarray(ours, np.float64) - theirs).max()) / scale


def _t(x):
    return torch.from_numpy(np.array(x))


def reference_forward(r):
    """One jitted reference forward: the outputs, the sparse stages and
    the ROI head's ``cls_out``."""
    def apply(v, b):
        out, state = r["model"].apply(
            v, b, train=False,
            capture_intermediates=lambda m, n: m.name == "cls_out")
        ms = out["multi_scale_3d_features"]
        return ({k: out[k] for k in KEPT},
                {k: (st.features, st.indices) for k, st in ms.items()},
                state["intermediates"]["roi_head"]["cls_out"]["__call__"][0])
    out, ms, cls_out = jax.jit(apply)(r["vars"], r["batch"])
    return ({k: np.asarray(v) for k, v in out.items()},
            {k: tuple(np.asarray(a) for a in v) for k, v in ms.items()},
            np.asarray(cls_out))


@pytest.fixture(scope="module")
def ref():
    r = common.build("pvrcnn_tiny")
    r["out"], r["ms"], r["cls_out"] = reference_forward(r)
    return r


def _stages(r, batch_size):
    """The reference's sparse stages as the port's tensors."""
    shape = r["port"].backbone_3d.sparse_shape
    return {k: SparseConvTensor(features=_t(f), indices=_t(i),
                                spatial_shape=shape, batch_size=batch_size)
            for k, (f, i) in r["ms"].items()}


def test_pointnet2_ops_match_reference(monkeypatch):
    """FPS with padded and masked points, more picks than valid points and
    a frame with none; the ball query with and without a mask, centres far
    from every point (no hit), fewer columns than ``nsample`` and chunks
    forced small; ``ingroup_inds``, ``get_voxel_centers``, ``_bilinear``,
    ``_regroup`` and one ``_SAMLPBlock``."""
    rng = np.random.RandomState(0)
    xyz = rng.uniform(-3, 3, (3, 600, 3)).astype(np.float32)
    valid = np.ones((3, 600), bool)
    valid[0, 500:] = False                       # padding
    valid[1, rng.rand(600) < 0.3] = False        # holes
    valid[1, 550:] = False
    valid[2] = False                             # no valid point
    for npoint in (64, 512):
        want = np.asarray(jax_pn2.farthest_point_sample(
            jnp.asarray(xyz), npoint, valid=jnp.asarray(valid)))
        got = pn2.farthest_point_sample(_t(xyz), npoint, _t(valid)).numpy()
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        pn2.farthest_point_sample(_t(xyz[:1]), 32).numpy(),
        np.asarray(jax_pn2.farthest_point_sample(jnp.asarray(xyz[:1]), 32)))

    centres = xyz[:, rng.choice(600, 80, replace=False)].copy()
    centres[:, :5] += 100.0                      # far from every point
    monkeypatch.setattr(pn2, "_CHUNK_ELEMENTS", 3 * 600 * 16)
    for radius, nsample, mask in ((0.5, 16, valid), (1.2, 32, valid),
                                  (0.8, 8, None)):
        jm = None if mask is None else jnp.asarray(mask)
        want_i, want_m = jax_pn2.ball_query(radius, nsample, jnp.asarray(xyz),
                                            jnp.asarray(centres), jm)
        got_i, got_m = pn2.ball_query(radius, nsample, _t(xyz), _t(centres),
                                      None if mask is None else _t(mask))
        np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    few = np.zeros((3, 600), bool)
    few[:, :5] = True                            # 5 columns, nsample 16
    want_i, want_m = jax_pn2.ball_query(2.0, 16, jnp.asarray(xyz),
                                        jnp.asarray(centres),
                                        jnp.asarray(few))
    got_i, got_m = pn2.ball_query(2.0, 16, _t(xyz), _t(centres), _t(few))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))

    groups = rng.randint(-1, 6, 400).astype(np.int32)
    gvalid = (groups >= 0) & (rng.rand(400) > 0.1)
    np.testing.assert_array_equal(
        ingroup_inds(_t(groups), _t(gvalid)).numpy(),
        np.asarray(jax_ingroup_inds(jnp.asarray(groups),
                                    jnp.asarray(gvalid))))
    np.testing.assert_array_equal(
        ingroup_inds(_t(groups)).numpy(),
        np.asarray(jax_ingroup_inds(jnp.asarray(groups))))

    coords = rng.randint(0, 40, (300, 3)).astype(np.int32)
    vs, pcr = (0.05, 0.05, 0.1), (0.0, -40.0, -3.0, 70.4, 40.0, 1.0)
    for stride in (1, 4):
        assert _rel(common_utils.get_voxel_centers(_t(coords), stride, vs,
                                                   pcr).numpy(),
                    np.asarray(jax_common.get_voxel_centers(
                        jnp.asarray(coords), stride, vs, pcr))) <= OP_RTOL

    bev = rng.randn(2, 12, 16, 5).astype(np.float32)
    xs = rng.uniform(-2, 18, (2, 40)).astype(np.float32)
    ys = rng.uniform(-2, 14, (2, 40)).astype(np.float32)
    want = np.asarray(jax_vsa._bilinear(jnp.asarray(bev), jnp.asarray(xs),
                                        jnp.asarray(ys)))
    got = vsa.bilinear(_t(bev.transpose(0, 3, 1, 2)), _t(xs), _t(ys))
    assert _rel(got.numpy(), want) <= OP_RTOL

    n, cap = 300, 90
    b_idx = np.sort(rng.randint(0, 2, n)).astype(np.int32)
    rvalid = rng.rand(n) > 0.2
    feats = rng.randn(n, 6).astype(np.float32)
    cen = rng.randn(n, 3).astype(np.float32)
    want = jax_vsa._regroup(jnp.asarray(cen), jnp.asarray(feats),
                            jnp.asarray(b_idx), jnp.asarray(rvalid), 2, cap)
    got = vsa.regroup(_t(cen), _t(feats), _t(b_idx), _t(rvalid), 2, cap)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    grouped = rng.randn(2, 30, 8, 7).astype(np.float32)
    in_mask = rng.rand(2, 30, 8) > 0.4
    in_mask[:, :3] = False                       # groups with no member
    block = jax_vsa._SAMLPBlock((16, 12))
    v = common._seeded_variables(jax.eval_shape(
        block.init, jax.random.PRNGKey(0), jnp.asarray(grouped),
        jnp.asarray(in_mask)))
    for i, c in enumerate((16, 12)):
        v["batch_stats"][f"norm{i}"]["bn"]["mean"][:] = rng.randn(c)
        v["batch_stats"][f"norm{i}"]["bn"]["var"][:] = rng.uniform(0.5, 2, c)
    want = np.asarray(block.apply(v, jnp.asarray(grouped),
                                  jnp.asarray(in_mask)))
    port = vsa.SAMLPBlock(7, (16, 12)).eval()
    port.load_state_dict({k.split(".", 2)[2]: t for k, t in
                          state_dict_from_jax(
                              {c: {"pfe": {"sa_raw_r0_4": tree}}
                               for c, tree in v.items()}).items()},
                         strict=True)
    with torch.no_grad():
        got = port(_t(grouped), _t(in_mask)).numpy()
    assert not got[:, :3].any()
    assert _rel(got, want) <= OP_RTOL


def test_vsa_point_head_and_roi_head_match_reference(ref):
    """Each module fed the reference's own input: the VSA (the raw points,
    the BEV map and the sparse stages of the reference's forward) with its
    FPS keypoints equal, the point head on the reference's fused features,
    PVRCNNHead on its keypoints, features, scores and rois."""
    model, out = ref["port"], ref["out"]
    b = out["rois"].shape[0]
    batch = {"points": _t(ref["batch"]["points"]),
             "points_mask": _t(ref["batch"]["points_mask"]),
             "spatial_features": _t(out["spatial_features"].transpose(
                 0, 3, 1, 2)),
             "spatial_features_stride": 8,
             "multi_scale_3d_features": _stages(ref, b),
             "multi_scale_3d_strides": {"x_conv1": 1, "x_conv2": 2,
                                        "x_conv3": 4, "x_conv4": 8}}
    with torch.no_grad():
        got = model.pfe(batch)
    np.testing.assert_array_equal(got["keypoints"].numpy(), out["keypoints"])
    np.testing.assert_array_equal(got["point_coords"].numpy(),
                                  out["point_coords"])
    assert _rel(got["point_features"].numpy(),
                out["point_features"]) <= LAYER_RTOL

    with torch.no_grad():
        got = model.point_head({"point_features": _t(out["point_features"])})
    assert _rel(got["point_cls_scores"].numpy(),
                out["point_cls_scores"]) <= LAYER_RTOL

    head_in = {k: _t(out[k]) for k in ROIS + (
        "keypoints", "point_features", "point_cls_scores")}
    with torch.no_grad():
        got = model.roi_head(head_in)
    valid = out["final_valid"]
    assert valid.sum() > 10
    np.testing.assert_array_equal(got["final_valid"].numpy(), valid)
    assert _rel(got["final_boxes"].numpy()[valid],
                out["final_boxes"][valid]) <= LAYER_RTOL
    assert _rel(got["final_scores"].numpy()[valid],
                out["final_scores"][valid]) <= LAYER_RTOL


def test_tiny_pvrcnn_matches_reference(ref):
    """The whole forward from the reference's variables
    (``state_dict_from_jax``): the proposal layer's rois the same keep set,
    the final detections matched."""
    with torch.no_grad():
        got = {k: v.numpy() for k, v in
               ref["port"](dict(ref["port_batch"])).items()
               if isinstance(v, torch.Tensor)}
    out = ref["out"]
    np.testing.assert_array_equal(got["roi_valid"], out["roi_valid"])
    v = out["roi_valid"]
    assert v.sum() > 10
    np.testing.assert_array_equal(got["roi_labels"][v], out["roi_labels"][v])
    np.testing.assert_allclose(got["rois"][v], out["rois"][v], rtol=0,
                               atol=ROI_TOL)
    np.testing.assert_array_equal(got["final_valid"], out["final_valid"])
    np.testing.assert_array_equal(got["final_labels"][v],
                                  out["final_labels"][v])
    np.testing.assert_allclose(got["final_boxes"][v], out["final_boxes"][v],
                               rtol=0, atol=BOX_TOL)
    np.testing.assert_allclose(got["final_scores"][v],
                               out["final_scores"][v], rtol=0,
                               atol=SCORE_TOL)


def test_reference_point_head_reads_fused_features(ref):
    """A reading of the reference, pinned (``ROADMAP.md`` §3): its
    PointHeadSimple reads the fused ``point_features`` (NUM_OUTPUT_FEATURES
    wide) with USE_POINT_FEATURES_BEFORE_FUSION true, where OpenPCDet reads
    the features before the fusion; the port does the same."""
    cfg = ref["cfg"].MODEL
    fused = int(cfg.PFE.NUM_OUTPUT_FEATURES)
    before_fusion = ref["out"]["point_features_before_fusion"].shape[1]
    jcfg, _ = common.configs("pvrcnn_tiny")
    jcfg.MODEL.POINT_HEAD.USE_POINT_FEATURES_BEFORE_FUSION = True
    jmodel = jax_build_network(jcfg.MODEL, num_class=3,
                               dataset=ref["model"].dataset)
    shapes = jax.eval_shape(lambda k, b: jmodel.init(k, b, train=False),
                            jax.random.PRNGKey(0), ref["batch"])
    kernel = shapes["params"]["point_head"]["cls_layers"]["fc0"]["kernel"]
    assert kernel.shape[0] == fused != before_fusion
    assert ref["port"].point_head.cls_layers.fc0.weight.shape[1] == fused


def rois_final_checks(ref):
    """The reference's final outputs are its refined rois: scores
    sigmoid(cls_out) x the roi's score, the proposal layer's valid flags,
    NMS_POST_MAXSIZE of ROI_HEAD's TEST NMS slots, and valid final boxes
    that overlap above POST_PROCESSING's NMS_THRESH (no NMS ran after the
    refinement)."""
    out = ref["out"]
    b, r = out["roi_scores"].shape
    want = jax.nn.sigmoid(ref["cls_out"].reshape(b, r)) * out["roi_scores"]
    np.testing.assert_allclose(out["final_scores"], np.asarray(want),
                               rtol=1e-6, atol=0)
    np.testing.assert_array_equal(out["final_valid"], out["roi_valid"])
    thresh = float(ref["cfg"].MODEL.POST_PROCESSING.NMS_CONFIG.NMS_THRESH)
    overlaps = 0
    for f in range(b):
        boxes = _t(out["final_boxes"][f][out["final_valid"][f]])
        iou = boxes_iou_bev(boxes, boxes).numpy()
        overlaps += int((np.triu(iou, 1) > thresh).sum())
    assert overlaps > 0
    assert r == int(ref["cfg"].MODEL.ROI_HEAD.NMS_CONFIG.TEST.NMS_POST_MAXSIZE)


def test_reference_scores_rois_without_final_nms(ref):
    """A reading of the reference, pinned (``ROADMAP.md`` §3): PVRCNNHead
    (``pvrcnn_head.py:105``) scores a refined box sigmoid(cls_out) x the
    roi's score, keeps the proposal layer's valid flags and runs no NMS
    after the refinement (POST_PROCESSING's, NMS_THRESH 0.1, where
    OpenPCDet runs it: valid final boxes overlap above it); the port
    does the same (``roi_head_template.RoIHeadTemplate.finish``)."""
    rois_final_checks(ref)
