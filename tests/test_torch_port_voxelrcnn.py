"""PyTorch port vs the JAX package: Voxel R-CNN, tiny
(``voxelrcnn_tiny.yaml``), f32, batch 2, on the reference's seeded weights
with every BN's statistics set from the batch
(``torch_port_anchor_common.build``); and both two-stage KITTI configs of
the port at full width.

VoxelRCNNHead fed the reference's own rois and sparse stages, the whole
forward, and two readings of the reference, pinned on it.  Tolerances as
in ``test_torch_port_pvrcnn.py``: the head within ``LAYER_RTOL`` of its
output's largest magnitude; the whole forward's rois the same keep set
(valid flags and labels equal, boxes within 1e-4 slot for slot), the final
boxes within 1e-3 and the scores within 1e-4, slot for slot.
"""

from pathlib import Path

import flax
import jax
import numpy as np
import pytest
import torch

from q3d_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
from q3d_tpu.config import EDict as JaxEDict
from q3d_tpu.models import build_network as jax_build_network
from q3d_tpu.models.detectors.detector3d_template import (
    DatasetInfo as JaxDatasetInfo)
from q3d_tpu.models.roi_heads import voxelrcnn_head as jax_vrh

import torch_port_anchor_common as common
from test_torch_port_pvrcnn import (BOX_TOL, LAYER_RTOL, ROI_TOL, ROIS,
                                    SCORE_TOL, _rel, _t, rois_final_checks)
from q3d_tpu_torch.config import EDict, cfg_from_yaml_file
from q3d_tpu_torch.models import build_network
from q3d_tpu_torch.models.backbones_3d.pfe import voxel_set_abstraction as vsa
from q3d_tpu_torch.models.detectors.detector3d_template import DatasetInfo
from q3d_tpu_torch.ops.pointnet2_utils import ball_query
from q3d_tpu_torch.ops.spconv import SparseConvTensor
from q3d_tpu_torch.utils.weights import state_dict_from_jax
from torch_port_jax_cache import jax_compile_cache  # noqa: F401

torch.set_num_threads(2)
PORT_KITTI = Path(__file__).resolve().parents[1] / "q3d_tpu_torch" / "cfgs" / \
    "kitti_models"
STRIDES = {"x_conv1": 1, "x_conv2": 2, "x_conv3": 4, "x_conv4": 8}
KEPT = ("final_boxes", "final_scores", "final_labels", "final_valid") + ROIS


@pytest.fixture(scope="module")
def ref():
    """The tiny model on both sides and one jitted reference forward: its
    outputs, its sparse stages, the ROI head's ``cls_out`` and every ball
    query the head made (radius, nsample, points, centres, mask)."""
    r = common.build("voxelrcnn_tiny")
    calls = []
    real = jax_vrh.ball_query

    def recording(radius, nsample, xyz, new_xyz, valid=None):
        calls.append((radius, nsample))
        out = real(radius, nsample, xyz, new_xyz, valid)
        traced.append((xyz, new_xyz, valid, *out))
        return out

    def apply(v, b):
        out, state = r["model"].apply(
            v, b, train=False,
            capture_intermediates=lambda m, n: m.name == "cls_out")
        ms = out["multi_scale_3d_features"]
        return ({k: out[k] for k in KEPT},
                {k: (st.features, st.indices) for k, st in ms.items()},
                state["intermediates"]["roi_head"]["cls_out"]["__call__"][0],
                list(traced))
    traced = []
    jax_vrh.ball_query = recording
    try:
        out, ms, cls_out, queries = jax.jit(apply)(r["vars"], r["batch"])
    finally:
        jax_vrh.ball_query = real
    r["out"] = {k: np.asarray(v) for k, v in out.items()}
    r["ms"] = {k: tuple(np.asarray(a) for a in v) for k, v in ms.items()}
    r["cls_out"] = np.asarray(cls_out)
    r["queries"] = [(c, tuple(np.asarray(a) for a in q))
                    for c, q in zip(calls, queries)]
    return r


def _stages(r, batch_size):
    shape = r["port"].backbone_3d.sparse_shape
    return {k: SparseConvTensor(features=_t(f), indices=_t(i),
                                spatial_shape=shape, batch_size=batch_size)
            for k, (f, i) in r["ms"].items()}


def test_voxelrcnn_head_matches_reference(ref):
    """VoxelRCNNHead fed the reference's rois and sparse stages."""
    out = ref["out"]
    head_in = {k: _t(out[k]) for k in ROIS}
    head_in.update(multi_scale_3d_features=_stages(ref, out["rois"].shape[0]),
                   multi_scale_3d_strides=STRIDES)
    with torch.no_grad():
        got = ref["port"].roi_head(head_in)
    valid = out["final_valid"]
    assert valid.sum() > 10
    np.testing.assert_array_equal(got["final_valid"].numpy(), valid)
    assert _rel(got["final_boxes"].numpy()[valid],
                out["final_boxes"][valid]) <= LAYER_RTOL
    assert _rel(got["final_scores"].numpy()[valid],
                out["final_scores"][valid]) <= LAYER_RTOL


def test_tiny_voxelrcnn_matches_reference(ref):
    """The whole forward from the reference's variables: the rois the same
    keep set, the final detections matched."""
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
    np.testing.assert_allclose(got["final_boxes"][v], out["final_boxes"][v],
                               rtol=0, atol=BOX_TOL)
    np.testing.assert_allclose(got["final_scores"][v],
                               out["final_scores"][v], rtol=0,
                               atol=SCORE_TOL)


def test_reference_pools_voxel_centres_by_ball_query(ref):
    """A reading of the reference, pinned (``ROADMAP.md`` §3): OpenPCDet's
    voxel query (the voxels within QUERY_RANGES voxel offsets of a grid
    point, then the radius) is a ball query over each stage's voxel
    centres in the reference: one query per POOL_LAYERS source and radius,
    over the stage's rows regrouped per frame, their centres and valid
    flags, the first NSAMPLE rows (by index) within the radius; the port
    regroups the same rows (centres within 1e-5) and, on the reference's
    centres, makes the same query (indices and masks equal)."""
    cfg = ref["cfg"].MODEL.ROI_HEAD.ROI_GRID_POOL
    want = [(float(r), int(n)) for layer in cfg.POOL_LAYERS.values()
            for r, n in zip(layer["POOL_RADIUS"], layer["NSAMPLE"])]
    assert [c for c, _ in ref["queries"]] == want
    stages = _stages(ref, 2)
    sources = [src for src, layer in cfg.POOL_LAYERS.items()
               for _ in layer["POOL_RADIUS"]]
    for src, ((radius, nsample), (xyz, grid, valid, idx, mask)) in zip(
            sources, ref["queries"]):
        centres, _, rows = vsa.stage_points(stages[src], STRIDES[src],
                                            ref["port"].roi_head.voxel_size,
                                            ref["port"].roi_head.
                                            point_cloud_range, 2)
        np.testing.assert_array_equal(rows.numpy(), valid)
        # XLA fuses (c + 0.5) * size + min into one multiply-add: an ulp
        np.testing.assert_allclose(centres.numpy()[valid], xyz[valid],
                                   rtol=0, atol=1e-5)
        got_i, got_m = ball_query(radius, nsample, _t(xyz), _t(grid),
                                  _t(valid))
        np.testing.assert_array_equal(got_m.numpy(), mask)
        np.testing.assert_array_equal(got_i.numpy(), idx)
        assert mask.any()


def test_reference_scores_voxelrcnn_rois_without_final_nms(ref):
    """The reading of ``test_torch_port_pvrcnn.py``'s
    ``test_reference_scores_rois_without_final_nms`` for VoxelRCNNHead
    (``voxelrcnn_head.py:90``): sigmoid(cls_out) x roi score, the proposal
    layer's valid flags, no NMS after the refinement."""
    rois_final_checks(ref)


def test_full_width_configs_build_in_both_packages():
    """``pv_rcnn.yaml`` and ``voxel_rcnn_car.yaml`` load unchanged in both
    packages; at the KITTI geometry (1408 x 1600 x 40 voxels of 0.05 x 0.05
    x 0.1 m, 4 point features) the reference's variable tree
    (``jax.eval_shape`` of ``init``) goes through ``state_dict_from_jax``
    and loads strictly into the port's model, built on the CPU when asked
    and on the card by default (raising without one)."""
    for name, sa, pooled in (("pv_rcnn", 10, 216 * 128),
                             ("voxel_rcnn_car", 3, 216 * 96)):
        path = PORT_KITTI / f"{name}.yaml"
        jcfg = jax_cfg_from_yaml(str(path), JaxEDict())
        pcfg = cfg_from_yaml_file(str(path), EDict())
        assert jcfg == pcfg
        dc = pcfg.DATA_CONFIG
        vs = tuple(float(v) for v in dc.DATA_PROCESSOR[-1].VOXEL_SIZE)
        geo = dict(class_names=tuple(pcfg.CLASS_NAMES), num_point_features=4,
                   grid_size=(1408, 1600, 40),
                   point_cloud_range=tuple(float(v) for v in
                                           dc.POINT_CLOUD_RANGE),
                   voxel_size=vs)
        v, n = 40000, int(dc.get("MAX_RAW_POINTS", 1024))
        batch = {"voxels": jax.ShapeDtypeStruct((2, v, 5, 4), np.float32),
                 "voxel_coords": jax.ShapeDtypeStruct((2, v, 3), np.int32),
                 "voxel_num_points": jax.ShapeDtypeStruct((2, v), np.int32),
                 "points": jax.ShapeDtypeStruct((2, n, 4), np.float32),
                 "points_mask": jax.ShapeDtypeStruct((2, n), np.bool_),
                 "batch_size": 2}
        jmodel = jax_build_network(jcfg.MODEL, len(jcfg.CLASS_NAMES),
                                   JaxDatasetInfo(**geo))
        shapes = jax.eval_shape(lambda k, b: jmodel.init(k, b, train=False),
                                jax.random.PRNGKey(0), batch)
        state = state_dict_from_jax(jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, s.dtype), flax.core.unfreeze(shapes)))
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                build_network(pcfg.MODEL, len(pcfg.CLASS_NAMES),
                              DatasetInfo(**geo))
        model = build_network(pcfg.MODEL, len(pcfg.CLASS_NAMES),
                              DatasetInfo(**geo), device="cpu")
        own = model.state_dict()
        assert set(state) == set(own)
        for key, t in state.items():
            assert tuple(t.shape) == tuple(own[key].shape), key
        model.load_state_dict(state, strict=True)
        blocks = [m for m in model.modules()
                  if isinstance(m, vsa.SAMLPBlock)]
        assert len(blocks) == sa + (2 if name == "pv_rcnn" else 0)
        assert model.roi_head.shared_fc_0.weight.shape == (256, pooled)
        assert type(model).__name__ == jcfg.MODEL.NAME
