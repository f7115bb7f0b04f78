"""PyTorch port vs the JAX package: SECOND-IoU, tiny
(``second_iou_tiny.yaml`` with its SECONDHead), f32, batch 2, on the
reference's seeded weights; and the two new full-width KITTI configs.

* ``SECONDHead`` fed the reference's own rois, scores and BEV maps: the
  rectified scores within ``LAYER_RTOL`` of their scale (XLA's jitted
  ``pow`` and ``torch.pow`` part by ulps); a reading of the reference
  pinned: its final boxes are the proposals, scored roi_score^(1 - w) x
  sigmoid(iou)^w with w = IOU_WEIGHT, their valid flags the proposal
  layer's, and no NMS follows (valid final boxes overlap above
  POST_PROCESSING's NMS_THRESH), where OpenPCDet's SECONDNetIoU runs
  class-specific NMS;
* the whole forward: rois and final boxes the same keep set (valid flags
  and labels equal, boxes within 1e-4 + 1e-5 of their magnitude), scores
  within 1e-4, slot for slot;
* the IoU head's train branch fed the port's training inputs (the sampled
  rois' IoU loss, its gradients and the BN statistics within 1e-5), then
  one training step from the reference's seeded init held by
  ``torch_port_two_stage_train_common.check_step``
  (``MAX_SPREAD_TENSORS``; the reference patched as that module says);
* ``PartA2.yaml`` and ``second_iou.yaml`` (the port's
  ``cfgs/kitti_models/``) load unchanged in both packages; at the KITTI
  geometry the reference's variable tree (``jax.eval_shape`` of
  ``init``) goes through ``state_dict_from_jax`` and loads strictly into
  the port's model, built on the CPU when asked and on the card by
  default (raising without one); the same parameter count on both sides.
"""

import copy
from pathlib import Path

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from q3d_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
from q3d_tpu.config import EDict as JaxEDict
from q3d_tpu.models import build_network as jax_build_network
from q3d_tpu.models.detectors.detector3d_template import (
    DatasetInfo as JaxDatasetInfo)
from q3d_tpu.models.roi_heads import SECONDHead as JaxSECONDHead

import torch_port_anchor_common as common
import torch_port_two_stage_train_common as ts
from test_torch_port_pvrcnn import (BOX_TOL, LAYER_RTOL, ROI_TOL, ROIS,
                                    SCORE_TOL, _rel, _t)
from test_torch_port_train_step import _np
from q3d_tpu_torch.config import EDict, cfg_from_yaml_file
from q3d_tpu_torch.models import build_network
from q3d_tpu_torch.models.detectors.detector3d_template import DatasetInfo
from q3d_tpu_torch.ops.iou3d_nms import boxes_iou_bev
from q3d_tpu_torch.utils.weights import state_dict_from_jax
from torch_port_jax_cache import jax_compile_cache  # noqa: F401

torch.set_num_threads(2)
NAME = "second_iou_tiny"
PORT_KITTI = Path(__file__).resolve().parents[1] / "q3d_tpu_torch" / "cfgs" / \
    "kitti_models"
MAPS = ("spatial_features", "spatial_features_2d")
KEPT = ("final_boxes", "final_scores", "final_labels", "final_valid") \
    + ROIS + MAPS
HEAD_RTOL = 1e-5
# of the gradients (the biases before a BN apart), those that may take the
# port's own spread as their tolerance (17 measured, as in PV-RCNN's step)
MAX_SPREAD_TENSORS = 24


@pytest.fixture(scope="module")
def ref():
    r = common.build(NAME, keep_roi_head=True)

    def apply(v, b):
        out, state = r["model"].apply(
            v, b, train=False,
            capture_intermediates=lambda m, n: m.name == "iou_out")
        return ({k: out[k] for k in KEPT},
                state["intermediates"]["roi_head"]["iou_out"]["__call__"][0])
    out, iou_out = jax.jit(apply)(r["vars"], r["batch"])
    r["out"] = {k: np.asarray(v) for k, v in out.items()}
    r["iou_out"] = np.asarray(iou_out)
    return r


@pytest.fixture(scope="module")
def two_stage():
    with pytest.MonkeyPatch.context() as mp:
        ts.patch_reference(mp)
        r = ts.build(NAME)
        r["want"] = ts.reference_step(r)
    r["inp"] = ts.roi_head_inputs(r["port"], r["raw"])
    return r


def _nchw(x):
    return _t(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def test_second_head_matches_reference(ref):
    """SECONDHead on the reference's own inputs, and the reading of its
    final outputs, pinned."""
    out = ref["out"]
    head_in = {k: _t(out[k]) for k in ROIS}
    head_in.update({k: _nchw(out[k]) for k in MAPS},
                   spatial_features_stride=8)
    with torch.no_grad():
        got = ref["port"].roi_head(head_in)
    valid = out["final_valid"]
    assert valid.sum() > 10
    np.testing.assert_array_equal(got["final_valid"].numpy(), valid)
    np.testing.assert_array_equal(got["final_boxes"].numpy(),
                                  out["final_boxes"])
    assert _rel(got["final_scores"].numpy()[valid],
                out["final_scores"][valid]) <= LAYER_RTOL

    # the reference's final outputs: the proposals, rectified scores, the
    # proposal layer's valid flags, no NMS after
    b, r = out["roi_scores"].shape
    w = float(ref["cfg"].MODEL.ROI_HEAD.IOU_WEIGHT)
    iou = 1 / (1 + np.exp(-ref["iou_out"].reshape(b, r).astype(np.float64)))
    want = np.clip(out["roi_scores"], 1e-6, 1) ** (1 - w) \
        * np.clip(iou, 1e-6, 1) ** w
    np.testing.assert_allclose(out["final_scores"], want, rtol=1e-5, atol=0)
    np.testing.assert_array_equal(out["final_boxes"], out["rois"])
    np.testing.assert_array_equal(out["final_valid"], out["roi_valid"])
    thresh = float(ref["cfg"].MODEL.POST_PROCESSING.NMS_CONFIG.NMS_THRESH)
    overlaps = 0
    for f in range(b):
        boxes = _t(out["final_boxes"][f][valid[f]])
        overlaps += int((np.triu(boxes_iou_bev(boxes, boxes).numpy(), 1)
                         > thresh).sum())
    assert overlaps > 0


def test_tiny_second_iou_matches_reference(ref):
    with torch.no_grad():
        got = {k: v.numpy() for k, v in
               ref["port"](dict(ref["port_batch"])).items()
               if isinstance(v, torch.Tensor)}
    out = ref["out"]
    for key in MAPS:
        assert _rel(got[key], out[key].transpose(0, 3, 1, 2)) \
            <= common.MAP_RTOL, key
    np.testing.assert_array_equal(got["roi_valid"], out["roi_valid"])
    v = out["roi_valid"]
    assert v.sum() > 10
    np.testing.assert_array_equal(got["roi_labels"][v], out["roi_labels"][v])
    np.testing.assert_array_equal(got["final_valid"], out["final_valid"])
    for key, atol in (("rois", ROI_TOL), ("final_boxes", BOX_TOL)):
        np.testing.assert_allclose(got[key][v], out[key][v],
                                   rtol=common.BOX_RTOL, atol=atol)
    np.testing.assert_allclose(got["final_scores"][v],
                               out["final_scores"][v], rtol=0,
                               atol=SCORE_TOL)


def test_second_head_train_matches_reference(two_stage):
    """The IoU head's train branch on the port's training inputs (the
    proposals, the planted gt boxes, the 2D map): the loss, the gradients
    of its parameters and of the map, the BN statistics."""
    r, inp = two_stage, two_stage["inp"]
    jcfg = common.configs(NAME, keep_roi_head=True)[0]
    ds = r["port"].dataset
    jhead = JaxSECONDHead(model_cfg=jcfg.MODEL.ROI_HEAD, num_class=1,
                          voxel_size=tuple(ds.voxel_size),
                          point_cloud_range=tuple(ds.point_cloud_range))
    v = {c: r["vars"][c]["roi_head"] for c in ("params", "batch_stats")}
    bev = inp["spatial_features_2d"].detach()
    fixed = {k: jnp.asarray(inp[k].numpy())
             for k in ("rois", "roi_labels", "gt_boxes")}
    fixed.update(spatial_features=jnp.asarray(
        inp["spatial_features"].detach().numpy().transpose(0, 2, 3, 1)),
        spatial_features_stride=8)

    def loss_fn(p, f):
        out, mut = jhead.apply({"params": p, "batch_stats": v["batch_stats"]},
                               dict(fixed, spatial_features_2d=f), train=True,
                               mutable=["batch_stats"])
        return out["loss"], mut
    (jloss, mut), (jgp, jgf) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True))(
        v["params"], jnp.asarray(bev.numpy().transpose(0, 2, 3, 1)))

    head = copy.deepcopy(r["port"].roi_head).train()
    head.zero_grad()
    leaf = bev.clone().requires_grad_(True)
    out = head({k: inp[k] for k in ("rois", "roi_labels", "gt_boxes",
                                    "spatial_features",
                                    "spatial_features_stride")}
               | {"spatial_features_2d": leaf})
    out["loss"].backward()
    assert float(jloss) > 0.1 and set(out["tb_dict"]) == {"rcnn_iou_loss"}
    assert abs(float(out["loss"].detach()) - float(jloss)) \
        <= HEAD_RTOL * float(jloss)
    want = np.asarray(jgf).transpose(0, 3, 1, 2)
    assert np.abs(leaf.grad.numpy() - want).max() \
        <= HEAD_RTOL * np.abs(want).max()
    grads = state_dict_from_jax({"params": {"roi_head": _np(jgp)}})
    params = dict(head.named_parameters())
    assert set(grads) == {f"roi_head.{n}" for n in params}
    for name, g in grads.items():
        mine = params[name.split(".", 1)[1]].grad
        scale = float(g.abs().max())
        assert scale > 0 and float((mine - g).abs().max()) \
            <= HEAD_RTOL * scale, name
    stats = state_dict_from_jax({"batch_stats": {"roi_head": _np(
        mut["batch_stats"])}})
    buffers = dict(head.named_buffers())
    for name, s in stats.items():
        err = float((buffers[name.split(".", 1)[1]] - s).abs().max())
        assert err <= ts.STATS_TOL * max(1.0, float(s.abs().max())), name


def test_train_step_matches_reference(two_stage):
    r = two_stage
    port = ts.port_step(r["port"], r["raw"])
    assert set(port[1]) == {"rpn_loss_cls", "rpn_loss_loc", "rpn_loss_dir",
                            "rpn_loss", "rcnn_iou_loss"}
    ts.check_step(r, r["want"], port, ts.self_spread(r["port"], r["raw"]),
                  MAX_SPREAD_TENSORS)
    assert r["port"].dense_head.conv_box.weight.grad is None


def test_full_width_configs_build_in_both_packages():
    """``PartA2.yaml`` and ``second_iou.yaml`` at the KITTI geometry (1408 x
    1600 x 40 voxels of 0.05 x 0.05 x 0.1 m, 4 point features) in both
    packages: the reference's tree loads strictly into the port's model,
    with as many parameters on each side."""
    for name, pooled in (("PartA2", 12 ** 3 * 20), ("second_iou", 49 * 512)):
        path = PORT_KITTI / f"{name}.yaml"
        jcfg = jax_cfg_from_yaml(str(path), JaxEDict())
        pcfg = cfg_from_yaml_file(str(path), EDict())
        assert jcfg == pcfg
        dc = pcfg.DATA_CONFIG
        geo = dict(class_names=tuple(pcfg.CLASS_NAMES), num_point_features=4,
                   grid_size=(1408, 1600, 40),
                   point_cloud_range=tuple(float(v) for v in
                                           dc.POINT_CLOUD_RANGE),
                   voxel_size=tuple(float(v) for v in
                                    dc.DATA_PROCESSOR[-1].VOXEL_SIZE))
        v = 40000
        batch = {"voxels": jax.ShapeDtypeStruct((2, v, 5, 4), np.float32),
                 "voxel_coords": jax.ShapeDtypeStruct((2, v, 3), np.int32),
                 "voxel_num_points": jax.ShapeDtypeStruct((2, v), np.int32),
                 "batch_size": 2}
        jmodel = jax_build_network(jcfg.MODEL, len(jcfg.CLASS_NAMES),
                                   JaxDatasetInfo(**geo))
        shapes = jax.eval_shape(lambda k, b: jmodel.init(k, b, train=False),
                                jax.random.PRNGKey(0), batch)
        tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                      flax.core.unfreeze(shapes))
        state = state_dict_from_jax(tree)
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
        assert sum(p.numel() for p in model.parameters()) == sum(
            np.prod(a.shape) for a in jax.tree_util.tree_leaves(
                tree["params"]))
        assert model.roi_head.shared_fc_0.weight.shape == (256, pooled)
        assert type(model).__name__ == jcfg.MODEL.NAME
