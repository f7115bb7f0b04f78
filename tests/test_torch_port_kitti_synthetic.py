"""The KITTI-geometry synthetic scenes of ``q3d_tpu_torch.datasets.
kitti_synthetic`` and the anchor heads' NMS input of ``tools.nms_ab``
(both used on the card by ``chip_smoke.py``; no JAX counterpart).

* ``kitti_fov`` equals the camera projection written as matrices
  (``P2 @ Tr_velo_to_cam``), the image bounds and the in-front test.
* ``kitti_scene`` keeps only points the camera sees and labels only the
  objects whose centre it sees, each keeping its own points.
* A SECOND frame fits under the 40,000-voxel cap with every labelled
  object present, as ``chip_smoke.py`` requires on the card.
* ``anchor_candidates``: the first NMS_PRE_MAXSIZE anchors by best class
  score (stable), valid at SCORE_THRESH, and under the prior bias valid
  exactly where the best logit clears the shifted threshold.
"""

import numpy as np
import torch

from q3d_tpu_torch.datasets import build_dataloader
from q3d_tpu_torch.datasets.kitti_synthetic import (CAMERA, kitti_config,
                                                    kitti_fov, kitti_scene,
                                                    scene_counts)
from q3d_tpu_torch.tools import nms_ab
from torch_port_jax_cache import jax_compile_cache  # noqa: F401

torch.set_num_threads(2)


def _dataset(name, frames=1):
    cfg = kitti_config(name, num_frames=frames, seed=0)
    ds, _, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                batch_size=1, training=False)
    return cfg, ds


def test_kitti_fov_equals_the_matrix_projection():
    c = CAMERA
    p2 = np.array([[c["fx"], 0, c["cx"], 0], [0, c["fy"], c["cy"], 0],
                   [0, 0, 1, 0]])
    tr = np.array([[0, -1, 0, c["t_velo_to_cam"][0]],
                   [0, 0, -1, c["t_velo_to_cam"][1]],
                   [1, 0, 0, c["t_velo_to_cam"][2]], [0, 0, 0, 1]])
    rng = np.random.RandomState(0)
    xyz = rng.uniform([-20, -60, -4], [80, 60, 3], (20000, 3))
    uvw = (p2 @ tr @ np.c_[xyz, np.ones(len(xyz))].T).T
    front = uvw[:, 2] > 0
    u = uvw[:, 0] / np.where(front, uvw[:, 2], 1)
    v = uvw[:, 1] / np.where(front, uvw[:, 2], 1)
    want = front & (u >= 0) & (u < c["width"]) & (v >= 0) & (v < c["height"])
    got = kitti_fov(xyz)
    assert 0.1 < want.mean() < 0.9
    # the two forms round differently only within an ulp of an image edge
    assert (got != want).sum() <= 2
    assert kitti_fov(np.array([[10.0, 0, -1.6], [5.0, 0, -1.6],
                               [-5.0, 0, 0]])).tolist() == [True, False,
                                                            False]


def test_kitti_scene_keeps_what_the_camera_sees():
    _, ds = _dataset("pointpillar", frames=2)
    for j in range(2):
        points, boxes, names, obj_points = kitti_scene(ds, j)
        assert kitti_fov(points[:, :3]).all()
        assert kitti_fov(boxes[:, :3]).all()
        assert 0 < len(boxes) < ds.scene_kwargs["num_objects"]
        assert len(names) == len(obj_points) == len(boxes)
        assert min(obj_points) >= 5
        assert sum(obj_points) <= len(points)


def test_second_frame_fits_under_the_voxel_cap():
    cfg, ds = _dataset("second")
    cap = int(cfg.DATA_CONFIG.DATA_PROCESSOR[-1].MAX_NUMBER_OF_VOXELS["test"])
    (row,) = scene_counts(ds)
    assert 16000 <= row["voxels_kept"] == row["voxels_occupied"] < cap
    assert row["objects_present"] == row["objects_labelled"] > 0
    assert row["points_in_range"] == row["points_in_fov"]


def test_anchor_candidates_order_and_validity():
    cfg, _ = _dataset("pointpillar")
    post = cfg.MODEL.POST_PROCESSING
    post.NMS_CONFIG.NMS_PRE_MAXSIZE = 300
    g = torch.Generator().manual_seed(0)
    logits = torch.randn((2, 1000, 3), generator=g) * 1.5
    logits[:, 500:510] = logits[:, 400:410]           # ties keep index order
    box_preds = torch.randn((2, 1000, 7), generator=g)
    boxes, valid, prior_valid = nms_ab.anchor_candidates(
        {"batch_cls_preds": logits, "batch_box_preds": box_preds}, cfg)
    best = logits.max(-1).values
    thresh = float(post.SCORE_THRESH)
    for b in range(2):
        order = np.argsort(-torch.sigmoid(best[b]).numpy(), kind="stable")
        order = order[:300]
        np.testing.assert_array_equal(boxes[b].numpy(),
                                      box_preds[b, order].numpy())
        np.testing.assert_array_equal(
            valid[b].numpy(), torch.sigmoid(best[b, order]).numpy() >= thresh)
        shifted = np.log(thresh / (1 - thresh)) - nms_ab.CLS_PRIOR_BIAS
        lo = best[b, order].numpy()
        near = np.abs(lo - shifted) < 1e-5
        np.testing.assert_array_equal(prior_valid[b].numpy()[~near],
                                      lo[~near] >= shifted)
    assert 0 < prior_valid.sum() < valid.sum()
    labels = [label for label, _ in nms_ab.validities(valid, prior_valid)]
    assert labels[0].endswith("(all valid)")
    sets = dict(nms_ab.validities(valid, prior_valid))
    assert sets[labels[2]].sum(1).tolist() == [
        int(v[:nms_ab.VALID_FIRST].sum()) for v in valid]
