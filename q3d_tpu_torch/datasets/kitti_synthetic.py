"""Synthetic scenes at a KITTI config's own geometry.

No KITTI data is in the repository.  ``kitti_config(name)`` reads
``tools/cfgs/kitti_models/<name>.yaml`` with its MODEL section as written
and puts a ``SyntheticDataset`` at the yaml's geometry in place of the KITTI
data: its POINT_CLOUD_RANGE, POINT_FEATURE_ENCODING and DATA_PROCESSOR
(voxel size, points per voxel, the 40,000-voxel test cap).  Each frame is
one HDL-64E-like sweep of ~120,000 points (48 ground rings and 20 objects
of 500 points), which the range crop cuts to ~63,000; ``kitti_scene``
applies the dataset yaml's FOV crop (``FOV_POINTS_ONLY``), which leaves
~22,000-25,000, and labels only the objects the camera sees.
"""

from pathlib import Path

import numpy as np

from ..config import EDict, cfg_from_yaml_file
from .synthetic_dataset import make_scene

KITTI_DIR = Path(__file__).resolve().parents[2] / "tools" / "cfgs" / \
    "kitti_models"
SCENE = {"NUM_BG_POINTS": 110000, "NUM_OBJECTS": 20, "POINTS_PER_OBJECT": 500}
# FOV_POINTS_ONLY keeps the points that project into the front camera's
# image: a typical KITTI calibration's P2 (fx, fy, cx, cy), the 1242 x 375
# image, lidar to camera as the axis swap plus Tr_velo_to_cam's translation
# (rotation residue and R0_rect, each under a degree, left out)
CAMERA = {"fx": 721.5377, "fy": 721.5377, "cx": 609.5593, "cy": 172.854,
          "width": 1242, "height": 375, "t_velo_to_cam": (-0.004, -0.076,
                                                          -0.272)}
# the fewest points an object keeps to count as present (the KITTI
# database's filter_by_min_points)
MIN_OBJECT_POINTS = 5


def kitti_config(name, num_frames, seed):
    """The KITTI config ``name`` ("second", "pointpillar") with a
    ``SyntheticDataset`` of ``num_frames`` frames from ``seed`` at its
    geometry as its DATA_CONFIG."""
    cfg = cfg_from_yaml_file(str(KITTI_DIR / f"{name}.yaml"), EDict())
    dc = cfg.DATA_CONFIG
    cfg.DATA_CONFIG = EDict({
        "DATASET": "SyntheticDataset", "NUM_FRAMES": num_frames,
        "SEED": seed, "POINT_CLOUD_RANGE": list(dc.POINT_CLOUD_RANGE),
        "MAX_GT_BOXES": dc.MAX_GT_BOXES,
        "POINT_FEATURE_ENCODING": dc.POINT_FEATURE_ENCODING,
        "DATA_PROCESSOR": dc.DATA_PROCESSOR, **SCENE})
    return cfg


def kitti_fov(xyz):
    """FOV_POINTS_ONLY's flag: points (N, 3) in lidar coordinates that
    project into CAMERA's image, in front of it -> bool (N,)."""
    c = CAMERA
    t = c["t_velo_to_cam"]
    xc, yc, zc = -xyz[:, 1] + t[0], -xyz[:, 2] + t[1], xyz[:, 0] + t[2]
    front = zc > 0
    zs = np.where(front, zc, 1.0)
    u = c["fx"] * xc / zs + c["cx"]
    v = c["fy"] * yc / zs + c["cy"]
    return front & (u >= 0) & (u < c["width"]) & (v >= 0) & (v < c["height"])


def kitti_scene(ds, j):
    """Frame ``j`` of the synthetic dataset ``ds`` as the KITTI data path
    gives it: the sweep ``ds[j]`` is made from, cropped to the camera's
    FOV, and labels only for the objects whose centre lies in it, as KITTI
    labels only what the camera sees -> (points, gt_boxes, gt_names, points
    each labelled object keeps)."""
    points, boxes, names = make_scene(np.random.RandomState(ds.base_seed + j),
                                      ds.point_cloud_range, **ds.scene_kwargs)
    keep = kitti_fov(points[:, :3])
    # make_scene puts the ground first, then each object's points in turn
    per = ds.scene_kwargs["points_per_object"]
    obj_keep = keep[len(points) - len(boxes) * per:].reshape(len(boxes), per)
    seen = kitti_fov(boxes[:, :3])
    return (points[keep], boxes[seen], names[seen],
            obj_keep.sum(1)[seen].tolist())


def scene_counts(ds):
    """Per frame of ``ds``: points generated, points left by the FOV crop
    and by the range crop, voxels those occupy and voxels the capped
    voxelizer keeps, objects labelled (centre in the FOV) and how many of
    them keep MIN_OBJECT_POINTS points after the crop."""
    rows = []
    for j in range(len(ds)):
        points, boxes, names, obj_points = kitti_scene(ds, j)
        d = ds.prepare_data({"points": points, "gt_boxes": boxes,
                             "gt_names": names, "frame_id": j})
        pts = d["points"]
        cells = np.floor((pts[:, :3] - ds.point_cloud_range[:3])
                         / ds.voxel_size).astype(np.int64)
        kw = ds.scene_kwargs
        rows.append({"frame": j,
                     "points_generated": 48 * (kw["num_bg_points"] // 48)
                     + kw["num_objects"] * kw["points_per_object"],
                     "points_in_fov": len(points),
                     "points_in_range": len(pts),
                     "voxels_occupied": len(np.unique(cells, axis=0)),
                     "voxels_kept": int((d["voxel_num_points"] > 0).sum()),
                     "objects_labelled": len(obj_points),
                     "objects_present": sum(
                         n >= MIN_OBJECT_POINTS for n in obj_points)})
    return rows
