"""Synthetic scenes at the Lyft config's own geometry.

No Lyft data is in the repository.  ``lyft_config()`` reads
``tools/cfgs/lyft_models/cbgs_second_multihead.yaml`` with its MODEL and
OPTIMIZATION sections as written and puts a ``SyntheticDataset`` at the
dataset yaml's geometry in place of the Lyft data: its POINT_CLOUD_RANGE
(+-80 m, [-5, 3] m), MAX_GT_BOXES, POINT_FEATURE_ENCODING (x, y, z,
intensity, timestamp), DATA_AUGMENTOR (flips, rotation, scaling; no gt
sampler) and DATA_PROCESSOR (0.1 x 0.1 x 0.2 m voxels, 10 points a voxel,
the 60,000-voxel caps).

Cuts, against a Lyft frame: one sweep, so the timestamp column is 0
(``SyntheticDataset.scene``), where the config's MAX_SWEEPS stacks 10;
the scenes' objects are of three kinds, named by class ids 1-3 (car,
truck, bus), so the heads of the other six classes see no object.  Each
frame is ``SCENE``'s ground rings and objects, dense enough to fill
40,000-60,000 voxels (``scene_counts``) without reaching the cap.
"""

from pathlib import Path

import numpy as np

from ..config import EDict, cfg_from_yaml_file

LYFT_CFG = Path(__file__).resolve().parents[2] / "tools" / "cfgs" / \
    "lyft_models" / "cbgs_second_multihead.yaml"
SCENE = {"NUM_BG_POINTS": 55000, "NUM_OBJECTS": 40, "POINTS_PER_OBJECT": 500}
# the scenes' object kinds, class ids 1-3 in order (the dataset's class
# names; the model's are the config's)
SCENE_CLASSES = ("Car", "Pedestrian", "Cyclist")
# the fewest points an object keeps to count as present
MIN_OBJECT_POINTS = 5


def lyft_config(num_frames, seed):
    """The Lyft config with a ``SyntheticDataset`` of ``num_frames`` frames
    from ``seed`` at its geometry as its DATA_CONFIG.  Build its loader
    with ``SCENE_CLASSES`` as the class names (the model takes the
    config's CLASS_NAMES)."""
    cfg = cfg_from_yaml_file(str(LYFT_CFG), EDict())
    dc = cfg.DATA_CONFIG
    cfg.DATA_CONFIG = EDict({
        "DATASET": "SyntheticDataset", "NUM_FRAMES": num_frames,
        "SEED": seed, "POINT_CLOUD_RANGE": list(dc.POINT_CLOUD_RANGE),
        "MAX_GT_BOXES": dc.MAX_GT_BOXES,
        "POINT_FEATURE_ENCODING": dc.POINT_FEATURE_ENCODING,
        "DATA_AUGMENTOR": dc.DATA_AUGMENTOR,
        "DATA_PROCESSOR": dc.DATA_PROCESSOR, **SCENE})
    return cfg


# the small model of the CPU tests and the card's quick training check: the
# yaml cut to a small grid and narrow widths (+-16 m at 0.4 x 0.4 x 0.2 m
# voxels, keeping the yaml's heights and so its 256 BEV features; 10 x 10
# BEV cells, 1,800 anchors a frame; scenes of 8,000 ground points, ~5,000
# voxels, under the 6,000 cap), the BEV backbone at [1, 1] layers of
# [32, 64] filters, the shared conv at 16, and NMS_PRE_MAXSIZE 256 (a
# class's 200 anchors a frame all fit; the plain NMS's rotated IoU of 18
# sets at K = 1024 takes ~1 min on a CPU)
SMALL = {"POINT_CLOUD_RANGE": [-16.0, -16.0, -5.0, 16.0, 16.0, 3.0],
         "VOXEL_SIZE": [0.4, 0.4, 0.2], "MAX_VOXELS": 6000,
         "LAYER_NUMS": [1, 1], "NUM_FILTERS": [32, 64],
         "NUM_UPSAMPLE_FILTERS": [32, 32], "SHARED_CONV_NUM_FILTER": 16,
         "NMS_PRE_MAXSIZE": 256, "NUM_BG_POINTS": 8000}


def small_config(cfg, frames, seed):
    """The Lyft config ``cfg`` (either package's reader's) cut to ``SMALL``
    in place, on a SyntheticDataset of ``frames`` frames from ``seed`` with
    the yaml's point features and processors, no augmentor -> cfg."""
    dc = cfg.DATA_CONFIG
    proc = dc.DATA_PROCESSOR[-1]
    proc.VOXEL_SIZE = SMALL["VOXEL_SIZE"]
    proc.MAX_NUMBER_OF_VOXELS = {"train": SMALL["MAX_VOXELS"],
                                 "test": SMALL["MAX_VOXELS"]}
    cfg.DATA_CONFIG = type(dc)({
        "DATASET": "SyntheticDataset", "NUM_FRAMES": frames, "SEED": seed,
        "NUM_BG_POINTS": SMALL["NUM_BG_POINTS"],
        "POINT_CLOUD_RANGE": SMALL["POINT_CLOUD_RANGE"],
        "MAX_GT_BOXES": dc.MAX_GT_BOXES,
        "POINT_FEATURE_ENCODING": dc.POINT_FEATURE_ENCODING,
        "DATA_PROCESSOR": dc.DATA_PROCESSOR})
    b2d = cfg.MODEL.BACKBONE_2D
    for k in ("LAYER_NUMS", "NUM_FILTERS", "NUM_UPSAMPLE_FILTERS"):
        b2d[k] = SMALL[k]
    cfg.MODEL.DENSE_HEAD.SHARED_CONV_NUM_FILTER = \
        SMALL["SHARED_CONV_NUM_FILTER"]
    cfg.MODEL.POST_PROCESSING.NMS_CONFIG.NMS_PRE_MAXSIZE = \
        SMALL["NMS_PRE_MAXSIZE"]
    return cfg


def scene_counts(ds):
    """Per frame of ``ds`` (test mode): points in range, voxels those
    occupy and voxels the capped voxelizer keeps, objects labelled and how
    many keep MIN_OBJECT_POINTS points in range."""
    from ..utils.box_utils import points_in_boxes_cpu
    rows = []
    for j in range(len(ds)):
        points, boxes, names = ds.scene(j)
        d = ds.prepare_data({"points": points, "gt_boxes": boxes,
                             "gt_names": names, "frame_id": j})
        pts = d["points"]
        cells = np.floor((pts[:, :3] - ds.point_cloud_range[:3])
                         / ds.voxel_size).astype(np.int64)
        boxes = d["gt_boxes"][:, :7]
        inside = points_in_boxes_cpu(pts[:, :3], boxes).sum(1) \
            if len(boxes) else np.zeros(0)
        rows.append({"frame": j, "points_in_range": len(pts),
                     "voxels_occupied": len(np.unique(cells, axis=0)),
                     "voxels_kept": int((d["voxel_num_points"] > 0).sum()),
                     "objects_labelled": len(boxes),
                     "objects_present": int((inside >= MIN_OBJECT_POINTS)
                                            .sum())})
    return rows
