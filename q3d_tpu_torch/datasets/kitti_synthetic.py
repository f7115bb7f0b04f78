"""Synthetic scenes at a KITTI config's own geometry.

No KITTI data is in the repository.  ``kitti_config(name)`` reads
``tools/cfgs/kitti_models/<name>.yaml`` with its MODEL and OPTIMIZATION
sections as written and puts a ``SyntheticDataset`` at the yaml's geometry
in place of the KITTI data: its POINT_CLOUD_RANGE, POINT_FEATURE_ENCODING,
FOV_POINTS_ONLY, DATA_AUGMENTOR (used by a training dataset) and
DATA_PROCESSOR (voxel size, points per voxel, the 16,000-voxel train and
40,000-voxel test caps).  Each frame is one HDL-64E-like sweep of
~120,000 points (48 ground rings and 20 objects of 500 points), which the
range crop cuts to ~63,000; ``kitti_scene`` applies the FOV crop, which
leaves ~22,000-25,000, and labels only the objects the camera sees.

Nor is KITTI's gt database (``kitti_dbinfos_train.pkl``) in the
repository: ``write_gt_database`` writes one in the reference's format
from the labelled objects of such synthetic frames (test data, of another
seed than the frames it is pasted into), for the augmentor's
``gt_sampling``.

``write_kitti_tree`` writes such frames as a KITTI tree on disk (the whole
scans, the calibration of ``CAMERA``, the labels of the objects
``kitti_scene`` labels, in the camera frame with their 2D boxes), for
``KittiDataset``, ``create_infos kitti`` and the CLIs; ``read_results``
reads result files back into the evaluator's annos, as KITTI's official
evaluation reads them.
"""

import pickle
from pathlib import Path

import numpy as np

from ..config import EDict, cfg_from_yaml_file
from ..utils import box_utils, object3d_kitti
from ..utils.box_utils import points_in_boxes_cpu
from ..utils.calibration_kitti import Calibration
from .synthetic_dataset import make_scene

KITTI_DIR = Path(__file__).resolve().parents[2] / "tools" / "cfgs" / \
    "kitti_models"
# the KITTI configs of the port's own (the two-stage detectors')
PORT_KITTI_DIR = Path(__file__).resolve().parents[1] / "cfgs" / \
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
    """The KITTI config ``name`` ("second", "pointpillar" in ``tools/``;
    "pv_rcnn", "voxel_rcnn_car" in the port's ``cfgs/``) with a
    ``SyntheticDataset`` of ``num_frames`` frames from ``seed`` at its
    geometry as its DATA_CONFIG (and its MAX_RAW_POINTS, where it collates
    the raw points)."""
    path = PORT_KITTI_DIR / f"{name}.yaml"
    if not path.exists():
        path = KITTI_DIR / f"{name}.yaml"
    cfg = cfg_from_yaml_file(str(path), EDict())
    dc = cfg.DATA_CONFIG
    cfg.DATA_CONFIG = EDict({
        "DATASET": "SyntheticDataset", "NUM_FRAMES": num_frames,
        "SEED": seed, "POINT_CLOUD_RANGE": list(dc.POINT_CLOUD_RANGE),
        "MAX_GT_BOXES": dc.MAX_GT_BOXES,
        "POINT_FEATURE_ENCODING": dc.POINT_FEATURE_ENCODING,
        "FOV_POINTS_ONLY": dc.FOV_POINTS_ONLY,
        "DATA_AUGMENTOR": dc.DATA_AUGMENTOR,
        "DATA_PROCESSOR": dc.DATA_PROCESSOR, **SCENE})
    if "MAX_RAW_POINTS" in dc:
        cfg.DATA_CONFIG.MAX_RAW_POINTS = dc.MAX_RAW_POINTS
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


def write_gt_database(ds, out_dir):
    """Write a gt database in the reference's format from every labelled
    object of the frames of ``ds`` (a SyntheticDataset at a KITTI
    geometry, FOV-cropped as ``kitti_scene`` gives them): each object's
    points inside its box, relative to the box centre, as raw float32
    (``gt_database/<frame>_<class>_<i>.bin``), and
    ``kitti_dbinfos_train.pkl`` (the name the KITTI dataset yaml's
    gt_sampling reads), ``{class: [{name, path, image_idx, gt_idx,
    box3d_lidar, num_points_in_gt, difficulty}]}`` with paths relative to
    ``out_dir`` -> {class: objects written}."""
    out_dir = Path(out_dir)
    (out_dir / "gt_database").mkdir(parents=True, exist_ok=True)
    infos = {}
    for j in range(len(ds)):
        points, boxes, names, _ = kitti_scene(ds, j)
        inside = points_in_boxes_cpu(points[:, :3], boxes).astype(bool)
        for i, (box, name) in enumerate(zip(boxes, names)):
            obj = points[inside[i]].copy()
            obj[:, :3] -= box[:3]
            rel = Path("gt_database") / f"{j}_{name}_{i}.bin"
            obj.astype(np.float32).tofile(out_dir / rel)
            infos.setdefault(str(name), []).append({
                "name": str(name), "path": str(rel), "image_idx": j,
                "gt_idx": i, "box3d_lidar": box.astype(np.float32),
                "num_points_in_gt": len(obj), "difficulty": 0})
    with open(out_dir / "kitti_dbinfos_train.pkl", "wb") as f:
        pickle.dump(infos, f)
    return {k: len(v) for k, v in infos.items()}


def camera_calibration():
    """CAMERA as a KITTI calibration: P2 (no baseline), R0_rect the
    identity, Tr_velo_to_cam the lidar -> camera axis swap (camera x =
    -lidar y, y = -lidar z, z = lidar x) plus ``t_velo_to_cam``."""
    c = CAMERA
    p2 = np.array([[c["fx"], 0.0, c["cx"], 0.0], [0.0, c["fy"], c["cy"], 0.0],
                   [0.0, 0.0, 1.0, 0.0]])
    v2c = np.array([[0.0, -1.0, 0.0, 0.0], [0.0, 0.0, -1.0, 0.0],
                    [1.0, 0.0, 0.0, 0.0]])
    v2c[:, 3] = c["t_velo_to_cam"]
    return {"P2": p2, "P3": p2, "R0": np.eye(3), "Tr_velo2cam": v2c}


def _calib_text(calib):
    def row(m):
        return " ".join(f"{v:.12e}" for v in np.asarray(m).reshape(-1))
    return (f"P0: {row(calib['P2'])}\nP1: {row(calib['P2'])}\n"
            f"P2: {row(calib['P2'])}\nP3: {row(calib['P3'])}\n"
            f"R0_rect: {row(calib['R0'])}\n"
            f"Tr_velo_to_cam: {row(calib['Tr_velo2cam'])}\n"
            f"Tr_imu_to_velo: {row(calib['Tr_velo2cam'])}\n")


def kitti_labels(boxes, names, calib):
    """Lidar boxes (N, 7) and names -> KITTI label lines: the camera box
    (bottom centre, h w l, ry), its projected 2D box clipped to the image
    and the truncation (the share of the projected box outside the image),
    occlusion 0, alpha as the prediction export computes it; 4 decimals."""
    if not len(boxes):
        return []
    shape = (CAMERA["height"], CAMERA["width"])
    cam = box_utils.boxes3d_lidar_to_kitti_camera(boxes.astype(np.float64),
                                                  calib)
    full = box_utils.boxes3d_kitti_camera_to_imageboxes(cam, calib)
    clipped = box_utils.boxes3d_kitti_camera_to_imageboxes(cam, calib, shape)

    def area(b):
        return np.maximum(b[:, 2] - b[:, 0], 0) * np.maximum(b[:, 3] - b[:, 1],
                                                             0)
    trunc = np.clip(1.0 - area(clipped) / np.maximum(area(full), 1e-9), 0, 1)
    alpha = -np.arctan2(-boxes[:, 1], boxes[:, 0]) + cam[:, 6]
    lines = []
    for k, name in enumerate(names):
        x1, y1, x2, y2 = clipped[k]
        x, y, z, l, h, w, ry = cam[k]
        lines.append(f"{name} {trunc[k]:.2f} 0 {alpha[k]:.4f} {x1:.4f} "
                     f"{y1:.4f} {x2:.4f} {y2:.4f} {h:.4f} {w:.4f} {l:.4f} "
                     f"{x:.4f} {y:.4f} {z:.4f} {ry:.4f}")
    return lines


def write_kitti_tree(ds, root, split_ids):
    """Write the frames of ``ds`` (a SyntheticDataset at a KITTI geometry,
    ``kitti_config``) as a KITTI tree under ``root``: ``split_ids`` maps a
    split to its sample ids (6-digit strings), which take the frames of
    ``ds`` in turn across the splits.  For each: ``training/velodyne/
    <id>.bin`` (the whole scan, float32 x, y, z, intensity),
    ``training/calib/<id>.txt`` (``camera_calibration``), ``training/
    label_2/<id>.txt`` (``kitti_labels`` of the objects ``kitti_scene``
    labels), and ``ImageSets/<split>.txt`` -> {split: objects labelled}."""
    root = Path(root)
    split_dir = root / "training"
    for sub in ("velodyne", "calib", "label_2"):
        (split_dir / sub).mkdir(parents=True, exist_ok=True)
    (root / "ImageSets").mkdir(parents=True, exist_ok=True)
    calib_dict = camera_calibration()
    calib = Calibration(calib_dict)
    text = _calib_text(calib_dict)
    j, labelled = 0, {}
    for split, ids in split_ids.items():
        labelled[split] = 0
        for sid in ids:
            points, boxes, names = make_scene(
                np.random.RandomState(ds.base_seed + j), ds.point_cloud_range,
                **ds.scene_kwargs)
            seen = kitti_fov(boxes[:, :3])
            points.astype(np.float32).tofile(split_dir / "velodyne"
                                             / f"{sid}.bin")
            (split_dir / "calib" / f"{sid}.txt").write_text(text)
            lines = kitti_labels(boxes[seen], names[seen], calib)
            (split_dir / "label_2" / f"{sid}.txt").write_text(
                "".join(line + "\n" for line in lines))
            labelled[split] += len(lines)
            j += 1
        (root / "ImageSets" / f"{split}.txt").write_text(
            "".join(f"{sid}\n" for sid in ids))
    return labelled


def read_results(result_dir, frame_ids):
    """KITTI result files (``<result_dir>/<frame>.txt``, the label layout
    with a score) -> one anno a frame, in the evaluator's format (name,
    truncated, occluded, alpha, bbox, dimensions l h w, location,
    rotation_y, score)."""
    annos = []
    for fid in frame_ids:
        objs = object3d_kitti.get_objects_from_label(
            str(Path(result_dir) / f"{fid}.txt"))
        annos.append({
            "name": np.asarray([o.cls_type for o in objs]),
            "truncated": np.asarray([o.truncation for o in objs]),
            "occluded": np.asarray([o.occlusion for o in objs]),
            "alpha": np.asarray([o.alpha for o in objs]),
            "bbox": np.stack([o.box2d for o in objs]) if objs
            else np.zeros((0, 4)),
            "dimensions": np.asarray([[o.l, o.h, o.w] for o in objs])
            .reshape(-1, 3),
            "location": np.stack([o.loc for o in objs]) if objs
            else np.zeros((0, 3)),
            "rotation_y": np.asarray([o.ry for o in objs]),
            "score": np.asarray([o.score for o in objs]),
            "frame_id": fid})
    return annos
