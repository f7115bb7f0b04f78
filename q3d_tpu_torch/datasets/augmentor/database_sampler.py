"""GT-paste ("copy-paste") augmentation from a database of objects (port of
``q3d_tpu/datasets/augmentor/database_sampler.py``): class-balanced sample
groups ('Car:15'), the PREPARE filters (``filter_by_min_points``,
``filter_by_difficulty``), BEV collision rejection against the scene's
and the already placed boxes, removal of the scene's points inside the
placed boxes (enlarged by ``REMOVE_EXTRA_WIDTH``), road-plane lifting
(``USE_ROAD_PLANE``), and the merge of points and labels.

The database is the reference's: a pickle ``{class_name: [{name, path,
box3d_lidar (7,), num_points_in_gt, difficulty[, global_data_offset]}]}``
whose ``path`` holds an object's (N, C) float32 points relative to its box
centre (``.npy``, or raw float32 with ``num_features`` columns, else the
config's ``NUM_POINT_FEATURES``, else 4), or an integrated ``.npy`` (``DB_DATA_PATH``) that the infos'
``global_data_offset`` slice, memory-mapped and checked once against the
largest offset.  A database that is not there logs a warning, and the
sampler then places nothing.  Draws (the groups' shuffles) come from
``rng``.
"""

import pickle
from pathlib import Path

import numpy as np
import torch

from ...utils import box_utils


class DataBaseSampler:
    def __init__(self, root_path, sampler_cfg, class_names, logger=None,
                 rng=None):
        self.root_path = Path(root_path)
        self.sampler_cfg = sampler_cfg
        self.class_names = class_names
        self.logger = logger
        self.rng = rng if rng is not None else np.random.mtrand._rand
        self.db_infos = {c: [] for c in class_names}
        for db_path in sampler_cfg.DB_INFO_PATH:
            p = self._resolve(db_path)
            if p is None:
                if logger:
                    logger.warning(f"gt database {db_path} not found; "
                                   f"gt_sampling becomes a no-op")
                continue
            with open(p, "rb") as f:
                infos = pickle.load(f)
            for c in class_names:
                self.db_infos[c].extend(infos.get(c, []))

        for func_name, val in sampler_cfg.get("PREPARE", {}).items():
            if any(self.db_infos.values()):
                self.db_infos = getattr(self, func_name)(self.db_infos, val)

        self.sample_groups = {}
        for group in sampler_cfg.SAMPLE_GROUPS:
            name, num = group.split(":")
            if name in class_names:
                self.sample_groups[name] = {
                    "num": int(num), "pointer": len(self.db_infos[name]),
                    "indices": np.arange(len(self.db_infos[name]))}
        self.limit_whole_scene = sampler_cfg.get("LIMIT_WHOLE_SCENE", False)

        # the integrated database, memory-mapped at the first object read
        self._global_db = None
        self._global_db_path = None
        db_data = sampler_cfg.get("DB_DATA_PATH", None)
        if db_data:
            self._global_db_path = self._resolve(db_data[0])
            if self._global_db_path is None and logger:
                logger.warning(f"integrated db {db_data[0]} not found; "
                               f"falling back to per-object files")

    def _resolve(self, path):
        """``path`` under the root, else as given; None if neither is
        there."""
        for p in (self.root_path / path, Path(path)):
            if p.exists():
                return p
        return None

    # ------------------------------ filters -------------------------------

    def filter_by_min_points(self, db_infos, min_gt_points_list):
        for pair in min_gt_points_list:
            name, n = pair.split(":")
            n = int(n)
            if name in db_infos:
                db_infos[name] = [x for x in db_infos[name]
                                  if x.get("num_points_in_gt", n) >= n]
        return db_infos

    def filter_by_difficulty(self, db_infos, removed_difficulty):
        for key in db_infos:
            db_infos[key] = [x for x in db_infos[key]
                             if x.get("difficulty", 0) not in removed_difficulty]
        return db_infos

    # --------------------------- road-plane lift --------------------------

    @staticmethod
    def put_boxes_on_road_planes(gt_boxes, road_plane, calib):
        """Drop each box onto the ground plane [a, b, c, d] of the camera
        (rect) frame: the plane's camera-y at the box centre, back to lidar
        z, and the box shifted so that its bottom face touches the plane
        -> (lifted boxes, each box's shift ``mv_height``)."""
        gt_boxes = gt_boxes.copy()
        a, b, c, d = road_plane
        center_cam = calib.lidar_to_rect(gt_boxes[:, 0:3])
        cur_height_cam = (-d - a * center_cam[:, 0] - c * center_cam[:, 2]) / b
        center_cam[:, 1] = cur_height_cam
        cur_lidar_height = calib.rect_to_lidar(center_cam)[:, 2]
        mv_height = gt_boxes[:, 2] - gt_boxes[:, 5] / 2 - cur_lidar_height
        gt_boxes[:, 2] -= mv_height
        return gt_boxes, mv_height

    # ------------------------------ sampling ------------------------------

    def _sample_with_fixed_number(self, class_name, num):
        group = self.sample_groups[class_name]
        if group["pointer"] + num >= len(group["indices"]):
            self.rng.shuffle(group["indices"])
            group["pointer"] = 0
        picked = group["indices"][group["pointer"]:group["pointer"] + num]
        group["pointer"] += num
        return [self.db_infos[class_name][i] for i in picked]

    def __call__(self, data_dict=None, **kwargs):
        if data_dict is None:
            return self
        if not any(len(v) for v in self.db_infos.values()):
            return data_dict
        gt_boxes = data_dict["gt_boxes"]
        gt_names = data_dict["gt_names"]
        points = data_dict["points"]

        placed_boxes, placed_names, placed_points = [], [], []
        occupied = gt_boxes[:, :7] if len(gt_boxes) \
            else np.zeros((0, 7), np.float32)
        for class_name, group in self.sample_groups.items():
            if not len(self.db_infos[class_name]):
                continue
            num = group["num"]
            if self.limit_whole_scene:
                num -= int((gt_names == class_name).sum())
            if num <= 0:
                continue
            samples = self._sample_with_fixed_number(class_name, num)
            cand_boxes = np.stack(
                [np.asarray(s["box3d_lidar"], np.float32) for s in samples])
            if self.sampler_cfg.get("USE_ROAD_PLANE", False) \
                    and "road_plane" in data_dict:
                lifted, _ = self.put_boxes_on_road_planes(
                    cand_boxes[:, :7], data_dict["road_plane"],
                    data_dict["calib"])
                cand_boxes = cand_boxes.copy()
                cand_boxes[:, :7] = lifted
            # collision check against the scene's and the placed boxes
            for s, box in zip(samples, cand_boxes):
                if len(occupied):
                    iou = box_utils.boxes3d_nearest_bev_iou(
                        torch.from_numpy(box[None, :7]),
                        torch.from_numpy(occupied))
                    if iou.max() > 1e-3:
                        continue
                obj_points = self._load_points(s)
                if obj_points is None:
                    continue
                placed_boxes.append(box)
                placed_names.append(class_name)
                # the database's points are relative to the box centre (a
                # lifted centre carries the road plane's shift already)
                pts = obj_points.copy()
                pts[:, :3] += box[None, :3]
                placed_points.append(pts)
                occupied = np.concatenate([occupied, box[None, :7]], axis=0)

        if not placed_boxes:
            return data_dict
        placed_boxes = np.stack(placed_boxes)
        # drop the scene's points inside the (enlarged) placed boxes, merge
        large = box_utils.enlarge_box3d(
            placed_boxes[:, :7],
            extra_width=self.sampler_cfg.get("REMOVE_EXTRA_WIDTH", (0, 0, 0)))
        points = box_utils.remove_points_in_boxes3d(points, large)
        obj_pts = np.concatenate(placed_points, axis=0)
        if obj_pts.shape[1] < points.shape[1]:
            pad = np.zeros((len(obj_pts), points.shape[1] - obj_pts.shape[1]),
                           np.float32)
            obj_pts = np.concatenate([obj_pts, pad], axis=1)
        data_dict["points"] = np.concatenate([obj_pts[:, :points.shape[1]],
                                              points], axis=0)
        width = gt_boxes.shape[1] if len(gt_boxes) else 7
        if placed_boxes.shape[1] < width:
            placed_boxes = np.concatenate(
                [placed_boxes, np.zeros((len(placed_boxes),
                                         width - placed_boxes.shape[1]),
                                        np.float32)], axis=1)
        data_dict["gt_boxes"] = np.concatenate(
            [gt_boxes, placed_boxes[:, :width]], axis=0) if len(gt_boxes) \
            else placed_boxes[:, :width]
        data_dict["gt_names"] = np.concatenate(
            [gt_names, np.asarray(placed_names)])
        if "gt_boxes_mask" in data_dict:
            data_dict["gt_boxes_mask"] = np.concatenate(
                [data_dict["gt_boxes_mask"],
                 np.ones(len(placed_boxes), bool)])
        return data_dict

    def _load_points(self, info):
        if "global_data_offset" in info and self._global_db_path is not None:
            if self._global_db is None:
                self._global_db = np.load(self._global_db_path,
                                          mmap_mode="r")
                # a rebuilt .npy beside older infos would give wrong
                # objects: check once that it covers every info's offsets
                max_end = max((int(ci["global_data_offset"][1])
                               for infos in self.db_infos.values()
                               for ci in infos
                               if ci.get("global_data_offset") is not None),
                              default=0)
                if max_end > self._global_db.shape[0]:
                    raise RuntimeError(
                        f"integrated GT database {self._global_db_path} has "
                        f"{self._global_db.shape[0]} rows but infos "
                        f"reference offsets up to {max_end}; the .npy and "
                        "the info pickles are out of sync")
            s, e = info["global_data_offset"]
            return np.array(self._global_db[s:e], np.float32)
        p = self._resolve(info["path"])
        if p is None:
            return None
        if str(p).endswith(".npy"):
            return np.load(p).astype(np.float32)
        # the nuScenes database's infos carry no num_features: its points
        # have the config's NUM_POINT_FEATURES columns (the reference
        # reshapes them into 4, ROADMAP.md section 3)
        num_feats = int(info.get("num_features", self.sampler_cfg.get(
            "NUM_POINT_FEATURES", 4)))
        return np.fromfile(p, np.float32).reshape(-1, num_feats)
