"""nuScenes dataset: info-driven multi-sweep loading and CBGS resampling.

Port of ``q3d_tpu/datasets/nuscenes/nuscenes_dataset.py``: the key frame
plus ``MAX_SWEEPS - 1`` earlier sweeps drawn from its info (each moved into
the key frame by its transform, ego-proximal points dropped, its time lag
as the fifth point feature), the class-balanced resampling (CBGS), the
``FILTER_MIN_POINTS_IN_GT`` filter, prediction formatting with default
attributes, and ``evaluation`` through the port's nuScenes evaluator
(``nuscenes_eval.py``).  The sweep choice and CBGS draw from ``rng`` (a
``np.random.RandomState``, by default numpy's global one), in the
reference's order, so a RandomState seeded as ``np.random.seed`` was gives
the reference's frames.
"""

import pickle
from pathlib import Path

import numpy as np

from ..dataset import DatasetTemplate

# the most common attribute of each class (the devkit's cls_attr_dist
# argmax), for the stationary and unknown cases
_STATIC_ATTR = {
    "car": "vehicle.parked", "truck": "vehicle.parked",
    "trailer": "vehicle.parked", "bus": "vehicle.stopped",
    "construction_vehicle": "vehicle.parked",
    "bicycle": "cycle.without_rider", "motorcycle": "cycle.without_rider",
    "pedestrian": "pedestrian.standing",
}


def default_attributes(boxes, names):
    """Attributes from the velocity: moving vehicles -> vehicle.moving,
    moving cycles -> cycle.with_rider, else the class's most common
    attribute."""
    attrs = []
    for box, name in zip(boxes, names):
        speed = float(np.linalg.norm(box[7:9])) if len(box) >= 9 else 0.0
        if speed > 0.2:
            if name in ("car", "construction_vehicle", "bus", "truck",
                        "trailer"):
                attrs.append("vehicle.moving")
                continue
            if name in ("bicycle", "motorcycle"):
                attrs.append("cycle.with_rider")
                continue
        attrs.append(_STATIC_ATTR.get(name, ""))
    return np.asarray(attrs)


class NuScenesDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=True, root_path=None,
                 logger=None, rng=None):
        super().__init__(dataset_cfg=dataset_cfg, class_names=class_names,
                         training=training, root_path=root_path, logger=logger,
                         rng=rng)
        self.infos = []
        self.include_nuscenes_data(self.mode)
        if self.training and self.dataset_cfg.get("BALANCED_RESAMPLING", False):
            self.infos = self.balanced_infos_resampling(self.infos)
        self.max_sweeps = self.dataset_cfg.get("MAX_SWEEPS", 10)

    def include_nuscenes_data(self, mode):
        infos = []
        for info_path in self.dataset_cfg.INFO_PATH[mode]:
            p = self.root_path / info_path
            if not p.exists():
                if self.logger:
                    self.logger.warning(f"info file {p} missing")
                continue
            with open(p, "rb") as f:
                infos.extend(pickle.load(f))
        self.infos = infos
        if self.logger:
            self.logger.info(f"nuScenes samples: {len(infos)}")

    def balanced_infos_resampling(self, infos):
        """CBGS: each class's frames drawn with replacement so that every
        class appears about equally often."""
        cls_infos = {name: [] for name in self.class_names}
        for info in infos:
            for name in set(info["gt_names"]):
                if name in cls_infos:
                    cls_infos[name].append(info)
        duplicated = sum(len(v) for v in cls_infos.values())
        if duplicated == 0:
            return infos
        frac = 1.0 / len(self.class_names)
        sampled = []
        for v in cls_infos.values():
            if len(v) == 0:
                continue
            ratio = frac * duplicated / len(v)
            sampled += [v[i] for i in self.rng.choice(
                len(v), int(len(v) * ratio), replace=True)]
        if self.logger:
            self.logger.info(f"CBGS resampling: {len(infos)} -> {len(sampled)}")
        return sampled

    # ------------------------------ points --------------------------------

    def get_sweep(self, sweep_info):
        lidar_path = self.root_path / sweep_info["lidar_path"]
        points = np.fromfile(str(lidar_path), np.float32).reshape(-1, 5)[:, :4]
        # remove ego-proximal points
        mask = ~((np.abs(points[:, 0]) < 1.0) & (np.abs(points[:, 1]) < 1.0))
        points = points[mask]
        if sweep_info.get("transform_matrix", None) is not None:
            T = sweep_info["transform_matrix"]
            hom = np.hstack([points[:, :3],
                             np.ones((len(points), 1), np.float32)])
            points[:, :3] = (hom @ T.T)[:, :3]
        times = sweep_info.get("time_lag", 0.0) * np.ones((len(points), 1),
                                                          np.float32)
        return points, times

    def get_lidar_with_sweeps(self, index, max_sweeps=1):
        info = self.infos[index]
        lidar_path = self.root_path / info["lidar_path"]
        points = np.fromfile(str(lidar_path), np.float32).reshape(-1, 5)[:, :4]
        sweep_points = [points]
        sweep_times = [np.zeros((len(points), 1), np.float32)]
        for k in self.rng.choice(len(info.get("sweeps", [])),
                                 min(max_sweeps - 1,
                                     len(info.get("sweeps", []))),
                                 replace=False):
            p, t = self.get_sweep(info["sweeps"][k])
            sweep_points.append(p)
            sweep_times.append(t)
        points = np.concatenate(sweep_points, axis=0)
        times = np.concatenate(sweep_times, axis=0)
        return np.concatenate([points, times], axis=1)

    # ------------------------------ access --------------------------------

    def __len__(self):
        return len(self.infos)

    def __getitem__(self, index):
        info = self.infos[index]
        points = self.get_lidar_with_sweeps(index, max_sweeps=self.max_sweeps)
        input_dict = {
            "points": points,
            "frame_id": Path(info["lidar_path"]).stem,
            "metadata": {"token": info.get("token", "")},
        }
        if "gt_boxes" in info:
            if self.dataset_cfg.get("FILTER_MIN_POINTS_IN_GT", False):
                mask = info["num_lidar_pts"] > \
                    self.dataset_cfg.FILTER_MIN_POINTS_IN_GT - 1
            else:
                mask = np.ones(len(info["gt_boxes"]), bool)
            input_dict["gt_boxes"] = info["gt_boxes"][mask]
            input_dict["gt_names"] = info["gt_names"][mask]
        return self.prepare_data(data_dict=input_dict)

    # --------------------------- predictions ------------------------------

    def generate_prediction_dicts(self, batch_dict, pred_arrays, class_names,
                                  output_path=None):
        annos = []
        B = pred_arrays["final_boxes"].shape[0]
        for b in range(B):
            valid = pred_arrays["final_valid"][b].astype(bool)
            boxes = pred_arrays["final_boxes"][b][valid]
            labels = pred_arrays["final_labels"][b][valid].astype(int)
            names = np.asarray([class_names[i - 1] for i in labels])
            annos.append({
                "frame_id": batch_dict["frame_id"][b],
                "boxes_lidar": boxes,
                "boxes": boxes,
                "scores": pred_arrays["final_scores"][b][valid],
                "score": pred_arrays["final_scores"][b][valid],
                "pred_labels": labels,
                "names": names,
                "name": names,
                "attributes": default_attributes(boxes, names),
            })
        return annos

    def evaluation(self, det_annos, class_names, **kwargs):
        """NDS / mAP of ``det_annos`` against the infos' gt boxes, matched
        by frame id -> (result string, metrics)."""
        from .nuscenes_eval import nuscenes_eval
        gt_by_frame = {}
        for info in self.infos:
            fid = Path(info["lidar_path"]).stem
            gt_by_frame[fid] = {
                "boxes": np.asarray(info.get("gt_boxes",
                                             np.zeros((0, 9))), np.float32),
                "names": np.asarray(info.get("gt_names", [])),
            }
        gts = []
        dets = []
        for det in det_annos:
            fid = det["frame_id"]
            if fid not in gt_by_frame:
                continue
            gts.append(gt_by_frame[fid])
            dets.append(det)
        return nuscenes_eval(dets, gts, class_names)
