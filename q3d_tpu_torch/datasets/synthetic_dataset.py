"""SyntheticDataset — procedurally generated LiDAR scenes.

Port of ``q3d_tpu/datasets/synthetic_dataset.py`` (single-frame mode): a
ground plane of radial scan rings plus random rotated boxes with
surface-sampled points.  Frame ``i`` is drawn from
``np.random.RandomState(SEED + i)``, so both packages see the same points.
``evaluation`` scores detections against the generative ground truth with
the nuScenes-protocol evaluator (``EVAL_METRIC: nuscenes``) or the quick
BEV-IoU mAP.
"""

import numpy as np

from .dataset import DatasetTemplate


def make_scene(rng, pc_range, num_objects=8, num_bg_points=12000,
               points_per_object=400, classes=("Car", "Pedestrian", "Cyclist")):
    """Returns (points (N,4) float32, gt_boxes (M,7), gt_names (M,))."""
    sizes = {
        "Car": (4.2, 1.8, 1.6),
        "Pedestrian": (0.8, 0.7, 1.7),
        "Cyclist": (1.8, 0.6, 1.7),
    }
    pts = []
    # ground: radial scan rings (spinning-lidar geometry), so adjacent ground
    # returns land in adjacent voxels as in real data
    r_max = min(abs(pc_range[3]), abs(pc_range[4])) * 1.4
    n_rings = 48
    radii = np.geomspace(2.0, r_max, n_rings)
    per_ring = max(num_bg_points // n_rings, 8)
    ring = np.repeat(radii, per_ring)
    theta = np.tile(np.linspace(-np.pi, np.pi, per_ring, endpoint=False),
                    n_rings) + rng.normal(0, 5e-4, n_rings * per_ring)
    ring = ring * (1 + rng.normal(0, 0.003, ring.shape))
    gx = ring * np.cos(theta)
    gy = ring * np.sin(theta)
    gz = rng.normal(-1.6, 0.03, ring.shape)
    gi = rng.uniform(0, 1, ring.shape)
    g = np.stack([gx, gy, gz, gi], axis=1)
    inside = ((g[:, 0] >= pc_range[0]) & (g[:, 0] <= pc_range[3])
              & (g[:, 1] >= pc_range[1]) & (g[:, 1] <= pc_range[4]))
    pts.append(g[inside])

    boxes, names = [], []
    for _ in range(num_objects):
        cls = classes[rng.randint(len(classes))]
        L, W, H = sizes[cls]
        L *= rng.uniform(0.9, 1.1)
        W *= rng.uniform(0.9, 1.1)
        H *= rng.uniform(0.9, 1.1)
        cx = rng.uniform(pc_range[0] + 5, pc_range[3] - 5)
        cy = rng.uniform(pc_range[1] + 5, pc_range[4] - 5)
        cz = -1.6 + H / 2
        yaw = rng.uniform(-np.pi, np.pi)
        # sample box surface points
        n = points_per_object
        face = rng.randint(0, 5, n)
        u = rng.uniform(-0.5, 0.5, n)
        v = rng.uniform(-0.5, 0.5, n)
        local = np.zeros((n, 3))
        local[face == 0] = np.stack([np.full((face == 0).sum(), 0.5),
                                     u[face == 0], v[face == 0]], 1)
        local[face == 1] = np.stack([np.full((face == 1).sum(), -0.5),
                                     u[face == 1], v[face == 1]], 1)
        local[face == 2] = np.stack([u[face == 2],
                                     np.full((face == 2).sum(), 0.5), v[face == 2]], 1)
        local[face == 3] = np.stack([u[face == 3],
                                     np.full((face == 3).sum(), -0.5), v[face == 3]], 1)
        local[face == 4] = np.stack([u[face == 4], v[face == 4],
                                     np.full((face == 4).sum(), 0.5)], 1)
        local *= np.array([L, W, H])
        c, s = np.cos(yaw), np.sin(yaw)
        world = local.copy()
        world[:, 0] = local[:, 0] * c - local[:, 1] * s + cx
        world[:, 1] = local[:, 0] * s + local[:, 1] * c + cy
        world[:, 2] = local[:, 2] + cz
        inten = rng.uniform(0, 1, (n, 1))
        pts.append(np.concatenate([world, inten], axis=1))
        boxes.append([cx, cy, cz, L, W, H, yaw])
        names.append(cls)

    points = np.concatenate(pts, axis=0).astype(np.float32)
    return points, np.asarray(boxes, np.float32), np.asarray(names)


class SyntheticDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=True, root_path=None,
                 logger=None):
        super().__init__(dataset_cfg=dataset_cfg, class_names=class_names,
                         training=training, root_path=root_path or ".",
                         logger=logger)
        if dataset_cfg.get("SEQUENCE", None):
            raise NotImplementedError(
                "multi-frame SEQUENCE mode is not ported to q3d_tpu_torch yet")
        self.length = int(dataset_cfg.get("NUM_FRAMES", 64))
        self.base_seed = int(dataset_cfg.get("SEED", 1234))
        self.scene_kwargs = dict(
            num_objects=int(dataset_cfg.get("NUM_OBJECTS", 8)),
            num_bg_points=int(dataset_cfg.get("NUM_BG_POINTS", 12000)),
            points_per_object=int(dataset_cfg.get("POINTS_PER_OBJECT", 400)))

    def __len__(self):
        return self.length

    def scene(self, index):
        """Frame ``index`` -> (points, gt_boxes, gt_names); under
        ``FOV_POINTS_ONLY`` (the KITTI configs) cropped to the front
        camera's FOV with only the objects it sees labelled
        (``kitti_synthetic.kitti_scene``).  The scenes' points carry x, y,
        z and intensity; a source feature past those (the Lyft configs'
        timestamp, a point's sweep time lag) is 0, as in a single sweep."""
        if self.dataset_cfg.get("FOV_POINTS_ONLY", False):
            from .kitti_synthetic import kitti_scene
            points, boxes, names = kitti_scene(self, int(index))[:3]
        else:
            rng = np.random.RandomState(self.base_seed + int(index))
            points, boxes, names = make_scene(rng, self.point_cloud_range,
                                              **self.scene_kwargs)
        extra = len(self.point_feature_encoder.src_feature_list) \
            - points.shape[1]
        if extra > 0:
            points = np.concatenate(
                [points, np.zeros((len(points), extra), points.dtype)], axis=1)
        return points, boxes, names

    def __getitem__(self, index):
        points, gt_boxes, gt_names = self.scene(index)
        input_dict = {
            "points": points,
            "gt_boxes": gt_boxes,
            "gt_names": gt_names,
            "frame_id": int(index),
        }
        return self.prepare_data(data_dict=input_dict)

    def generate_prediction_dicts(self, batch_dict, pred_arrays, class_names):
        """pred_arrays: host numpy final_boxes/scores/labels/valid -> one
        annotation dict per frame."""
        annos = []
        for b in range(pred_arrays["final_boxes"].shape[0]):
            v = pred_arrays["final_valid"][b].astype(bool)
            annos.append({
                "frame_id": batch_dict["frame_id"][b],
                "boxes_lidar": pred_arrays["final_boxes"][b][v],
                "score": pred_arrays["final_scores"][b][v],
                "pred_labels": pred_arrays["final_labels"][b][v],
                "name": np.asarray([class_names[int(i) - 1]
                                    for i in pred_arrays["final_labels"][b][v]]),
            })
        return annos

    def evaluation(self, det_annos, class_names, **kwargs):
        """Score against the generative ground truth: ``eval_metric=
        "nuscenes"`` runs the nuScenes-protocol evaluator (NDS, mAP over
        distance thresholds, TP errors); otherwise the quick BEV-IoU mAP.
        -> (result string, metrics dict)."""
        gts = []
        for anno in det_annos:
            _, gt_boxes, gt_names = self.scene(anno["frame_id"])
            gts.append({"boxes": gt_boxes, "names": gt_names})
        if kwargs.get("eval_metric") == "nuscenes":
            from .nuscenes.nuscenes_eval import nuscenes_eval
            dets = [{"boxes": np.asarray(d["boxes_lidar"]),
                     "names": np.asarray(d["name"]),
                     "scores": np.asarray(d["score"])} for d in det_annos]
            return nuscenes_eval(dets, gts, list(class_names))
        from ..utils.simple_eval import simple_map
        ap_dict = simple_map(det_annos, gts, class_names)
        result_str = "\n".join(f"{k}: {v:.4f}" for k, v in ap_dict.items())
        return result_str, ap_dict
