"""KITTI dataset: info-pickle driven loading, camera-frame prediction
export, the official AP evaluation, and the offline info and gt-database
creation.

Port of ``q3d_tpu/datasets/kitti/kitti_dataset.py``: the velodyne / calib /
label readers, ``__getitem__`` (lidar-frame gt boxes from the camera-frame
labels, ``DontCare`` dropped), ``generate_prediction_dicts`` (lidar boxes ->
KITTI camera annos with their image boxes, and the result files),
``evaluation`` (``kitti_eval.get_official_eval_result``), ``get_infos``,
``create_groundtruth_database`` and ``create_kitti_infos``.

Two differences from the reference:
  * ``__getitem__`` applies ``FOV_POINTS_ONLY``, keeping the points that
    project into the camera image in front of it (OpenPCDet's
    ``get_fov_flag``); the reference never reads the key and feeds the
    whole 360-degree scan;
  * ``get_image_shape`` reads a PNG's width and height from its IHDR chunk
    instead of through PIL.
"""

import pickle
import struct
from pathlib import Path

import numpy as np

from ...utils import box_utils, calibration_kitti, common_utils, object3d_kitti
from ...utils.box_utils import points_in_boxes_cpu
from ..dataset import DatasetTemplate

# the image shape (H, W) the reference assumes for a frame with no image
DEFAULT_IMAGE_SHAPE = (375, 1242)


def png_size(path):
    """(width, height) of a PNG file, from its IHDR chunk."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        raise ValueError(f"{path} is not a PNG file")
    return struct.unpack(">II", head[16:24])


def get_fov_flag(pts_rect, img_shape, calib):
    """Rect points (N, 3) that project into the image of shape (H, W) with
    a depth >= 0 -> bool (N,) (OpenPCDet's ``KittiDataset.get_fov_flag``)."""
    pts_img, pts_rect_depth = calib.rect_to_img(pts_rect)
    val_flag_1 = np.logical_and(pts_img[:, 0] >= 0,
                                pts_img[:, 0] < img_shape[1])
    val_flag_2 = np.logical_and(pts_img[:, 1] >= 0,
                                pts_img[:, 1] < img_shape[0])
    return np.logical_and(np.logical_and(val_flag_1, val_flag_2),
                          pts_rect_depth >= 0)


class KittiDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=True, root_path=None,
                 logger=None):
        super().__init__(dataset_cfg=dataset_cfg, class_names=class_names,
                         training=training, root_path=root_path, logger=logger)
        self.split = self.dataset_cfg.DATA_SPLIT[self.mode]
        self.root_split_path = self.root_path / (
            "training" if self.split != "test" else "testing")
        split_file = self.root_path / "ImageSets" / f"{self.split}.txt"
        self.sample_id_list = [x.strip() for x in open(split_file).readlines()] \
            if split_file.exists() else []
        self.kitti_infos = []
        self.include_kitti_data(self.mode)

    def include_kitti_data(self, mode):
        infos = []
        for info_path in self.dataset_cfg.INFO_PATH[mode]:
            p = self.root_path / info_path
            if not p.exists():
                if self.logger:
                    self.logger.warning(f"info file {p} missing")
                continue
            with open(p, "rb") as f:
                infos.extend(pickle.load(f))
        self.kitti_infos = infos
        if self.logger:
            self.logger.info(f"KITTI samples: {len(infos)}")

    # --------------------------- raw readers ------------------------------

    def get_lidar(self, idx):
        f = self.root_split_path / "velodyne" / f"{idx}.bin"
        return np.fromfile(str(f), np.float32).reshape(-1, 4)

    def get_calib(self, idx):
        return calibration_kitti.Calibration(
            str(self.root_split_path / "calib" / f"{idx}.txt"))

    def get_label(self, idx):
        return object3d_kitti.get_objects_from_label(
            str(self.root_split_path / "label_2" / f"{idx}.txt"))

    def get_image_shape(self, idx):
        f = self.root_split_path / "image_2" / f"{idx}.png"
        if f.exists():
            w, h = png_size(f)
            return np.array([h, w], np.int32)
        return np.array(DEFAULT_IMAGE_SHAPE, np.int32)

    # ------------------------------ access --------------------------------

    def __len__(self):
        return len(self.kitti_infos)

    def __getitem__(self, index):
        info = self.kitti_infos[index]
        sample_idx = info["point_cloud"]["lidar_idx"]
        calib = self.get_calib(sample_idx)
        points = self.get_lidar(sample_idx)
        img_shape = info["image"]["image_shape"]
        if self.dataset_cfg.get("FOV_POINTS_ONLY", False):
            pts_rect = calib.lidar_to_rect(points[:, 0:3])
            points = points[get_fov_flag(pts_rect, img_shape, calib)]

        input_dict = {"frame_id": sample_idx, "calib": calib,
                      "image_shape": img_shape}
        if "annos" in info:
            annos = common_utils.drop_info_with_name(info["annos"], "DontCare")
            gt_names = annos["name"]
            gt_boxes_camera = np.concatenate(
                [annos["location"], annos["dimensions"],
                 annos["rotation_y"][..., None]], axis=1).astype(np.float32)
            gt_boxes_lidar = box_utils.boxes3d_kitti_camera_to_lidar(
                gt_boxes_camera, calib)
            input_dict.update({"gt_names": gt_names,
                               "gt_boxes": gt_boxes_lidar})
            if "road_plane" in info:
                input_dict["road_plane"] = info["road_plane"]
        input_dict["points"] = points
        data_dict = self.prepare_data(data_dict=input_dict)
        data_dict["image_shape"] = img_shape
        return data_dict

    # --------------------------- predictions ------------------------------

    def generate_prediction_dicts(self, batch_dict, pred_arrays, class_names,
                                  output_path=None):
        """The host arrays of a batch's forward -> one KITTI anno a frame
        (lidar boxes, and their camera boxes, image boxes and alpha); with
        ``output_path``, each frame's result file under
        ``<output_path>/final_result/data``."""
        annos = []
        for b in range(pred_arrays["final_boxes"].shape[0]):
            valid = pred_arrays["final_valid"][b].astype(bool)
            boxes_lidar = pred_arrays["final_boxes"][b][valid][:, :7]
            scores = pred_arrays["final_scores"][b][valid]
            labels = pred_arrays["final_labels"][b][valid].astype(int)
            calib = batch_dict["calib"][b]
            image_shape = np.asarray(batch_dict["image_shape"][b])

            n = len(boxes_lidar)
            anno = {
                "name": np.asarray([class_names[i - 1] for i in labels]),
                "truncated": np.zeros(n), "occluded": np.zeros(n),
                "score": scores, "boxes_lidar": boxes_lidar,
                "frame_id": batch_dict["frame_id"][b],
            }
            if n:
                cam = box_utils.boxes3d_lidar_to_kitti_camera(boxes_lidar,
                                                              calib)
                img_boxes = box_utils.boxes3d_kitti_camera_to_imageboxes(
                    cam, calib, image_shape)
                anno.update({
                    "alpha": -np.arctan2(-boxes_lidar[:, 1], boxes_lidar[:, 0])
                    + cam[:, 6],
                    "bbox": img_boxes,
                    "dimensions": cam[:, 3:6],
                    "location": cam[:, 0:3],
                    "rotation_y": cam[:, 6],
                })
            else:
                anno.update({"alpha": np.zeros(0), "bbox": np.zeros((0, 4)),
                             "dimensions": np.zeros((0, 3)),
                             "location": np.zeros((0, 3)),
                             "rotation_y": np.zeros(0)})
            annos.append(anno)
            if output_path is not None:
                self._save_kitti_format(anno, output_path)
        return annos

    @staticmethod
    def _save_kitti_format(anno, output_path):
        """One frame's detections as a KITTI result file (the label layout
        with a score, 4 decimals)."""
        out = Path(output_path) / "final_result" / "data"
        out.mkdir(parents=True, exist_ok=True)
        with open(out / f"{anno['frame_id']}.txt", "w") as f:
            for k in range(len(anno["name"])):
                bbox, dim, loc = anno["bbox"][k], anno["dimensions"][k], \
                    anno["location"][k]
                f.write(f"{anno['name'][k]} 0.0 0 {anno['alpha'][k]:.4f} "
                        f"{bbox[0]:.4f} {bbox[1]:.4f} {bbox[2]:.4f} {bbox[3]:.4f} "
                        f"{dim[1]:.4f} {dim[2]:.4f} {dim[0]:.4f} "
                        f"{loc[0]:.4f} {loc[1]:.4f} {loc[2]:.4f} "
                        f"{anno['rotation_y'][k]:.4f} {anno['score'][k]:.4f}\n")

    def evaluation(self, det_annos, class_names, device=None, **kwargs):
        """The official AP_R40 of ``det_annos`` against the infos' annos
        (rotated overlaps on ``device``) -> (result string, metrics)."""
        from .kitti_eval import get_official_eval_result
        gt_annos = [info["annos"] for info in self.kitti_infos
                    if "annos" in info]
        return get_official_eval_result(gt_annos, det_annos, class_names,
                                        device=device)

    # --------------------------- info creation ----------------------------

    def get_infos(self, has_label=True, count_inside_pts=True,
                  sample_id_list=None):
        """Each sample's info dict: point cloud, image shape, calibration
        and, with labels, the annos (camera frame, difficulty, the lidar
        boxes and the points inside each)."""
        infos = []
        for sample_idx in (sample_id_list or self.sample_id_list):
            info = {"point_cloud": {"num_features": 4, "lidar_idx": sample_idx},
                    "image": {"image_idx": sample_idx,
                              "image_shape": self.get_image_shape(sample_idx)}}
            calib = self.get_calib(sample_idx)
            info["calib"] = {"P2": calib.P2, "R0_rect": calib.R0,
                             "Tr_velo_to_cam": calib.V2C}
            if has_label:
                obj_list = self.get_label(sample_idx)
                annos = {
                    "name": np.asarray([o.cls_type for o in obj_list]),
                    "truncated": np.asarray([o.truncation for o in obj_list]),
                    "occluded": np.asarray([o.occlusion for o in obj_list]),
                    "alpha": np.asarray([o.alpha for o in obj_list]),
                    "bbox": np.stack([o.box2d for o in obj_list])
                    if obj_list else np.zeros((0, 4)),
                    "dimensions": np.asarray([[o.l, o.h, o.w]
                                              for o in obj_list]).reshape(-1, 3),
                    "location": np.stack([o.loc for o in obj_list])
                    if obj_list else np.zeros((0, 3)),
                    "rotation_y": np.asarray([o.ry for o in obj_list]),
                    "difficulty": np.asarray([o.level for o in obj_list]),
                }
                num_obj = sum(1 for o in obj_list if o.cls_type != "DontCare")
                annos["index"] = np.concatenate(
                    [np.arange(num_obj), -np.ones(len(obj_list) - num_obj)]) \
                    .astype(np.int32)
                if obj_list:
                    loc_lidar = calib.rect_to_lidar(annos["location"])
                    gt_boxes_lidar = np.concatenate(
                        [loc_lidar, annos["dimensions"][:, [0, 2, 1]],
                         -(annos["rotation_y"] + np.pi / 2)[:, None]], axis=1)
                    gt_boxes_lidar[:, 2] += gt_boxes_lidar[:, 5] / 2
                else:
                    gt_boxes_lidar = np.zeros((0, 7))
                annos["gt_boxes_lidar"] = gt_boxes_lidar.astype(np.float32)
                if count_inside_pts and obj_list:
                    points = self.get_lidar(sample_idx)
                    flags = points_in_boxes_cpu(points[:, :3], gt_boxes_lidar)
                    annos["num_points_in_gt"] = flags.sum(axis=1)
                info["annos"] = annos
            infos.append(info)
        return infos

    def create_groundtruth_database(self, info_path, used_classes=None,
                                    split="train"):
        """Each labelled object's points (relative to its box centre) as
        ``gt_database_<split>/<id>_<name>_<i>.bin`` and their infos, by
        class, as ``kitti_dbinfos_<split>.pkl`` -> that file's path."""
        db_dir = self.root_path / f"gt_database_{split}"
        db_dir.mkdir(parents=True, exist_ok=True)
        with open(info_path, "rb") as f:
            infos = pickle.load(f)
        db_infos = {}
        for info in infos:
            idx = info["point_cloud"]["lidar_idx"]
            points = self.get_lidar(idx)
            annos = info["annos"]
            boxes = annos["gt_boxes_lidar"]
            names = annos["name"]
            if not len(boxes):
                continue
            flags = points_in_boxes_cpu(points[:, :3], boxes)
            for i, name in enumerate(names):
                if used_classes and name not in used_classes:
                    continue
                obj_points = points[flags[i] > 0].copy()
                obj_points[:, :3] -= boxes[i, :3]
                path = db_dir / f"{idx}_{name}_{i}.bin"
                obj_points.astype(np.float32).tofile(path)
                db_infos.setdefault(name, []).append({
                    "name": name, "path": str(path.relative_to(self.root_path)),
                    "box3d_lidar": boxes[i],
                    "num_points_in_gt": int((flags[i] > 0).sum()),
                    "difficulty": int(annos["difficulty"][i]),
                    "num_features": 4,
                })
        out = self.root_path / f"kitti_dbinfos_{split}.pkl"
        with open(out, "wb") as f:
            pickle.dump(db_infos, f)
        return out


def create_kitti_infos(dataset_cfg, class_names, data_path, save_path):
    """``kitti_infos_{train,val,test}.pkl`` under ``save_path`` for each
    split that has an ``ImageSets/<split>.txt`` -> {split: infos written}."""
    dataset = KittiDataset(dataset_cfg=dataset_cfg, class_names=class_names,
                           root_path=data_path, training=False)
    written = {}
    for split, has_label in [("train", True), ("val", True), ("test", False)]:
        split_file = Path(data_path) / "ImageSets" / f"{split}.txt"
        if not split_file.exists():
            continue
        ids = [x.strip() for x in open(split_file).readlines()]
        dataset.root_split_path = Path(data_path) / (
            "training" if split != "test" else "testing")
        infos = dataset.get_infos(has_label=has_label, sample_id_list=ids)
        out = Path(save_path) / f"kitti_infos_{split}.pkl"
        with open(out, "wb") as f:
            pickle.dump(infos, f)
        written[split] = len(infos)
    return written
