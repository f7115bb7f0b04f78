"""DatasetTemplate: per-frame pipeline + static-shape batch collation.

Port of ``q3d_tpu/datasets/dataset.py``: in training the data augmentor
(``DATA_AUGMENTOR``, built when training) with the class filter as its
``gt_boxes_mask``, then class filtering -> PointFeatureEncoder ->
DataProcessor (in training mode it drops the boxes outside the range and
shuffles the points, and a frame left without boxes is replaced by a
random one, reference :212-214), and a collate that stacks the
capacity-padded per-frame arrays into fixed shapes —
    voxels            (B, V, P, C) float32
    voxel_coords      (B, V, 3)    int32   [z, y, x], padding rows -1
    voxel_num_points  (B, V)       int32
    gt_boxes          (B, M, 8)    float32 (7 box + 1 class id), zero-padded
                                   to MAX_GT_BOXES
and, for a config that sets ``MAX_RAW_POINTS`` (the dynamic VFEs read the
raw points), the points of each frame padded to it (reference :133-143):
    points            (B, N, C)    float32, zero rows past a frame's points
    points_mask       (B, N)       bool
A frame with more points than the cap keeps its first ``MAX_RAW_POINTS``.
Without the key the raw points are not collated: no other model reads them.
"""

from collections import defaultdict
from pathlib import Path

import numpy as np

from ..utils import common_utils
from .augmentor.data_augmentor import DataAugmentor
from .processor.point_feature_encoder import PointFeatureEncoder
from .processor.data_processor import DataProcessor


class DatasetTemplate:
    def __init__(self, dataset_cfg=None, class_names=None, training=True,
                 root_path=None, logger=None):
        self.dataset_cfg = dataset_cfg
        self.training = training
        self.class_names = class_names
        self.logger = logger
        if dataset_cfg is None or class_names is None:
            return
        self.root_path = Path(root_path if root_path is not None
                              else dataset_cfg.DATA_PATH)
        self.point_cloud_range = np.asarray(dataset_cfg.POINT_CLOUD_RANGE, np.float32)
        self.point_feature_encoder = PointFeatureEncoder(
            dataset_cfg.POINT_FEATURE_ENCODING,
            point_cloud_range=self.point_cloud_range)
        self.data_augmentor = None
        if training and dataset_cfg.get("DATA_AUGMENTOR", None) is not None:
            self.data_augmentor = DataAugmentor(
                self.root_path, dataset_cfg.DATA_AUGMENTOR, self.class_names,
                logger=logger)
        self.data_processor = DataProcessor(
            dataset_cfg.DATA_PROCESSOR, point_cloud_range=self.point_cloud_range,
            training=self.training,
            num_point_features=self.point_feature_encoder.num_point_features)
        self.grid_size = self.data_processor.grid_size
        self.voxel_size = self.data_processor.voxel_size
        self.max_gt_boxes = int(dataset_cfg.get("MAX_GT_BOXES", 128))
        self.max_raw_points = int(dataset_cfg.get("MAX_RAW_POINTS", 0))

    @property
    def mode(self):
        return "train" if self.training else "test"

    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, index):
        raise NotImplementedError

    def prepare_data(self, data_dict):
        """Shared per-frame pipeline (reference dataset.py:158)."""
        if self.training:
            if "gt_boxes" not in data_dict:
                raise ValueError("training needs gt_boxes")
            if self.data_augmentor is not None:
                gt_boxes_mask = np.array(
                    [n in self.class_names for n in data_dict["gt_names"]],
                    bool)
                data_dict = self.data_augmentor.forward(
                    data_dict={**data_dict, "gt_boxes_mask": gt_boxes_mask})
        if data_dict.get("gt_boxes", None) is not None:
            selected = common_utils.keep_arrays_by_name(
                data_dict["gt_names"], self.class_names)
            data_dict["gt_boxes"] = data_dict["gt_boxes"][selected]
            data_dict["gt_names"] = data_dict["gt_names"][selected]
            gt_classes = np.array(
                [self.class_names.index(n) + 1 for n in data_dict["gt_names"]],
                np.int32)
            data_dict["gt_boxes"] = np.concatenate(
                [data_dict["gt_boxes"].astype(np.float32),
                 gt_classes.reshape(-1, 1).astype(np.float32)], axis=1)

        if data_dict.get("points", None) is not None:
            data_dict = self.point_feature_encoder.forward(data_dict)
        data_dict = self.data_processor.forward(data_dict)
        if self.training and len(data_dict.get("gt_boxes", [])) == 0:
            return self.__getitem__(np.random.randint(self.__len__()))
        data_dict.pop("gt_names", None)
        return data_dict

    def collate_batch(self, batch_list):
        ret = {}
        data = defaultdict(list)
        for cur in batch_list:
            for k, v in cur.items():
                data[k].append(v)
        batch_size = len(batch_list)

        for key, vals in data.items():
            if key in ("voxels", "voxel_coords", "voxel_num_points"):
                ret[key] = np.stack(vals, axis=0)
            elif key == "gt_boxes":
                m = self.max_gt_boxes if self.max_gt_boxes else \
                    max(max(len(v) for v in vals), 1)
                width = vals[0].shape[-1] if len(vals[0]) else 8
                out = np.zeros((batch_size, m, width), np.float32)
                for i, v in enumerate(vals):
                    k = min(len(v), m)
                    if k:
                        out[i, :k] = v[:k]
                ret[key] = out
            elif key == "points":
                if not self.max_raw_points:
                    continue
                cap, width = self.max_raw_points, vals[0].shape[-1]
                out = np.zeros((batch_size, cap, width), np.float32)
                mask = np.zeros((batch_size, cap), bool)
                for i, v in enumerate(vals):
                    k = min(len(v), cap)
                    out[i, :k] = v[:k]
                    mask[i, :k] = True
                ret["points"], ret["points_mask"] = out, mask
            else:
                ret[key] = np.array(vals)
        ret["batch_size"] = batch_size
        return ret
