"""Config-queued point-cloud processing ending in capacity-padded voxels.

Port of the steps of ``q3d_tpu/datasets/processor/data_processor.py`` that
the synthetic CenterPoint configs queue: range masking, point shuffling and
voxelization, or only the grid's size for the dynamic VFEs
(``calculate_grid_size``).  The shuffle draws from ``rng`` (a
``np.random.RandomState``; by default numpy's global one, which the
reference draws from).  Outputs stay numpy, padded to capacity, until
``models.load_data_to_device`` moves them.
"""

from functools import partial

import numpy as np

from ...ops.voxelizer import voxelize_np
from ...utils import common_utils, box_utils


class DataProcessor:
    def __init__(self, processor_configs, point_cloud_range, training,
                 num_point_features, rng=None):
        self.rng = rng if rng is not None else np.random.mtrand._rand
        self.point_cloud_range = np.asarray(point_cloud_range, np.float32)
        self.training = training
        self.num_point_features = num_point_features
        self.mode = "train" if training else "test"
        self.grid_size = self.voxel_size = None
        self.max_voxels = None
        self.data_processor_queue = []
        for cur_cfg in processor_configs:
            cur_processor = getattr(self, cur_cfg.NAME)(config=cur_cfg)
            self.data_processor_queue.append(cur_processor)

    # each method doubles as factory (config=...) and step (data_dict=...)

    def mask_points_and_boxes_outside_range(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.mask_points_and_boxes_outside_range, config=config)
        if data_dict.get("points", None) is not None:
            mask = common_utils.mask_points_by_range(data_dict["points"],
                                                     self.point_cloud_range)
            data_dict["points"] = data_dict["points"][mask]
        if data_dict.get("gt_boxes", None) is not None and config.REMOVE_OUTSIDE_BOXES \
                and self.training and len(data_dict["gt_boxes"]) > 0:
            mask = box_utils.mask_boxes_outside_range_numpy(
                data_dict["gt_boxes"], self.point_cloud_range,
                min_num_corners=config.get("MIN_NUM_CORNERS", 1),
                use_center_to_filter=config.get("USE_CENTER_TO_FILTER", True))
            data_dict["gt_boxes"] = data_dict["gt_boxes"][mask]
            if "gt_names" in data_dict:
                data_dict["gt_names"] = data_dict["gt_names"][mask]
        return data_dict

    def shuffle_points(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.shuffle_points, config=config)
        if config.SHUFFLE_ENABLED[self.mode]:
            pts = data_dict["points"]
            data_dict["points"] = pts[self.rng.permutation(pts.shape[0])]
        return data_dict

    def transform_points_to_voxels(self, data_dict=None, config=None):
        if data_dict is None:
            self.voxel_size = np.asarray(config.VOXEL_SIZE, np.float32)
            grid_size = (self.point_cloud_range[3:6] - self.point_cloud_range[0:3]) \
                / self.voxel_size
            self.grid_size = np.round(grid_size).astype(np.int64)  # [nx, ny, nz]
            self.max_points_per_voxel = config.MAX_POINTS_PER_VOXEL
            self.max_voxels = config.MAX_NUMBER_OF_VOXELS[self.mode]
            return partial(self.transform_points_to_voxels, config=config)
        voxels, coords, num_points, num_voxels = voxelize_np(
            data_dict["points"], self.voxel_size, self.point_cloud_range,
            self.max_points_per_voxel, self.max_voxels)
        if not data_dict.get("use_lead_xyz", True):
            voxels = voxels[..., 3:]
        data_dict["voxels"] = voxels
        data_dict["voxel_coords"] = coords
        data_dict["voxel_num_points"] = num_points
        data_dict["num_voxels"] = num_voxels
        return data_dict

    def calculate_grid_size(self, data_dict=None, config=None):
        """The grid of ``VOXEL_SIZE`` over the range, for models that bin
        the raw points themselves (the dynamic VFEs); the points pass
        through."""
        if data_dict is None:
            self.voxel_size = np.asarray(config.VOXEL_SIZE, np.float32)
            grid_size = (self.point_cloud_range[3:6] - self.point_cloud_range[0:3]) \
                / self.voxel_size
            self.grid_size = np.round(grid_size).astype(np.int64)
            return partial(self.calculate_grid_size, config=config)
        return data_dict

    def forward(self, data_dict):
        for step in self.data_processor_queue:
            data_dict = step(data_dict=data_dict)
        return data_dict
