"""PartA2FCHead — part-aware ROI pooling and FC refinement (port of
``q3d_tpu/models/roi_heads/parta2_head.py``).

For each frame's rois (in training the sampled ones,
``RoIHeadTemplate.pooled_rois``) the UNet's stride-1 point features are
MAX-pooled onto a GRID_SIZE^3 (or ROI_AWARE_POOL.POOL_SIZE^3) grid by
``roiaware_pool3d``, and, with a part head, the part features [part
offset, seg score] (the offset zeroed where the score is below
SEG_MASK_SCORE_THRESH) AVG-pooled onto the same grid; both are flattened
per roi ([x, y, z, channel], the point features' channels first) into the
shared, cls and reg FCs and the decode (in training the losses).  The
reference's head fuses the pooled grids with dense FCs where OpenPCDet
runs two small sparse-conv branches (its docstring says so); the port
follows the reference.

Each frame pools its own points only.  The reference pools every frame's
rows with the other frames' features zeroed, so its AVG pool divides by a
count that takes in other frames' points and padded rows that fall inside
the roi (``ROADMAP.md`` §3); OpenPCDet pools each frame's own points, and
so does the port (``point_valid``).  The cells of a frame are found once
and pooled twice (``roiaware_cells``).
"""

import torch

from ...ops.roiaware_pool3d import pool_cells, roiaware_cells
from ...utils import common_utils
from .roi_head_template import RoIHeadTemplate


def pool_grid_size(model_cfg):
    """The pooling grid's side: ROI_GRID_POOL.GRID_SIZE, else
    ROI_AWARE_POOL.POOL_SIZE (the published configs' key), else 12."""
    pool = model_cfg.get("ROI_GRID_POOL", None) or model_cfg.ROI_AWARE_POOL
    return int(pool.get("GRID_SIZE", pool.get("POOL_SIZE", 12)))


class PartA2FCHead(RoIHeadTemplate):
    def __init__(self, model_cfg, input_channels, voxel_size,
                 point_cloud_range, part_channels=0):
        grid = pool_grid_size(model_cfg)
        super().__init__(model_cfg, grid ** 3
                         * (input_channels + part_channels))
        self.grid = grid
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)

    def forward(self, batch_dict):
        rois = self.pooled_rois(batch_dict)
        b, r = rois.shape[:2]
        feats = batch_dict["point_features"]
        coords = batch_dict["point_coords"]
        xyz = common_utils.get_voxel_centers(
            coords[:, 1:], 1, self.voxel_size, self.point_cloud_range)
        part = None
        if "point_part_offset" in batch_dict:
            score = batch_dict["point_cls_scores"][:, None]
            offset = batch_dict["point_part_offset"]
            thresh = float(self.model_cfg.get("SEG_MASK_SCORE_THRESH", 0.3))
            offset = torch.where(score < thresh, torch.zeros_like(offset),
                                 offset)
            part = torch.cat([offset, score], dim=-1).to(feats.dtype)
        pooled = []
        for f in range(b):
            cells = roiaware_cells(rois[f], xyz, self.grid, coords[:, 0] == f)
            grid = pool_cells(cells, r, feats, "max")
            if part is not None:
                grid = torch.cat([grid, pool_cells(cells, r, part, "avg")],
                                 dim=-1)
            pooled.append(grid)
        return self.finish(batch_dict, rois,
                           torch.stack(pooled).reshape(b * r, -1))
