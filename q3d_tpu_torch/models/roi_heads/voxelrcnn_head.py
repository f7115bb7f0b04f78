"""VoxelRCNNHead — multi-scale voxel ROI grid pooling (port of
``q3d_tpu/models/roi_heads/voxelrcnn_head.py``): the ROI grid points of
``pvrcnn_head.roi_grid_points`` (in training around the sampled ROIs,
``RoIHeadTemplate.pooled_rois``); for each POOL_LAYERS source,
its rows regrouped per frame (``_regroup``) and a ball query of the grid
points over their voxel centres, one ``SAMLPBlock`` per radius
(``pool_x_conv2_r0_4`` ...); then the shared, cls and reg FCs and the
decode (in training the losses).  The reference's ball query over voxel centres stands in for
OpenPCDet's voxel query, so QUERY_RANGES and PRE_MLP are not read
(``ROADMAP.md`` §3)."""

import torch

from ..backbones_3d.pfe.voxel_set_abstraction import (SAMLPBlock,
                                                      radius_name,
                                                      set_abstraction,
                                                      stage_points)
from .pvrcnn_head import roi_grid_points
from .roi_head_template import RoIHeadTemplate


class VoxelRCNNHead(RoIHeadTemplate):
    def __init__(self, model_cfg, backbone_channels, voxel_size,
                 point_cloud_range):
        pool = model_cfg.ROI_GRID_POOL
        g3 = int(pool.GRID_SIZE) ** 3
        pooled = g3 * sum(m[-1] for layer in pool.POOL_LAYERS.values()
                          for m in layer["MLPS"])
        super().__init__(model_cfg, pooled)
        self.grid_size = int(pool.GRID_SIZE)
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.pool_names = {}
        for src, layer in pool.POOL_LAYERS.items():
            self.pool_names[src] = []
            for radius, mlps in zip(layer["POOL_RADIUS"], layer["MLPS"]):
                name = f"pool_{src}_r{radius_name(float(radius))}"
                self.add_module(name, SAMLPBlock(
                    3 + backbone_channels[src], mlps))
                self.pool_names[src].append(name)

    def forward(self, batch_dict):
        rois = self.pooled_rois(batch_dict)
        b, r = rois.shape[:2]
        grid = roi_grid_points(rois, self.grid_size)           # (B, R*g3, 3)
        ms = batch_dict["multi_scale_3d_features"]
        strides = batch_dict["multi_scale_3d_strides"]
        pooled = []
        for src, names in self.pool_names.items():
            xyz, fts, mask = stage_points(ms[src], strides[src],
                                          self.voxel_size,
                                          self.point_cloud_range, b)
            pooled.append(set_abstraction(
                [getattr(self, n) for n in names],
                self.model_cfg.ROI_GRID_POOL.POOL_LAYERS[src], xyz, fts,
                grid, mask))
        return self.finish(batch_dict, rois,
                           torch.cat(pooled, dim=-1).reshape(b * r, -1))
