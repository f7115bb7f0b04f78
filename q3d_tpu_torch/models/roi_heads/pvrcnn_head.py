"""PVRCNNHead — keypoint-pooled ROI refinement (port of
``q3d_tpu/models/roi_heads/pvrcnn_head.py``): GRID_SIZE^3 grid points
in each ROI (``roi_grid_points`` :22; in training the sampled ROIs,
``RoIHeadTemplate.pooled_rois``), a ball query of the grid points over
the keypoints, whose fused features are weighted by the
point head's scores, one ``SAMLPBlock`` per radius (``pool_r0_8`` ...),
then the shared, cls and reg FCs and the decode (in training the
losses).  The vector-pool grid
pooling (PV-RCNN++) raises."""

import torch

from ...utils import common_utils
from ..backbones_3d.pfe.voxel_set_abstraction import (SAMLPBlock,
                                                      radius_name,
                                                      set_abstraction)
from .roi_head_template import RoIHeadTemplate


def roi_grid_points(rois, grid_size):
    """(B, R, 7) -> (B, R * g^3, 3) world-frame grid points, x fastest."""
    b, r = rois.shape[:2]
    g = grid_size
    lin = (torch.arange(g, dtype=torch.float32, device=rois.device) + 0.5) \
        / g - 0.5
    gz, gy, gx = torch.meshgrid(lin, lin, lin, indexing="ij")
    local = torch.stack([gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)], -1)
    local = local[None, None] * rois[:, :, None, 3:6]          # (B,R,g3,3)
    shape = local.shape
    rot = common_utils.rotate_points_along_z(
        local.reshape(b * r, -1, 3), rois[..., 6].reshape(-1))
    return (rot.reshape(shape) + rois[:, :, None, 0:3]).reshape(b, -1, 3)


class PVRCNNHead(RoIHeadTemplate):
    def __init__(self, model_cfg, input_channels):
        sa = model_cfg.ROI_GRID_POOL
        if sa.get("NAME", "") == "VectorPoolAggregationModuleMSG":
            raise NotImplementedError(
                "PVRCNNHead: the vector-pool grid pooling (PV-RCNN++) is not "
                "ported")
        g3 = int(sa.GRID_SIZE) ** 3
        pooled = g3 * sum(m[-1] for m in sa.MLPS)
        super().__init__(model_cfg, pooled)
        self.grid_size = int(sa.GRID_SIZE)
        self.pool_names = []
        for radius, mlps in zip(sa.POOL_RADIUS, sa.MLPS):
            name = f"pool_r{radius_name(radius)}"
            self.add_module(name, SAMLPBlock(3 + input_channels, mlps))
            self.pool_names.append(name)

    def forward(self, batch_dict):
        rois = self.pooled_rois(batch_dict)
        b, r = rois.shape[:2]
        kp = batch_dict["keypoints"]                           # (B, K, 3)
        kp_feats = batch_dict["point_features"].reshape(b, kp.shape[1], -1)
        if "point_cls_scores" in batch_dict:
            kp_feats = kp_feats * batch_dict["point_cls_scores"].reshape(
                b, kp.shape[1], 1)
        grid = roi_grid_points(rois, self.grid_size)           # (B, R*g3, 3)
        pooled = set_abstraction(
            [getattr(self, n) for n in self.pool_names],
            self.model_cfg.ROI_GRID_POOL, kp, kp_feats, grid, None)
        return self.finish(batch_dict, rois, pooled.reshape(b * r, -1))
