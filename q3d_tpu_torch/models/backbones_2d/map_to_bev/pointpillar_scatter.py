"""PointPillarScatter — pillar features onto a dense BEV canvas (port of
``q3d_tpu/models/backbones_2d/map_to_bev/pointpillar_scatter.py``).

One scatter into a (ny*nx + 1)-slot canvas whose last slot takes the
padding pillars (``coords[..., 0] < 0``) and is then dropped.  The canvas
is NCHW, (B, C, ny, nx).
"""

import torch
from torch import nn


class PointPillarScatter(nn.Module):
    def __init__(self, model_cfg, grid_size):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_bev_features = model_cfg.NUM_BEV_FEATURES
        self.nx, self.ny, nz = (int(g) for g in grid_size)
        if nz != 1:
            raise ValueError("PointPillarScatter requires a single z bin")

    def forward(self, batch_dict):
        pillar_features = batch_dict["pillar_features"]   # (B, V, C)
        coords = batch_dict["voxel_coords"]               # (B, V, 3) [z, y, x]
        b, v, c = pillar_features.shape
        hw = self.ny * self.nx
        flat = (coords[..., 1] * self.nx + coords[..., 2]).long()
        flat = torch.where(coords[..., 0] >= 0, flat, torch.full_like(flat, hw))
        canvas = pillar_features.new_zeros((b, c, hw + 1))
        canvas.scatter_(2, flat[:, None, :].expand(b, c, v),
                        pillar_features.transpose(1, 2))
        batch_dict["spatial_features"] = canvas[..., :hw].reshape(
            b, c, self.ny, self.nx)
        batch_dict["spatial_features_stride"] = 1
        return batch_dict
