"""DynamicMeanVFE: the mean of every point of a voxel, from the raw points
(port of ``q3d_tpu/models/backbones_3d/vfe/dynamic_mean_vfe.py``): per
frame the ``segments`` layout of the voxel keys with the capacity
``max_voxels``, then a segment sum over all of a voxel's points (no cap on
the points of a voxel, unlike the numpy voxelizer's
``MAX_POINTS_PER_VOXEL``) over their count.  Outputs the contract of
``MeanVFE``: ``voxel_features`` (B, V, C), ``voxel_coords`` (B, V, 3) int32
[z, y, x] (-1 past the last voxel), ``voxel_num_points`` (B, V).
Coordinates stay f32, the means go on in ``compute_dtype``, as in
``DynamicPillarVFE``."""

import torch
from torch import nn

from .dynamic_voxel_vfe import voxel_layout


class DynamicMeanVFE(nn.Module):
    def __init__(self, model_cfg, num_point_features, voxel_size,
                 point_cloud_range, grid_size, max_voxels=60000):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_point_features = num_point_features
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        self.grid_size = tuple(int(g) for g in grid_size)
        self.max_voxels = int(max_voxels)

    def get_output_feature_dim(self):
        return self.num_point_features

    def forward(self, batch_dict):
        points = batch_dict["points"]                  # (B, N, C) f32
        v = self.max_voxels
        feats, coords, counts = [], [], []
        for i in range(points.shape[0]):
            lay = voxel_layout(
                points[i].float(), batch_dict["points_mask"][i],
                self.voxel_size, self.point_cloud_range, self.grid_size, v)
            n = lay.ids_count[:v].clamp_min(1)[:, None].float()
            mean = lay.sums[:v] / n
            feats.append(mean * (lay.counts > 0)[:, None])
            coords.append(lay.coords)
            counts.append(lay.counts)
        batch_dict["voxel_features"] = torch.stack(feats).to(
            batch_dict.get("compute_dtype", points.dtype))
        batch_dict["voxel_coords"] = torch.stack(coords)
        batch_dict["voxel_num_points"] = torch.stack(counts)
        return batch_dict
