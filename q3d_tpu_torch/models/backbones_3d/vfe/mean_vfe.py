"""MeanVFE — mean of points per voxel (port of
``q3d_tpu/models/backbones_3d/vfe/mean_vfe.py``)."""

import torch
from torch import nn


class MeanVFE(nn.Module):
    def __init__(self, model_cfg, num_point_features):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_point_features = num_point_features

    def get_output_feature_dim(self):
        return self.num_point_features

    def forward(self, batch_dict):
        voxels = batch_dict["voxels"]                    # (B, V, P, C)
        num_points = batch_dict["voxel_num_points"]      # (B, V)
        p = voxels.shape[2]
        mask = torch.arange(p, device=voxels.device)[None, None, :] \
            < num_points[..., None]
        summed = (voxels * mask[..., None]).sum(dim=2)
        denom = num_points[..., None].to(voxels.dtype).clamp(min=1.0)
        batch_dict["voxel_features"] = summed / denom    # (B, V, C)
        return batch_dict
