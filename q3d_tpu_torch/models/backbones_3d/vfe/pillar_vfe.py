"""PillarVFE — the PointPillars feature net (port of
``q3d_tpu/models/backbones_3d/vfe/pillar_vfe.py``).

Per pillar point: [x, y, z, intensity (or intensity alone without
``USE_ABSLOTE_XYZ``), offset to the pillar's point mean, offset to the
pillar's center (, distance)] -> PFN layers (Linear -> BN -> ReLU -> max
over the points).  The reference's masking exactly: padded point slots are
zeroed BEFORE the first linear layer and still take part in BN and in the
max afterwards.  The linear layers are plain matmuls (``layers.Linear``),
as the reference leaves them to XLA.
"""

import torch
from torch import nn

from ...layers import BatchNorm1d, Linear


class PFNLayer(nn.Module):
    def __init__(self, in_channels, out_channels, use_norm=True,
                 last_layer=False):
        super().__init__()
        self.last_layer = last_layer
        out_ch = out_channels if last_layer else out_channels // 2
        self.linear = Linear(in_channels, out_ch, bias=not use_norm)
        self.norm = BatchNorm1d(out_ch, eps=1e-3) if use_norm else None

    def forward(self, x):                               # (N, P, C)
        x = self.linear(x)
        if self.norm is not None:
            x = self.norm(x)
        x = torch.relu(x)
        x_max = x.amax(dim=1, keepdim=True)
        if self.last_layer:
            return x_max
        return torch.cat([x, x_max.expand_as(x)], dim=2)


class PillarVFE(nn.Module):
    def __init__(self, model_cfg, num_point_features, voxel_size,
                 point_cloud_range):
        super().__init__()
        self.model_cfg = model_cfg
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        c = num_point_features + (6 if model_cfg.USE_ABSLOTE_XYZ else 3) \
            + (1 if model_cfg.WITH_DISTANCE else 0)
        filters = [c, *model_cfg.NUM_FILTERS]
        self.pfn_layers = nn.ModuleList(
            PFNLayer(filters[i], filters[i + 1], model_cfg.USE_NORM,
                     last_layer=i == len(filters) - 2)
            for i in range(len(filters) - 1))

    def get_output_feature_dim(self):
        return list(self.model_cfg.NUM_FILTERS)[-1]

    def forward(self, batch_dict):
        voxels = batch_dict["voxels"]                   # (B, V, P, C)
        num_points = batch_dict["voxel_num_points"]     # (B, V)
        coords = batch_dict["voxel_coords"]             # (B, V, 3) [z, y, x]
        b, v, p, c = voxels.shape
        vf = voxels.reshape(b * v, p, c)
        npts = num_points.reshape(b * v).to(vf.dtype)
        czyx = coords.reshape(b * v, 3).to(vf.dtype)

        points_mean = vf[:, :, :3].sum(dim=1, keepdim=True) \
            / npts.clamp(min=1.0)[:, None, None]
        f_cluster = vf[:, :, :3] - points_mean

        vx, vy, vz = self.voxel_size
        x_off = vx / 2 + self.point_cloud_range[0]
        y_off = vy / 2 + self.point_cloud_range[1]
        z_off = vz / 2 + self.point_cloud_range[2]
        f_center = torch.stack([
            vf[:, :, 0] - (czyx[:, 2][:, None] * vx + x_off),
            vf[:, :, 1] - (czyx[:, 1][:, None] * vy + y_off),
            vf[:, :, 2] - (czyx[:, 0][:, None] * vz + z_off)], dim=-1)

        feats = [vf if self.model_cfg.USE_ABSLOTE_XYZ else vf[..., 3:],
                 f_cluster, f_center]
        if self.model_cfg.WITH_DISTANCE:
            feats.append(torch.linalg.norm(vf[:, :, :3], dim=2, keepdim=True))
        features = torch.cat(feats, dim=-1)

        mask = torch.arange(p, device=vf.device)[None, :] < npts[:, None]
        features = features * mask[..., None].to(features.dtype)
        for pfn in self.pfn_layers:
            features = pfn(features)
        batch_dict["pillar_features"] = features.reshape(b, v, -1)
        return batch_dict
