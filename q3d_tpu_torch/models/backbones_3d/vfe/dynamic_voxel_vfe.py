"""DynamicVoxelVFE: learned point features pooled into 3D voxels (port of
``q3d_tpu/models/backbones_3d/vfe/dynamic_voxel_vfe.py``).

Per point: [x, y, z, intensity (or intensity alone), the offset to its
voxel's point mean, the x / y / z offset to its voxel's centre (, its
distance)] -> ``PFNLayerV2`` layers (Linear -> ``MaskedBatchNorm`` over
every kept point of the batch -> ReLU), each but the last followed by its
voxel's max concatenated back onto each point; the last layer's max is the
voxel feature.  Voxels are laid out per frame (the reference runs the
frame under ``vmap``): key (z * ny + y) * nx + x, the ``segments`` layout
with the capacity ``max_voxels`` per frame.  Outputs: ``voxel_features``
(B, V, C), ``voxel_coords`` (B, V, 3) int32 [z, y, x] (-1 past the last
voxel) and ``voxel_num_points`` (B, V), the contract of ``MeanVFE``.
Coordinates stay f32, the pooled features go on in ``compute_dtype``, as
in ``DynamicPillarVFE``.
"""

from typing import NamedTuple

import torch
from torch import nn

from .dynamic_pillar_vfe import PFNLayerV2, pfn_channels, point_features
from .segments import (BIG, device_constant, segment_layout, segment_max,
                       segment_sum)


class VoxelLayout(NamedTuple):
    points: torch.Tensor    # (N, C) the frame's points in key order
    cells: torch.Tensor     # (N, 3) int32 their [x, y, z] cells
    vid: torch.Tensor       # (N,) voxel ids, cap for dropped points
    coords: torch.Tensor    # (cap, 3) int32 [z, y, x], -1 past the last voxel
    counts: torch.Tensor    # (cap,) int32 points a voxel, 0 there
    sums: torch.Tensor      # (cap + 1, C) the points' sums by voxel id
    ids_count: torch.Tensor  # (cap + 1,) int64 the points of each id


def voxel_layout(points, mask, voxel_size, pc_range, grid_size, cap):
    """One frame's points (N, C) f32 and mask (N,) -> ``VoxelLayout``: the
    cells floor((p - min) / size), key (z * ny + y) * nx + x, the
    ``segments`` layout with capacity ``cap``, each voxel's point sums."""
    vsz = device_constant(voxel_size, points)
    pc_min = device_constant(pc_range[:3], points)
    gsz = device_constant(grid_size, points.new_empty(0, dtype=torch.int32))
    cells = torch.floor((points[:, :3] - pc_min) / vsz).to(torch.int32)
    ok = ((cells >= 0) & (cells < gsz)).all(dim=1) & mask
    key = (cells[:, 2].long() * grid_size[1] + cells[:, 1]) * grid_size[0] \
        + cells[:, 0]
    order, first, vid = segment_layout(
        torch.where(ok, key, torch.full_like(key, BIG)), cap)
    pts_s, cells_s = points[order], cells[order]
    coords = torch.full((cap + 1, 3), -1, dtype=torch.int32,
                        device=points.device)
    coords[torch.where(first, vid, cap)] = cells_s.flip(1)
    coords = coords[:cap]
    sums, cnt = segment_sum(pts_s, vid, cap)
    counts = torch.where(coords[:, 0] >= 0, cnt[:cap], 0).to(torch.int32)
    return VoxelLayout(pts_s, cells_s, vid, coords, counts, sums, cnt)


class DynamicVoxelVFE(nn.Module):
    def __init__(self, model_cfg, num_point_features, voxel_size,
                 point_cloud_range, grid_size, max_voxels=60000):
        super().__init__()
        self.model_cfg = model_cfg
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        self.grid_size = tuple(int(g) for g in grid_size)
        self.max_voxels = int(max_voxels)
        num_filters = list(model_cfg.NUM_FILTERS)
        c = pfn_channels(model_cfg, num_point_features, 3)
        layers = []
        for i, out_ch in enumerate(num_filters):
            layers.append(PFNLayerV2(c, out_ch))
            c = 2 * out_ch          # the point and its voxel's max
        self.pfn_layers = nn.ModuleList(layers)

    def get_output_feature_dim(self):
        return list(self.model_cfg.NUM_FILTERS)[-1]

    def forward(self, batch_dict):
        points = batch_dict["points"]                  # (B, N, C) f32
        b, n, _ = points.shape
        v = self.max_voxels
        vsz = device_constant(self.voxel_size, points)
        pc_min = device_constant(self.point_cloud_range[:3], points)
        frames = [voxel_layout(points[i].float(), batch_dict["points_mask"][i],
                               self.voxel_size, self.point_cloud_range,
                               self.grid_size, v) for i in range(b)]
        pts_s, cells_s, vid, coords, counts, sums, cnt = (
            torch.stack(t) for t in zip(*frames))
        mean = sums[..., :3] / cnt.clamp_min(1)[..., None].float()
        f_cluster = pts_s[..., :3] - torch.gather(
            mean, 1, vid[..., None].expand(-1, -1, 3))
        f_center = pts_s[..., :3] - (cells_s.float() * vsz + pc_min + vsz / 2)
        kept = (vid < v).reshape(-1)
        x = point_features(self.model_cfg, pts_s, f_cluster, f_center) \
            * (vid < v)[..., None]
        # one segment max over the batch: frame f's voxel i is row
        # f * (V + 1) + i
        gid = (vid + torch.arange(b, device=vid.device)[:, None]
               * (v + 1)).reshape(-1)
        for i, pfn in enumerate(self.pfn_layers):
            x = pfn(x.reshape(b * n, -1), kept)
            pooled = segment_max(x, gid, b * (v + 1) - 1)
            if i < len(self.pfn_layers) - 1:
                x = torch.cat([x, pooled[gid]], dim=-1)
        feats = pooled.reshape(b, v + 1, -1)[:, :v] * (counts > 0)[..., None]
        batch_dict["voxel_features"] = feats.to(
            batch_dict.get("compute_dtype", points.dtype))
        batch_dict["voxel_coords"] = coords
        batch_dict["voxel_num_points"] = counts
        return batch_dict
