"""DynamicPillarVFE: pillar features straight from the raw points (port of
``q3d_tpu/models/backbones_3d/vfe/dynamic_pillar_vfe.py``).

Per point: [x, y, z, intensity (or intensity alone without
``USE_ABSLOTE_XYZ``), the offset to its pillar's point mean, the x / y
offset to its pillar's centre (, its distance)] -> PFN layers (Linear
without bias -> ``MaskedBatchNorm`` over the points that landed in a kept
pillar -> ReLU, per point) -> the max over each pillar's points.

Pillars are the cells of the (B, ny, nx) grid: key (b * ny + y) * nx + x,
out-of-range and padded points ``BIG``, the ``segments`` layout with the
capacity ``max_pillars`` over the whole batch (not per frame), so past it
the highest keys are dropped.  Outputs, flattened over the batch:
``pillar_features`` (P, C), ``pillar_coords`` (P, 3) int32 [b, y, x] with
-1 on the rows past the last pillar, and ``pillar_batch_size``.

The raw coordinates stay f32 whatever the batch's compute dtype
(``models.load_data_to_device`` does not cast ``points``: in bf16, points
54 m out are 0.25 m apart, more than three 0.075 m pillars); the VFE
computes in f32 and hands its pooled features on in ``compute_dtype``.
"""

import torch
from torch import nn

from ...layers import Linear, MaskedBatchNorm
from .segments import (BIG, device_constant, segment_layout, segment_max,
                       segment_sum)


class PFNLayerV2(nn.Module):
    """One point-wise layer: Linear (no bias) -> MaskedBatchNorm -> ReLU
    (OpenPCDet's ``PFNLayerV2`` slots ``linear`` / ``norm``)."""

    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.linear = Linear(in_channels, out_channels, bias=False)
        # its reference path is ``vfe.pfn_linear_<i>``
        # (``utils.weights.reference_module_path``)
        self.linear.dynamic_pfn = True
        self.norm = MaskedBatchNorm(out_channels, eps=1e-3)

    def forward(self, x, mask):
        return torch.relu(self.norm(self.linear(x), mask))


def point_features(model_cfg, pts, f_cluster, f_center):
    """[pts (or its columns past xyz), f_cluster, f_center (, |xyz|)] along
    the last dim, as both dynamic PFN VFEs build them."""
    feats = [pts if model_cfg.get("USE_ABSLOTE_XYZ", True) else pts[..., 3:],
             f_cluster, f_center]
    if model_cfg.get("WITH_DISTANCE", False):
        feats.append(torch.linalg.norm(pts[..., :3], dim=-1, keepdim=True))
    return torch.cat(feats, dim=-1)


def pfn_channels(model_cfg, num_point_features, center_dims):
    """The first PFN layer's input width."""
    c = num_point_features + 3 + center_dims
    if not model_cfg.get("USE_ABSLOTE_XYZ", True):
        c -= 3
    return c + (1 if model_cfg.get("WITH_DISTANCE", False) else 0)


class DynamicPillarVFE(nn.Module):
    def __init__(self, model_cfg, num_point_features, voxel_size,
                 point_cloud_range, grid_size, max_pillars=30000):
        super().__init__()
        self.model_cfg = model_cfg
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        self.grid_size = tuple(int(g) for g in grid_size)
        self.max_pillars = int(max_pillars)
        filters = [pfn_channels(model_cfg, num_point_features, 2),
                   *model_cfg.NUM_FILTERS]
        self.pfn_layers = nn.ModuleList(
            PFNLayerV2(filters[i], filters[i + 1])
            for i in range(len(filters) - 1))

    def get_output_feature_dim(self):
        return list(self.model_cfg.NUM_FILTERS)[-1]

    def forward(self, batch_dict):
        points = batch_dict["points"]                  # (B, N, C) f32
        b, n, c = points.shape
        nx, ny = self.grid_size[:2]
        vx, vy = self.voxel_size[:2]
        x0, y0 = self.point_cloud_range[:2]
        cap = self.max_pillars
        dev = points.device

        pts = points.float().reshape(b * n, c)
        b_idx = torch.arange(b, device=dev).repeat_interleave(n)
        # divided by a tensor: PyTorch multiplies a CUDA tensor by the
        # reciprocal of a Python divisor, which moves points that lie on a
        # pillar's edge into its neighbour
        size = device_constant((vx, vy), pts)
        cx = torch.floor((pts[:, 0] - x0) / size[0]).to(torch.int32)
        cy = torch.floor((pts[:, 1] - y0) / size[1]).to(torch.int32)
        ok = (cx >= 0) & (cx < nx) & (cy >= 0) & (cy < ny) \
            & batch_dict["points_mask"].reshape(-1)
        key = (b_idx * ny + cy) * nx + cx
        order, first, pid = segment_layout(
            torch.where(ok, key, torch.full_like(key, BIG)), cap)
        pts_s = pts[order]
        psum, pcnt = segment_sum(pts_s[:, :3], pid, cap)
        pmean = psum / pcnt.clamp_min(1)[:, None].float()
        f_cluster = pts_s[:, :3] - pmean[pid]
        cx_s, cy_s = cx[order], cy[order]
        f_center = torch.stack([
            pts_s[:, 0] - (cx_s.float() * vx + x0 + vx / 2),
            pts_s[:, 1] - (cy_s.float() * vy + y0 + vy / 2)], dim=1)
        kept = pid < cap
        x = point_features(self.model_cfg, pts_s, f_cluster, f_center) \
            * kept[:, None]
        for pfn in self.pfn_layers:
            x = pfn(x, kept)
        pooled = segment_max(x, pid, cap)[:cap]

        coords = torch.full((cap + 1, 3), -1, dtype=torch.int32, device=dev)
        byx = torch.stack([b_idx[order].to(torch.int32), cy_s, cx_s], dim=1)
        coords[torch.where(first, pid, cap)] = byx
        batch_dict["pillar_features"] = pooled.to(
            batch_dict.get("compute_dtype", points.dtype))
        batch_dict["pillar_coords"] = coords[:cap]
        batch_dict["pillar_batch_size"] = b
        return batch_dict
