"""VoxelSetAbstraction — PV-RCNN's keypoint features (port of
``q3d_tpu/models/backbones_3d/pfe/voxel_set_abstraction.py``).

FPS keypoints from the raw points; around each keypoint, PointNet++ set
abstraction over the raw points and over the voxel centres of each named
sparse stage (ball query, grouping, ``SAMLPBlock``), and the bilinear
sample of the BEV map; all concatenated and fused by a Linear, BN and
ReLU into ``point_features`` (B * K, C) with ``point_coords`` (B * K, 4)
[b, x, y, z].  Module names are the reference's (``sa_raw_r0_4``,
``sa_x_conv1_r0_4``, ``vsa_point_feature_fusion``, ``fusion_norm``), so
its variables carry across by name.

The BNs return f32, as flax promotes a bf16 input with its f32
parameters, and the raw points stay f32 (``load_data_to_device``), so the
keypoints and everything past each block's first BN are f32 also in a
bf16 forward.  FPS sampling only: SPC sampling,
``VectorPoolAggregationModuleMSG`` and ``FILTER_NEIGHBOR_WITH_ROI`` belong
to PV-RCNN++ and raise.
"""

import torch
from torch import nn

from ....ops.ingroup_inds import ingroup_inds
from ....ops.pointnet2_utils import (ball_query, farthest_point_sample,
                                     group_points, index_points)
from ....ops.spconv.modules import dequantize_tensor
from ....utils import common_utils
from ...layers import BatchNorm1d, Linear


def f32_batch_norm(channels):
    """A BatchNorm1d whose output is f32, as flax's is for a bf16 input."""
    bn = BatchNorm1d(channels)
    bn.out_f32 = True
    return bn


def radius_name(radius):
    """The reference's module-name suffix of a radius as its config writes
    it: 0.4 -> "0_4"."""
    return str(radius).replace(".", "_")


class SAMLPBlock(nn.Module):
    """Grouped-feature MLP and masked max-pool of one radius group (the
    reference's ``_SAMLPBlock``, :25): per layer Linear (no bias), BN,
    ReLU over (B, K, S, C), then the max over the group's valid members; a
    group with none gives 0."""

    def __init__(self, in_channels, mlps):
        super().__init__()
        self.num_layers = len(mlps)
        for i, c in enumerate(mlps):
            self.add_module(f"mlp{i}", Linear(in_channels, c, bias=False))
            self.add_module(f"norm{i}", f32_batch_norm(c))
            in_channels = c
        self.out_channels = in_channels

    def forward(self, grouped, in_mask):
        x = grouped
        for i in range(self.num_layers):
            x = torch.relu(getattr(self, f"norm{i}")(
                getattr(self, f"mlp{i}")(x)))
        x = torch.where(in_mask[..., None], x, -torch.inf).amax(dim=2)
        return torch.where(torch.isfinite(x), x, 0.0)


def set_abstraction(blocks, sa_cfg, xyz, feats, centres, valid):
    """Each radius of one source: ball query of ``centres`` over ``xyz``
    (B, N, 3) with ``valid``, relative xyz and ``feats`` grouped, its
    block -> (B, M, sum of the blocks' widths)."""
    out = []
    for block, radius, nsample in zip(blocks, sa_cfg["POOL_RADIUS"],
                                      sa_cfg["NSAMPLE"]):
        idx, in_mask = ball_query(float(radius), int(nsample), xyz, centres,
                                  valid)
        grouped = torch.cat([group_points(xyz, idx) - centres[:, :, None, :],
                             group_points(feats, idx)], dim=-1)
        out.append(block(grouped, in_mask))
    return torch.cat(out, dim=-1)


def stage_points(st, stride, voxel_size, point_cloud_range, batch_size):
    """A sparse stage's rows -> per-frame voxel centres, features and valid
    flags, (B, cap, ...) with cap = capacity // B (``_regroup``)."""
    st = dequantize_tensor(st)
    centres = common_utils.get_voxel_centers(
        st.indices[:, 1:], stride, voxel_size, point_cloud_range)
    return regroup(centres, st.features, st.indices[:, 0], st.valid,
                   batch_size, st.capacity // batch_size)


class VoxelSetAbstraction(nn.Module):
    def __init__(self, model_cfg, voxel_size, point_cloud_range,
                 num_bev_features, num_rawpoint_features, backbone_channels):
        super().__init__()
        self.model_cfg = model_cfg
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        if model_cfg.get("SAMPLE_METHOD", "FPS") != "FPS":
            raise NotImplementedError(
                "VoxelSetAbstraction: only FPS keypoint sampling is ported")
        self.sources = list(model_cfg.FEATURES_SOURCE)
        self.blocks = {}
        width = num_bev_features if "bev" in self.sources else 0
        for src in self.sources:
            if src == "bev":
                continue
            sa = model_cfg.SA_LAYER[src]
            if sa.get("NAME", "") == "VectorPoolAggregationModuleMSG" \
                    or sa.get("FILTER_NEIGHBOR_WITH_ROI", False):
                raise NotImplementedError(
                    f"VoxelSetAbstraction: {src}'s vector pool / ROI "
                    f"neighbour filter (PV-RCNN++) is not ported")
            cin = num_rawpoint_features if src == "raw_points" \
                else 3 + backbone_channels[src]
            tag = "raw" if src == "raw_points" else src
            names = []
            for radius, mlps in zip(sa["POOL_RADIUS"], sa["MLPS"]):
                name = f"sa_{tag}_r{radius_name(radius)}"
                block = SAMLPBlock(cin, mlps)
                self.add_module(name, block)
                names.append(name)
                width += block.out_channels
            self.blocks[src] = names
        self.vsa_point_feature_fusion = Linear(
            width, model_cfg.NUM_OUTPUT_FEATURES, bias=False)
        self.fusion_norm = f32_batch_norm(model_cfg.NUM_OUTPUT_FEATURES)

    @property
    def num_point_features(self):
        return int(self.model_cfg.NUM_OUTPUT_FEATURES)

    def sample_keypoints(self, points, mask):
        """(B, N, 3+) raw points -> (B, NUM_KEYPOINTS, 3) FPS keypoints."""
        xyz = points[:, :, :3].float()
        idx = farthest_point_sample(xyz, int(self.model_cfg.NUM_KEYPOINTS),
                                    mask)
        return index_points(xyz, idx)

    def _blocks(self, src):
        return [getattr(self, n) for n in self.blocks[src]]

    def forward(self, batch_dict):
        points = batch_dict["points"]                    # (B, N, C) f32
        pmask = batch_dict["points_mask"]
        b = points.shape[0]
        keypoints = self.sample_keypoints(points, pmask)
        feats = []
        if "bev" in self.sources:
            bev = batch_dict["spatial_features"]         # (B, C, H, W)
            stride = batch_dict.get("spatial_features_stride", 8)

            def div(v):
                # a tensor divisor (on the card PyTorch multiplies by the
                # reciprocal of a Python one), filled on the device
                return torch.full((), v, dtype=torch.float32,
                                  device=keypoints.device)
            xs = (keypoints[..., 0] - self.point_cloud_range[0]) \
                / div(self.voxel_size[0]) / div(stride)
            ys = (keypoints[..., 1] - self.point_cloud_range[1]) \
                / div(self.voxel_size[1]) / div(stride)
            feats.append(bilinear(bev, xs, ys))
        if "raw_points" in self.sources:
            feats.append(set_abstraction(
                self._blocks("raw_points"), self.model_cfg.SA_LAYER[
                    "raw_points"], points[:, :, :3].float(),
                points[:, :, 3:].float(), keypoints, pmask))
        ms = batch_dict.get("multi_scale_3d_features", {})
        for src in self.sources:
            if src not in ms:
                continue
            xyz, fts, mask = stage_points(
                ms[src], batch_dict["multi_scale_3d_strides"][src],
                self.voxel_size, self.point_cloud_range, b)
            feats.append(set_abstraction(
                self._blocks(src), self.model_cfg.SA_LAYER[src], xyz, fts,
                keypoints, mask))
        kp_feats = torch.cat(feats, dim=-1)              # (B, K, Ct)
        out = torch.relu(self.fusion_norm(
            self.vsa_point_feature_fusion(kp_feats)))
        k = keypoints.shape[1]
        b_col = torch.arange(b, dtype=torch.float32,
                             device=keypoints.device)[:, None, None] \
            .expand(b, k, 1)
        batch_dict["point_features"] = out.reshape(b * k, -1)
        batch_dict["point_coords"] = torch.cat(
            [b_col, keypoints], dim=-1).reshape(b * k, 4)
        batch_dict["keypoints"] = keypoints
        return batch_dict


def bilinear(bev, xs, ys):
    """bev (B, C, H, W); xs / ys (B, K) grid coordinates -> (B, K, C), the
    reference's ``_bilinear`` (:183): corners clipped to the map, weights
    clipped to [0, 1]."""
    b, c, h, w = bev.shape
    x0 = torch.clamp(torch.floor(xs).to(torch.int64), 0, w - 2)
    y0 = torch.clamp(torch.floor(ys).to(torch.int64), 0, h - 2)
    wx = torch.clamp(xs - x0, 0, 1)[..., None]
    wy = torch.clamp(ys - y0, 0, 1)[..., None]
    nhwc = bev.permute(0, 2, 3, 1)
    rows = torch.arange(b, device=bev.device)[:, None]

    def at(yy, xx):
        return nhwc[rows, yy, xx]
    return (at(y0, x0) * (1 - wy) * (1 - wx) + at(y0, x0 + 1) * (1 - wy) * wx
            + at(y0 + 1, x0) * wy * (1 - wx) + at(y0 + 1, x0 + 1) * wy * wx)


def regroup(centres, features, batch_idx, valid, batch_size, cap):
    """Flattened (Nv, ...) rows -> per-frame (B, cap, ...) with a mask (the
    reference's ``_regroup``, :202): frame b's valid rows in appearance
    order at slots b * cap + rank; a row ranked past ``cap`` is dropped."""
    rank = ingroup_inds(batch_idx.to(torch.int32), valid)
    slot = torch.where(valid & (rank < cap),
                       batch_idx.long() * cap + rank, batch_size * cap)
    n = batch_size * cap + 1
    xyz = centres.new_zeros((n, 3)).index_put_((slot,), centres)
    fts = features.new_zeros((n, features.shape[1])).index_put_(
        (slot,), features)
    msk = torch.zeros(n, dtype=torch.bool, device=valid.device).index_put_(
        (slot,), valid)
    return (xyz[:-1].reshape(batch_size, cap, 3),
            fts[:-1].reshape(batch_size, cap, -1),
            msk[:-1].reshape(batch_size, cap))
