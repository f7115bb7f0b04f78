"""Point-cloud voxelization with fixed-capacity outputs (host numpy).

Port of ``q3d_tpu/ops/voxelizer.py::voxelize_np`` with the same semantics
(spconv ``Point2VoxelCPU3d``): grid index = floor((p - range_min) /
voxel_size), points outside the grid dropped, voxels in FIRST-SEEN point
order, at most ``max_points`` first-seen points per voxel, at most
``max_voxels`` voxels, coords [z, y, x].  The per-point Python loop of the
reference is written here as sorts and scatters; the result is identical
element for element (pinned by ``tests/test_torch_port_data.py``).
"""

import numpy as np


def voxelize_np(points, voxel_size, point_cloud_range, max_points, max_voxels):
    """points: (N, 3+C) float32 -> (voxels, coords_zyx, num_points, num_voxels).

    voxels: (max_voxels, max_points, 3+C) float32, zero-padded
    coords: (max_voxels, 3) int32 [z, y, x], padding rows = -1
    num_points: (max_voxels,) int32
    """
    points = np.ascontiguousarray(points, dtype=np.float32)
    voxel_size = np.asarray(voxel_size, np.float32)
    pc_range = np.asarray(point_cloud_range, np.float32)
    grid_size = np.round((pc_range[3:6] - pc_range[0:3]) / voxel_size).astype(np.int64)

    coords_f = (points[:, 0:3] - pc_range[0:3]) / voxel_size
    coords = np.floor(coords_f).astype(np.int64)  # [x, y, z] order here
    in_grid = ((coords >= 0) & (coords < grid_size)).all(axis=1)
    points = points[in_grid]
    coords = coords[in_grid]
    n = points.shape[0]

    n_feat = points.shape[1]
    voxels = np.zeros((max_voxels, max_points, n_feat), np.float32)
    out_coords = np.full((max_voxels, 3), -1, np.int32)
    num_points = np.zeros(max_voxels, np.int32)
    if n == 0:
        return voxels, out_coords, num_points, 0

    key = (coords[:, 2] * grid_size[1] + coords[:, 1]) * grid_size[0] + coords[:, 0]
    _, first_idx, inverse = np.unique(key, return_index=True, return_inverse=True)
    # voxel id = rank of the voxel's first point in point order
    by_first = np.argsort(first_idx, kind="stable")
    rank = np.empty_like(by_first)
    rank[by_first] = np.arange(len(by_first))
    vid = rank[inverse.reshape(-1)]
    num_voxels = min(len(first_idx), int(max_voxels))

    # slot of each point inside its voxel = its rank among the voxel's points
    order = np.argsort(vid, kind="stable")
    sorted_vid = vid[order]
    slot = np.empty(n, np.int64)
    slot[order] = np.arange(n) - np.searchsorted(sorted_vid, sorted_vid, side="left")

    take = (vid < max_voxels) & (slot < max_points)
    voxels[vid[take], slot[take]] = points[take]
    counts = np.bincount(vid[vid < max_voxels], minlength=max_voxels)
    num_points[:] = np.minimum(counts, max_points)
    out_coords[:num_voxels] = coords[first_idx[by_first[:num_voxels]], ::-1]
    return voxels, out_coords, num_points, num_voxels
