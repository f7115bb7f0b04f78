"""Points in rotated boxes and ROI-aware pooling, in torch on the device
(port of ``q3d_tpu/ops/roiaware_pool3d/roiaware_pool3d_utils.py``:
``_in_box_frame`` :17, ``points_in_boxes_jax`` :44 and ``roiaware_pool3d``
:56; the numpy ``points_in_boxes_cpu`` of the data pipeline is
``utils/box_utils.py``'s).

A point is inside a box when its offset from the centre, rotated into the
box's frame, is within half the box's size on each axis (z with a 1e-6
slack, as the reference's CUDA check has it).  Every operation is the
reference's, in its order, so the flags round alike.
"""

import torch


def in_box_frame(points_xyz, boxes):
    """(N, 3) points, (M, 7+) boxes -> (M, N, 3) offsets in each box's
    frame."""
    shift = points_xyz[None, :, :] - boxes[:, None, 0:3]
    cosa = torch.cos(-boxes[:, 6])[:, None]
    sina = torch.sin(-boxes[:, 6])[:, None]
    lx = shift[..., 0] * cosa - shift[..., 1] * sina
    ly = shift[..., 0] * sina + shift[..., 1] * cosa
    return torch.stack([lx, ly, shift[..., 2]], dim=-1)


def points_in_boxes(points_xyz, boxes):
    """(N, 3) points, (M, 7+) boxes -> (N,) int64: the index of the first
    box that holds the point, else -1."""
    n = points_xyz.shape[0]
    if boxes.shape[0] == 0:
        return torch.full((n,), -1, dtype=torch.long,
                          device=points_xyz.device)
    local = in_box_frame(points_xyz, boxes)
    half = boxes[:, None, 3:6] / 2
    inside = ((local[..., 0].abs() <= half[..., 0])
              & (local[..., 1].abs() <= half[..., 1])
              & (local[..., 2].abs() <= half[..., 2] + 1e-6))    # (M, N)
    # argmax: the first of the maxima, as the reference's
    first = inside.to(torch.uint8).argmax(dim=0)
    return torch.where(inside.any(dim=0), first, torch.full_like(first, -1))


def roiaware_cells(rois, points, out_size, point_valid=None):
    """The (ROI, point) pairs of ROI-aware pooling: rois (M, 7), points (N,
    3) -> (roi index (P,), point index (P,), flat cell (P,) in [0, M *
    cells), (ox, oy, oz)).  A point is inside an ROI when its offset is
    within half the ROI's size (no slack), and then in cell clip(int((local
    + half) / (size / out)), 0, out - 1), in the reference's float
    arithmetic (f32: the geometry of a bf16 model too); only the points
    ``point_valid`` marks count (None: all)."""
    out = (out_size,) * 3 if isinstance(out_size, int) else tuple(out_size)
    rois = rois.float()
    local = in_box_frame(points.float(), rois)                    # (M, N, 3)
    half = rois[:, None, 3:6] / 2
    inside = (local.abs() <= half).all(-1)
    if point_valid is not None:
        inside = inside & point_valid[None]
    grid = torch.tensor(out, dtype=torch.float32, device=rois.device)
    cell = torch.div(local + half, rois[:, None, 3:6] / grid).to(torch.int64)
    cell = torch.minimum(cell.clamp_min(0), (grid - 1).to(torch.int64))
    vox = (cell[..., 0] * out[1] + cell[..., 1]) * out[2] + cell[..., 2]
    roi_i, pt_i = inside.nonzero(as_tuple=True)
    return roi_i, pt_i, roi_i * (out[0] * out[1] * out[2]) + vox[roi_i, pt_i], \
        out


def pool_cells(cells, num_rois, point_features, pool_method="max"):
    """Pool (N, C) point features over ``roiaware_cells``' pairs -> (M, ox,
    oy, oz, C): "max" each cell's largest feature (``scatter_reduce``
    "amax"), "avg" its sum over its count (``index_add_``); an empty cell
    is 0."""
    roi_i, pt_i, slot, out = cells
    c = point_features.shape[1]
    feats = point_features[pt_i]
    pooled = point_features.new_zeros((num_rois * out[0] * out[1] * out[2],
                                       c))
    if pool_method == "max":
        pooled = pooled.scatter_reduce(0, slot[:, None].expand(-1, c), feats,
                                       "amax", include_self=False)
    else:
        count = point_features.new_zeros(pooled.shape[0]).index_add_(
            0, slot, torch.ones_like(feats[:, 0]))
        pooled = pooled.index_add(0, slot, feats) \
            / count.clamp_min(1.0)[:, None]
    return pooled.reshape(num_rois, *out, c)


def roiaware_pool3d(rois, points, point_features, out_size,
                    pool_method="max", point_valid=None):
    """ROI-aware pooling into each ROI's voxel grid (the reference's
    ``roiaware_pool3d``): rois (M, 7), points (N, 3), point_features (N, C)
    -> (M, ox, oy, oz, C), over the points ``point_valid`` marks (None:
    all).  The reference's max_pts_per_voxel, which it does not read, is
    left out."""
    return pool_cells(roiaware_cells(rois, points, out_size, point_valid),
                      rois.shape[0], point_features, pool_method)
