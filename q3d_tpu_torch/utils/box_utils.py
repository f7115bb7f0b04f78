"""Box geometry: BEV corners (torch) and the data pipeline's range mask (numpy).

Port of the parts of ``q3d_tpu/utils/box_utils.py`` the CenterPoint path
uses.  Box convention: (x, y, z, dx, dy, dz, heading[, ...]) with (x, y, z)
the box centre and heading the rotation about +z (counter-clockwise).
"""

import numpy as np
import torch

_CORNER_TEMPLATE = np.array([
    [1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
    [1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1],
], dtype=np.float32) / 2.0


def boxes_to_corners_3d_numpy(boxes3d):
    """(N, 7) numpy -> (N, 8, 3) corners."""
    corners = boxes3d[:, None, 3:6] * _CORNER_TEMPLATE[None, :, :]
    c, s = np.cos(boxes3d[:, 6]), np.sin(boxes3d[:, 6])
    x = corners[..., 0] * c[:, None] - corners[..., 1] * s[:, None]
    y = corners[..., 0] * s[:, None] + corners[..., 1] * c[:, None]
    corners = np.stack([x, y, corners[..., 2]], axis=-1)
    return corners + boxes3d[:, None, 0:3]


def boxes_to_corners_bev(boxes):
    """(..., N, 7+) -> (..., N, 4, 2) BEV corners, counter-clockwise order."""
    half_dx = boxes[..., 3] * 0.5
    half_dy = boxes[..., 4] * 0.5
    lx = torch.stack([half_dx, -half_dx, -half_dx, half_dx], dim=-1)
    ly = torch.stack([half_dy, half_dy, -half_dy, -half_dy], dim=-1)
    cosa = torch.cos(boxes[..., 6])[..., None]
    sina = torch.sin(boxes[..., 6])[..., None]
    gx = lx * cosa - ly * sina + boxes[..., 0][..., None]
    gy = lx * sina + ly * cosa + boxes[..., 1][..., None]
    return torch.stack([gx, gy], dim=-1)


def mask_boxes_outside_range_numpy(boxes, limit_range, min_num_corners=1,
                                   use_center_to_filter=True):
    """boxes: (N, 7+) numpy -> bool (N,) keep mask."""
    if boxes.shape[0] == 0:
        return np.zeros(0, dtype=bool)
    lo = np.asarray(limit_range[0:3])
    hi = np.asarray(limit_range[3:6])
    if use_center_to_filter:
        c = boxes[:, 0:3]
        return ((c >= lo) & (c <= hi)).all(axis=1)
    corners = boxes_to_corners_3d_numpy(boxes)
    inside = ((corners >= lo) & (corners <= hi)).all(axis=2)
    return inside.sum(axis=1) >= min_num_corners
