"""Points in rotated boxes, in torch on the device (port of
``q3d_tpu/ops/roiaware_pool3d/roiaware_pool3d_utils.py``: ``_in_box_frame``
:17 and ``points_in_boxes_jax`` :44; the numpy ``points_in_boxes_cpu`` of
the data pipeline is ``utils/box_utils.py``'s).

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
