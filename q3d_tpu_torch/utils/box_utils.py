"""Box geometry: corners, BEV IoU for anchor matching, point-in-box tests and
the data pipeline's range mask.

Port of the parts of ``q3d_tpu/utils/box_utils.py`` the ported paths use,
and of ``q3d_tpu/ops/roiaware_pool3d/roiaware_pool3d_utils.py::
points_in_boxes_cpu``.  The data pipeline's functions and the KITTI camera conversions (the
dataset's prediction export and the official AP evaluator) take numpy
arrays;
``boxes_iou_normal`` and ``boxes3d_nearest_bev_iou`` torch tensors (the
target assigner's, on the device, and the gt sampler's), each computed in
the reference's order of operations.  Box convention: (x, y,
z, dx, dy, dz, heading[, ...]) with (x, y, z) the box centre and heading
the rotation about +z (counter-clockwise).
"""

import numpy as np
import torch

from . import common_utils

_CORNER_TEMPLATE = np.array([
    [1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
    [1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1],
], dtype=np.float32) / 2.0


def boxes_to_corners_3d(boxes3d):
    """numpy (N, 7) -> (N, 8, 3) corners (the reference's corner order)."""
    template = _CORNER_TEMPLATE.astype(boxes3d.dtype)
    corners = boxes3d[:, None, 3:6] * template[None, :, :]
    corners = common_utils.rotate_points_along_z(corners, boxes3d[:, 6])
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
    corners = boxes_to_corners_3d(boxes)
    inside = ((corners >= lo) & (corners <= hi)).all(axis=2)
    return inside.sum(axis=1) >= min_num_corners


def points_in_boxes_cpu(points, boxes):
    """numpy: points (N, 3+), boxes (M, 7) -> (M, N) int32 0/1 flags: |local
    x| <= dx/2, |local y| <= dy/2, |z - zc| <= dz/2 + 1e-6."""
    points = np.asarray(points, dtype=np.float32)
    boxes = np.asarray(boxes, dtype=np.float32)
    shift = points[None, :, 0:3] - boxes[:, None, 0:3]
    cosa = np.cos(-boxes[:, 6])[:, None]
    sina = np.sin(-boxes[:, 6])[:, None]
    lx = shift[..., 0] * cosa - shift[..., 1] * sina
    ly = shift[..., 0] * sina + shift[..., 1] * cosa
    half = boxes[:, None, 3:6] / 2
    flags = ((np.abs(lx) <= half[..., 0]) & (np.abs(ly) <= half[..., 1])
             & (np.abs(shift[..., 2]) <= half[..., 2] + 1e-6))
    return flags.astype(np.int32)


def remove_points_in_boxes3d(points, boxes3d):
    """numpy: drop the points whose xyz falls inside any box."""
    flags = points_in_boxes_cpu(points[:, 0:3], boxes3d)
    return points[flags.sum(axis=0) == 0]


def enlarge_box3d(boxes3d, extra_width=(0, 0, 0)):
    """Boxes grown by ``extra_width`` on each side of each axis: numpy
    arrays (the gt sampler's), or torch tensors on their device (the point
    head's targets; the reference's jnp form, :81)."""
    if isinstance(boxes3d, torch.Tensor):
        extra = torch.tensor(extra_width, dtype=boxes3d.dtype,
                             device=boxes3d.device)
        return torch.cat([boxes3d[:, 0:3], boxes3d[:, 3:6] + extra[None] * 2,
                          boxes3d[:, 6:]], dim=1)
    large = np.asarray(boxes3d).copy()
    large[:, 3:6] = large[:, 3:6] \
        + np.asarray(extra_width, dtype=boxes3d.dtype)[None, :] * 2
    return large


def boxes_iou_normal(boxes_a, boxes_b):
    """Axis-aligned 2D IoU of (..., N, 4) and (..., M, 4) [x1, y1, x2, y2]
    boxes -> (..., N, M)."""
    a, b = boxes_a[..., :, None, :], boxes_b[..., None, :, :]
    x_min = torch.maximum(a[..., 0], b[..., 0])
    y_min = torch.maximum(a[..., 1], b[..., 1])
    x_max = torch.minimum(a[..., 2], b[..., 2])
    y_max = torch.minimum(a[..., 3], b[..., 3])
    inter = torch.clamp_min(x_max - x_min, 0) \
        * torch.clamp_min(y_max - y_min, 0)
    area_a = (boxes_a[..., 2] - boxes_a[..., 0]) \
        * (boxes_a[..., 3] - boxes_a[..., 1])
    area_b = (boxes_b[..., 2] - boxes_b[..., 0]) \
        * (boxes_b[..., 3] - boxes_b[..., 1])
    return inter / torch.clamp_min(area_a[..., :, None] + area_b[..., None, :]
                                   - inter, 1e-6)


def boxes3d_nearest_bev_iou(boxes_a, boxes_b):
    """BEV IoU of the axis-aligned boxes of the nearest 90-degree
    orientation, (..., N, 7+) and (..., M, 7+) -> (..., N, M): the
    axis-aligned target assigner's and the gt sampler's measure."""
    def to_aabb(boxes):
        rot = common_utils.limit_period(boxes[..., 6], 0.5, np.pi)
        swap = torch.abs(rot) > np.pi / 4
        dx = torch.where(swap, boxes[..., 4], boxes[..., 3])
        dy = torch.where(swap, boxes[..., 3], boxes[..., 4])
        return torch.stack([boxes[..., 0] - dx / 2, boxes[..., 1] - dy / 2,
                            boxes[..., 0] + dx / 2, boxes[..., 1] + dy / 2],
                           dim=-1)

    return boxes_iou_normal(to_aabb(boxes_a), to_aabb(boxes_b))


# KITTI camera-frame conversions (host numpy; the KITTI dataset's
# generate_prediction_dicts and the official AP evaluator)

def boxes3d_lidar_to_kitti_camera(boxes3d_lidar, calib):
    """(N, 7) lidar [x, y, z, dx, dy, dz, heading] -> (N, 7) camera [x, y,
    z, l, h, w, ry]: the camera box sits on its bottom face, ry about the
    camera's -y axis."""
    boxes3d_lidar = boxes3d_lidar.copy()
    xyz_lidar = boxes3d_lidar[:, 0:3].copy()
    dx, dy, dz = boxes3d_lidar[:, 3:4], boxes3d_lidar[:, 4:5], \
        boxes3d_lidar[:, 5:6]
    r = boxes3d_lidar[:, 6:7]
    xyz_lidar[:, 2] -= dz.reshape(-1) / 2
    xyz_cam = calib.lidar_to_rect(xyz_lidar)
    ry = -r - np.pi / 2
    return np.concatenate([xyz_cam, dx, dz, dy, ry], axis=1)


def boxes3d_kitti_camera_to_lidar(boxes3d_camera, calib):
    """(N, 7) camera [x, y, z, l, h, w, ry] -> (N, 7) lidar [x, y, z, dx,
    dy, dz, heading]."""
    boxes3d_camera = boxes3d_camera.copy()
    xyz_cam = boxes3d_camera[:, 0:3]
    l, h, w = boxes3d_camera[:, 3:4], boxes3d_camera[:, 4:5], \
        boxes3d_camera[:, 5:6]
    ry = boxes3d_camera[:, 6:7]
    xyz_lidar = calib.rect_to_lidar(xyz_cam)
    xyz_lidar[:, 2] += h.reshape(-1) / 2
    heading = -ry - np.pi / 2
    return np.concatenate([xyz_lidar, l, w, h, heading], axis=1)


def boxes3d_kitti_camera_to_imageboxes(boxes3d_camera, calib,
                                       image_shape=None):
    """(N, 7) camera boxes -> (N, 4) [x1, y1, x2, y2] image boxes: the
    projected corners' extent, clipped to the image when its (H, W) is
    given."""
    corners = camera_boxes_to_corners_3d(boxes3d_camera)
    pts_img, _ = calib.rect_to_img(corners.reshape(-1, 3))
    pts_img = pts_img.reshape(-1, 8, 2)
    boxes2d = np.concatenate([pts_img.min(axis=1), pts_img.max(axis=1)],
                             axis=1)
    if image_shape is not None:
        boxes2d[:, 0] = np.clip(boxes2d[:, 0], 0, image_shape[1] - 1)
        boxes2d[:, 1] = np.clip(boxes2d[:, 1], 0, image_shape[0] - 1)
        boxes2d[:, 2] = np.clip(boxes2d[:, 2], 0, image_shape[1] - 1)
        boxes2d[:, 3] = np.clip(boxes2d[:, 3], 0, image_shape[0] - 1)
    return boxes2d


def camera_boxes_to_corners_3d(boxes3d):
    """(N, 7) camera [x, y, z, l, h, w, ry] -> (N, 8, 3) corners in the
    rect camera frame."""
    l, h, w = boxes3d[:, 3:4], boxes3d[:, 4:5], boxes3d[:, 5:6]
    x_c = np.array([1, 1, -1, -1, 1, 1, -1, -1], dtype=np.float32) / 2
    y_c = np.array([0, 0, 0, 0, -1, -1, -1, -1], dtype=np.float32)
    z_c = np.array([1, -1, -1, 1, 1, -1, -1, 1], dtype=np.float32) / 2
    corners = np.stack([l * x_c, h * y_c, w * z_c], axis=-1)
    ry = boxes3d[:, 6]
    cosa, sina = np.cos(ry), np.sin(ry)
    zeros, ones = np.zeros_like(cosa), np.ones_like(cosa)
    rot = np.stack([cosa, zeros, -sina,
                    zeros, ones, zeros,
                    sina, zeros, cosa], axis=-1).reshape(-1, 3, 3)
    corners = corners @ rot
    return corners + boxes3d[:, None, 0:3]
