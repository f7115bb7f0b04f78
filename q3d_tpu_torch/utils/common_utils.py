"""Helpers of the data pipeline and the heads, logging and seeding, and
device resolution.

The subset of ``q3d_tpu/utils/common_utils.py`` that the data path, the
CLIs and the two-stage heads call, plus ``resolve_device``: the port's
entry points run on the card unless the caller asks for the CPU, and
never fall back to it silently.
"""

import logging
import random

import numpy as np
import torch


def resolve_device(device=None):
    """``None`` -> the CUDA device; raises when CUDA is absent.  An explicit
    device (``"cpu"``, ``"cuda:1"``, a ``torch.device``) is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def mask_points_by_range(points, limit_range):
    """points: (N, 3+C) numpy; returns bool mask inside the xy range."""
    mask = ((points[:, 0] >= limit_range[0]) & (points[:, 0] <= limit_range[3])
            & (points[:, 1] >= limit_range[1]) & (points[:, 1] <= limit_range[4]))
    return mask


def keep_arrays_by_name(gt_names, used_classes):
    inds = [i for i, name in enumerate(gt_names) if name in used_classes]
    return np.array(inds, dtype=np.int64)


def drop_info_with_name(info, name):
    """An annos dict without the entries named ``name`` (every array with
    one row an entry is cut)."""
    ret_info = {}
    keep = [i for i, x in enumerate(info["name"]) if x != name]
    for key in info.keys():
        if isinstance(info[key], np.ndarray) \
                and info[key].shape[0] == len(info["name"]):
            ret_info[key] = info[key][keep]
        else:
            ret_info[key] = info[key]
    ret_info["name"] = info["name"][keep]
    return ret_info


class AverageMeter:
    """Running mean of a host-side measurement."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def create_logger(log_level=logging.INFO, name="q3d_tpu_torch"):
    """A console logger (the reference's ``create_logger`` without its log
    file): one stream handler, however often it is asked for."""
    logger = logging.getLogger(name)
    logger.setLevel(log_level)
    logger.propagate = False
    if not logger.handlers:
        console = logging.StreamHandler()
        console.setFormatter(logging.Formatter(
            "%(asctime)s  %(levelname)5s  %(message)s"))
        logger.addHandler(console)
    return logger


def set_random_seed(seed):
    """Seed the host's generators (Python, numpy) and torch's."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def limit_period(val, offset=0.5, period=np.pi):
    """Wrap ``val`` into [-offset*period, (1-offset)*period) (the
    reference's ``limit_period``; torch tensors or numpy arrays)."""
    floor = np.floor if isinstance(val, np.ndarray) else torch.floor
    return val - floor(val / period + offset) * period


def rotate_points_along_z(points, angle):
    """points (B, N, 3 + C) rotated about +z by angle (B,) radians,
    counter-clockwise; extra columns pass through (numpy arrays or torch
    tensors).  The reference's formula, a product with the rotation
    matrix, so that the two packages round alike."""
    if isinstance(points, torch.Tensor):
        angle = angle.to(points.dtype)
        cosa, sina = torch.cos(angle), torch.sin(angle)
        ones, zeros = torch.ones_like(cosa), torch.zeros_like(cosa)
        rot = torch.stack([cosa, sina, zeros, -sina, cosa, zeros, zeros,
                           zeros, ones], dim=-1).reshape(*angle.shape, 3, 3)
        return torch.cat([points[..., 0:3] @ rot, points[..., 3:]], dim=-1)
    angle = np.asarray(angle, dtype=points.dtype)
    cosa, sina = np.cos(angle), np.sin(angle)
    ones, zeros = np.ones_like(cosa), np.zeros_like(cosa)
    rot = np.stack([cosa, sina, zeros, -sina, cosa, zeros,
                    zeros, zeros, ones], axis=-1).reshape(*angle.shape, 3, 3)
    xyz = points[..., 0:3] @ rot
    return np.concatenate([xyz, points[..., 3:]], axis=-1)


def get_voxel_centers(voxel_coords, downsample_times, voxel_size,
                      point_cloud_range):
    """voxel_coords (N, 3) int [z, y, x] -> (N, 3) f32 centres [x, y, z] of
    voxels ``downsample_times`` the base voxel size (the reference's
    ``get_voxel_centers``, :76, in its order of operations)."""
    coords = voxel_coords.flip(-1).to(torch.float32)

    def const(values):
        # filled on the device (a host copy would wait for the queue)
        return torch.stack([torch.full((), float(v), dtype=torch.float32,
                                       device=voxel_coords.device)
                            for v in values])
    vsz = const(voxel_size) * downsample_times
    return (coords + 0.5) * vsz + const(point_cloud_range[0:3])
