"""Host-side numpy helpers of the data pipeline, logging and seeding, and
device resolution.

The subset of ``q3d_tpu/utils/common_utils.py`` that the data path and the
CLIs call, plus ``resolve_device``: the port's entry points run on the card
unless the caller asks for the CPU, and never fall back to it silently.
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
    reference's ``limit_period``, torch tensors)."""
    return val - torch.floor(val / period + offset) * period
