"""Host-side numpy helpers of the data pipeline, and device resolution.

The numpy subset of ``q3d_tpu/utils/common_utils.py`` that the data path
calls, plus ``resolve_device``: the port's entry points run on the card
unless the caller asks for the CPU, and never fall back to it silently.
"""

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
