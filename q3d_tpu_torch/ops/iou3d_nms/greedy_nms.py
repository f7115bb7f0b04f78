"""Kernel 2: greedy NMS suppression, as a hand-written CUDA kernel.

Replaces the TPU kernel ``q3d_tpu/ops/iou3d_nms/pallas_nms.py:45``
(``greedy_suppress_pallas`` -> ``_nms_kernel``).  Over a batch of S sets:

    keep[s, i] = valid[s, i] and not exists j < i:
                 keep[s, j] and iou[s, j, i] > thresh

with rows in descending score order and row j the suppressor.  The kernel
is ``csrc/greedy_nms.cu``, with two entries that share one sweep:

- the boxes form (``greedy_nms_boxes``, the model's path) takes the boxes
  and computes ``iou = boxes_iou_bev(b, b)`` itself, tile by tile on chip,
  bit-equal to the plain formula; its plain version is
  ``greedy_suppress_boxes_plain``;
- the IoU form (``greedy_nms``, the TPU kernel's own function) takes the
  (S, K, K) IoU matrix; its plain version is ``greedy_suppress_plain``, a
  sequential sweep batched over the sets.
"""

import ctypes

import torch

from ...utils import box_utils
from ..kernel_build import CudaLibrary

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# -fmad=false: no multiply-add contraction, so the kernel's IoU rounds
# exactly as PyTorch's one-op-at-a-time plain version does
KERNEL = CudaLibrary(
    "greedy_nms.cu",
    {"q3d_greedy_nms": [_P, _P, _P, _P, _I, _I, _F, _P],
     "q3d_greedy_nms_boxes": [_P] * 6 + [_I, _I, _F, _P],
     "q3d_greedy_nms_scratch_words": ([_I, _I, _I], ctypes.c_longlong)},
    variants=(("-fmad=false",),))
MAX_K = 2048


def _require(cond, msg):
    if not cond:
        raise ValueError(f"greedy_nms: {msg}")


def greedy_suppress_plain(iou, valid, thresh):
    """iou (S, K, K) f32; valid (S, K) bool -> keep (S, K) bool."""
    k = iou.shape[-1]
    upper = torch.ones((k, k), dtype=torch.bool, device=iou.device).triu(1)
    over = (iou > thresh) & upper                  # [s, j, i]: j < i overlaps
    keep = valid.clone()
    for i in range(k):
        keep &= ~(over[:, i, :] & keep[:, i:i + 1])
    return keep


def greedy_suppress_boxes_plain(boxes, valid, thresh):
    """boxes (S, K, 7+) score-ordered; valid (S, K) bool -> keep (S, K)."""
    # iou3d_nms_utils imports this module for nms_bev
    from .iou3d_nms_utils import boxes_iou_bev
    box7 = boxes[..., :7]
    return greedy_suppress_plain(boxes_iou_bev(box7, box7), valid, thresh)


def _scratch(s, k, boxes, dev):
    """The kernel's scratch (its layout is the source's), 16-byte aligned
    as the sweep's staging copies need (PyTorch allocates 512-aligned)."""
    words = KERNEL.lib()["q3d_greedy_nms_scratch_words"](s, k, int(boxes))
    return torch.empty(words, dtype=torch.int64, device=dev)


def _check_sets(valid, s, k, dev):
    _require(0 < k <= MAX_K, f"K must be in [1, {MAX_K}] (got {k})")
    _require(valid.dtype == torch.bool and valid.shape == (s, k)
             and valid.is_contiguous() and valid.device == dev,
             "valid must be a contiguous (S, K) bool tensor on the input's "
             "device")
    _require(dev.type == "cuda", "the input must be a CUDA tensor")


def greedy_suppress_cuda(iou, valid, thresh):
    """The IoU form: one launch, counted in ``KERNEL.launches``."""
    _require(iou.dtype == torch.float32 and iou.dim() == 3
             and iou.is_contiguous() and iou.shape[1] == iou.shape[2],
             "iou must be a contiguous (S, K, K) f32 tensor")
    s, k, _ = iou.shape
    dev = iou.device
    _check_sets(valid, s, k, dev)
    scratch = _scratch(s, k, False, dev)
    keep = torch.empty((s, k), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        KERNEL.call("q3d_greedy_nms", iou.data_ptr(), valid.data_ptr(),
                    scratch.data_ptr(), keep.data_ptr(), s, k, float(thresh),
                    torch.cuda.current_stream(dev).cuda_stream)
    KERNEL.launches["q3d_greedy_nms"] += 1
    return keep


def bev_corners_areas(boxes):
    """(S, K, 7+) -> the boxes form's inputs: BEV corners (S, K, 4, 2) and
    areas dx * dy (S, K), f32 and contiguous, computed as boxes_iou_bev
    computes them."""
    box7 = boxes[..., :7]
    return (box_utils.boxes_to_corners_bev(box7).contiguous(),
            (box7[..., 3] * box7[..., 4]).contiguous())


def greedy_suppress_boxes_cuda(corners, areas, valid, thresh, iou_out=None):
    """The boxes form: one launch, counted in ``KERNEL.launches``.

    ``iou_out`` (S, K, K) f32, for checks only: the kernel writes the IoU of
    each pair it evaluated there and leaves every other entry as it was."""
    _require(corners.dtype == torch.float32 and corners.dim() == 4
             and corners.shape[2:] == (4, 2) and corners.is_contiguous(),
             "corners must be a contiguous (S, K, 4, 2) f32 tensor")
    s, k = corners.shape[:2]
    dev = corners.device
    _require(areas.dtype == torch.float32 and areas.shape == (s, k)
             and areas.is_contiguous() and areas.device == dev,
             "areas must be a contiguous (S, K) f32 tensor on the corners' "
             "device")
    if iou_out is not None:
        _require(iou_out.dtype == torch.float32 and iou_out.shape == (s, k, k)
                 and iou_out.is_contiguous() and iou_out.device == dev,
                 "iou_out must be a contiguous (S, K, K) f32 tensor on the "
                 "corners' device")
    _check_sets(valid, s, k, dev)
    scratch = _scratch(s, k, True, dev)
    keep = torch.empty((s, k), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        KERNEL.call("q3d_greedy_nms_boxes", corners.data_ptr(),
                    areas.data_ptr(), valid.data_ptr(), scratch.data_ptr(),
                    keep.data_ptr(),
                    None if iou_out is None else iou_out.data_ptr(), s, k,
                    float(thresh), torch.cuda.current_stream(dev).cuda_stream)
    KERNEL.launches["q3d_greedy_nms_boxes"] += 1
    return keep


def _impl_for(x, impl):
    if impl is None:
        impl = "cuda" if x.is_cuda else "plain"
    if impl not in ("cuda", "plain"):
        raise ValueError(f"unknown impl {impl!r}")
    return impl


def greedy_nms(iou, valid, thresh, impl=None):
    """Greedy suppression keep mask from an IoU matrix.  ``impl``: "cuda"
    (the kernel), "plain" (PyTorch), or None = the kernel for CUDA tensors
    and the plain version for CPU tensors.  A failing kernel raises; nothing
    falls back."""
    if _impl_for(iou, impl) == "cuda":
        return greedy_suppress_cuda(iou, valid, thresh)
    return greedy_suppress_plain(iou, valid, thresh)


def greedy_nms_boxes(boxes, valid, thresh, impl=None):
    """Greedy suppression keep mask of score-ordered boxes (S, K, 7+) under
    their rotated BEV IoU; ``impl`` as for ``greedy_nms``."""
    if _impl_for(boxes, impl) == "cuda":
        corners, areas = bev_corners_areas(boxes)
        return greedy_suppress_boxes_cuda(corners, areas, valid, thresh)
    return greedy_suppress_boxes_plain(boxes, valid, thresh)
