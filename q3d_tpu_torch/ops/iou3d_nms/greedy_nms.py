"""Kernel 2: greedy NMS suppression, as a hand-written CUDA kernel.

Replaces the TPU kernel ``q3d_tpu/ops/iou3d_nms/pallas_nms.py:45``
(``greedy_suppress_pallas`` -> ``_nms_kernel``).  Over a batch of S sets:

    keep[s, i] = valid[s, i] and not exists j < i:
                 keep[s, j] and iou[s, j, i] > thresh

with rows in descending score order and row j the suppressor.  The kernel
is ``csrc/greedy_nms.cu`` (bitmask scheme of the reference's ``nms_gpu``);
its plain PyTorch version is ``greedy_suppress_plain``, a sequential sweep
batched over the sets.
"""

import ctypes

import torch

from ..kernel_build import CudaLibrary

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaLibrary(
    "greedy_nms.cu",
    {"q3d_greedy_nms": [_P, _P, _P, _P, _I, _I, ctypes.c_float, _P]})
MAX_K = 2048


def greedy_suppress_plain(iou, valid, thresh):
    """iou (S, K, K) f32; valid (S, K) bool -> keep (S, K) bool."""
    k = iou.shape[-1]
    upper = torch.ones((k, k), dtype=torch.bool, device=iou.device).triu(1)
    over = (iou > thresh) & upper                  # [s, j, i]: j < i overlaps
    keep = valid.clone()
    for i in range(k):
        keep &= ~(over[:, i, :] & keep[:, i:i + 1])
    return keep


def greedy_suppress_cuda(iou, valid, thresh):
    """Launch the CUDA kernel (one launch, counted in ``KERNEL.launches``)."""
    dev = iou.device
    if dev.type != "cuda":
        raise ValueError("greedy_nms: iou must be a CUDA tensor")
    if iou.dtype != torch.float32 or iou.dim() != 3 or not iou.is_contiguous() \
            or iou.shape[1] != iou.shape[2]:
        raise ValueError("greedy_nms: iou must be a contiguous (S, K, K) f32 "
                         "tensor")
    s, k, _ = iou.shape
    if not 0 < k <= MAX_K:
        raise ValueError(f"greedy_nms: K must be in [1, {MAX_K}] (got {k})")
    if valid.dtype != torch.bool or valid.shape != (s, k) \
            or not valid.is_contiguous() or valid.device != dev:
        raise ValueError("greedy_nms: valid must be a contiguous (S, K) bool "
                         "tensor on the iou's device")
    mask = torch.empty((s, k, -(-k // 64)), dtype=torch.int64, device=dev)
    keep = torch.empty((s, k), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        KERNEL.call("q3d_greedy_nms", iou.data_ptr(), valid.data_ptr(),
                    mask.data_ptr(), keep.data_ptr(), s, k, float(thresh),
                    torch.cuda.current_stream(dev).cuda_stream)
    KERNEL.launches += 1
    return keep


def greedy_nms(iou, valid, thresh, impl=None):
    """Greedy suppression keep mask.  ``impl``: "cuda" (the kernel), "plain"
    (PyTorch), or None = the kernel for CUDA tensors and the plain version
    for CPU tensors.  A failing kernel raises; nothing falls back."""
    if impl is None:
        impl = "cuda" if iou.is_cuda else "plain"
    if impl == "cuda":
        return greedy_suppress_cuda(iou, valid, thresh)
    if impl == "plain":
        return greedy_suppress_plain(iou, valid, thresh)
    raise ValueError(f"unknown impl {impl!r}")
