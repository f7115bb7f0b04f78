"""Kernel 1: the sparse gather-conv, as a hand-written CUDA kernel.

Replaces the TPU kernel ``q3d_tpu/ops/spconv/pallas_conv.py:274``
(``_onehot_conv_call``, entered through ``gather_conv_chunked_fast`` from
``modules.py:289,364``).  The function is

    out[m] = (sum_k f[idx[m, k]] @ W[k]) * out_scale * out_valid[m]

over a direct (M, K) rulebook whose misses lie outside [0, N).  The kernel
is ``csrc/sparse_gather_conv.cu`` (cp.async row gathers into a shared-memory
ring, ``mma.sync`` tensor cores for bf16 and s8); its plain PyTorch version
is ``engine.gather_conv`` (gather + one GEMM in the accumulation dtype).

Dtypes: f32 and bf16 inputs accumulate in f32 and return the input dtype;
s8 x s8 accumulates in s32 and returns f32 after ``out_scale``.  The kernel
has instances for Cin, Cout in {16, 32, 64, 128} and books of K <= 27 taps;
the wrapper raises on any other shape.
"""

import ctypes

import torch

from ..kernel_build import CudaLibrary
from .engine import gather_conv as gather_conv_plain

_P, _I = ctypes.c_void_p, ctypes.c_int
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "s8"}
# one build per dtype (16 width instances each), compiled in parallel
KERNEL = CudaLibrary(
    "sparse_gather_conv.cu",
    {f"q3d_sparse_gather_conv_{s}": [_P] * 6 + [_I] * 5 + [_P]
     for s in _SUFFIX.values()},
    variants=[(f"-DQ3D_GC_{s.upper()}",) for s in _SUFFIX.values()])
WIDTHS = (16, 32, 64, 128)
MAX_TAPS = 27


def _require(cond, msg):
    if not cond:
        raise ValueError(f"sparse_gather_conv: {msg}")


def gather_conv_cuda(features, gather_idx, weight, out_scale=None,
                     out_valid=None):
    """Launch the CUDA kernel (one launch, counted in ``KERNEL.launches``
    under its dtype's function)."""
    dev = features.device
    _require(dev.type == "cuda", "features must be a CUDA tensor")
    _require(features.dtype in _SUFFIX, f"unsupported dtype {features.dtype}")
    _require(features.dim() == 2 and features.is_contiguous(),
             "features must be a contiguous (N, Cin) tensor")
    n, cin = features.shape
    _require(gather_idx.dtype == torch.int32 and gather_idx.dim() == 2
             and gather_idx.is_contiguous() and gather_idx.device == dev,
             "gather_idx must be a contiguous (M, K) int32 tensor on the "
             "features' device")
    m, k = gather_idx.shape
    _require(weight.dtype == features.dtype and weight.is_contiguous()
             and weight.device == dev and tuple(weight.shape[:2]) == (k, cin),
             "weight must be a contiguous (K, Cin, Cout) tensor of the "
             "features' dtype and device")
    cout = weight.shape[2]
    _require(cin in WIDTHS and cout in WIDTHS,
             f"no kernel instance for Cin={cin}, Cout={cout} "
             f"(widths {WIDTHS})")
    _require(1 <= k <= MAX_TAPS, f"books of 1..{MAX_TAPS} taps (got {k})")
    _require(features.data_ptr() % 16 == 0 and weight.data_ptr() % 16 == 0,
             "features and weight must be 16-byte aligned (cp.async)")
    if out_scale is not None:
        out_scale = out_scale.reshape(-1)
        _require(out_scale.dtype == torch.float32 and out_scale.numel() == cout
                 and out_scale.is_contiguous() and out_scale.device == dev,
                 "out_scale must be a contiguous (Cout,) f32 tensor")
    if out_valid is not None:
        _require(out_valid.dtype == torch.bool and out_valid.shape == (m,)
                 and out_valid.is_contiguous() and out_valid.device == dev,
                 "out_valid must be a contiguous (M,) bool tensor")
    out = torch.empty((m, cout), device=dev,
                      dtype=torch.float32 if features.dtype == torch.int8
                      else features.dtype)
    entry = f"q3d_sparse_gather_conv_{_SUFFIX[features.dtype]}"
    with torch.cuda.device(dev):
        KERNEL.call(entry,
                    features.data_ptr(), gather_idx.data_ptr(),
                    weight.data_ptr(),
                    None if out_scale is None else out_scale.data_ptr(),
                    None if out_valid is None else out_valid.data_ptr(),
                    out.data_ptr(), n, m, k, cin, cout,
                    torch.cuda.current_stream(dev).cuda_stream)
    KERNEL.launches[entry] += 1
    return out


def sparse_gather_conv(features, gather_idx, weight, out_scale=None,
                       out_valid=None, impl=None):
    """The sparse conv.  ``impl``: "cuda" (the kernel), "plain" (PyTorch), or
    None = the kernel for CUDA tensors and the plain version for CPU
    tensors.  A failing kernel raises; nothing falls back."""
    if impl is None:
        impl = "cuda" if features.is_cuda else "plain"
    if impl == "cuda":
        return gather_conv_cuda(features, gather_idx, weight, out_scale,
                                out_valid)
    if impl == "plain":
        return gather_conv_plain(features, gather_idx, weight, out_scale,
                                 out_valid)
    raise ValueError(f"unknown impl {impl!r}")
