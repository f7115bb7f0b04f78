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

The s8 variant has a second entry for int8 residency,
``sparse_gather_conv_requant``: the same conv with the residency epilogue
of ``q3d_tpu/ops/spconv/modules.py:397-416`` fused (BN fold, residual,
ReLU, row mask, per-tensor requant), so the conv emits s8 rows.  Its plain
version is ``gather_conv_plain`` + ``epilogue_f32`` + ``quantize_with_scale``,
op for op in the reference's order; the kernel is built without multiply-add
contraction and with IEEE division, so the two are bit-equal.
"""

import ctypes

import torch

from ...quant.tensor_quant import quantize_with_scale
from ..kernel_build import CudaLibrary
from .engine import gather_conv as gather_conv_plain

_P, _I = ctypes.c_void_p, ctypes.c_int
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "s8"}
REQUANT_ENTRY = "q3d_sparse_gather_conv_s8_requant"
# one build per dtype (16 width instances each), and one for the fused
# requant entry (-fmad=false: its epilogue rounds op by op as PyTorch
# does), compiled in parallel
KERNEL = CudaLibrary(
    "sparse_gather_conv.cu",
    {**{f"q3d_sparse_gather_conv_{s}": [_P] * 6 + [_I] * 5 + [_P]
        for s in _SUFFIX.values()},
     REQUANT_ENTRY: [_P] * 6 + [_I] * 5 + [_P] * 8},
    variants=[(f"-DQ3D_GC_{s.upper()}",) for s in _SUFFIX.values()]
    + [("-DQ3D_GC_S8_REQUANT", "-fmad=false")])
WIDTHS = (16, 32, 64, 128)
MAX_TAPS = 27


def _require(cond, msg):
    if not cond:
        raise ValueError(f"sparse_gather_conv: {msg}")


def _check_conv_args(features, gather_idx, weight, out_scale, out_valid):
    """Validate the conv's inputs for the kernel -> (n, cin, m, k, cout,
    out_scale as (Cout,) or None)."""
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
    return n, cin, m, k, cout, out_scale


def _f32_vector(x, name, cout, dev):
    x = x.reshape(-1)
    _require(x.dtype == torch.float32 and x.numel() == cout
             and x.is_contiguous() and x.device == dev,
             f"{name} must be a contiguous ({cout},) f32 tensor")
    return x


def _f32_scalar(x, name, dev):
    _require(x.dtype == torch.float32 and x.numel() == 1 and x.device == dev,
             f"{name} must be a one-element f32 tensor on the features' device")
    return x.reshape(1).contiguous()


def gather_conv_cuda(features, gather_idx, weight, out_scale=None,
                     out_valid=None):
    """Launch the CUDA kernel (one launch, counted in ``KERNEL.launches``
    under its dtype's function)."""
    n, cin, m, k, cout, out_scale = _check_conv_args(
        features, gather_idx, weight, out_scale, out_valid)
    dev = features.device
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


def epilogue_f32(y, k, b, row_valid=None, identity=None, identity_scale=None):
    """The residency epilogue up to the requant, in the reference's order
    (``modules.py:403-414``): y * k + b (BN fold), + identity (times its
    scale when it is int8), ReLU, * row_valid (pads stay exactly zero)."""
    y = y.float() * k + b
    if identity is not None:
        idf = identity.float()
        if identity_scale is not None:
            idf = idf * identity_scale
        y = y + idf
    y = torch.relu(y)
    if row_valid is not None:
        y = y * row_valid[:, None]
    return y


def gather_conv_requant_plain(features, gather_idx, weight, out_scale, k, b,
                              scale, out_valid=None, row_valid=None,
                              identity=None, identity_scale=None):
    """Plain version of the fused entry: the s8 conv, the epilogue, then
    clip(round(y / scale), -127, 127) -> (M, Cout) int8."""
    y = gather_conv_plain(features, gather_idx, weight, out_scale, out_valid)
    return quantize_with_scale(
        epilogue_f32(y, k, b, row_valid, identity, identity_scale), scale)


def gather_conv_requant_cuda(features, gather_idx, weight, out_scale, k, b,
                             scale, out_valid=None, row_valid=None,
                             identity=None, identity_scale=None):
    """Launch the fused s8 entry (counted under ``REQUANT_ENTRY``).  The
    identity is s8 with its one-element f32 scale, or float (a bf16 identity
    is cast to f32, which is exact); nothing else is taken."""
    _require(features.dtype == torch.int8, "the requant entry takes s8 features")
    n, cin, m, k_taps, cout, out_scale = _check_conv_args(
        features, gather_idx, weight, out_scale, out_valid)
    _require(out_scale is not None, "the requant entry needs out_scale")
    dev = features.device
    k = _f32_vector(k, "k", cout, dev)
    b = _f32_vector(b, "b", cout, dev)
    scale = _f32_scalar(scale, "scale", dev)
    if row_valid is not None:
        _require(row_valid.dtype == torch.bool and row_valid.shape == (m,)
                 and row_valid.is_contiguous() and row_valid.device == dev,
                 "row_valid must be a contiguous (M,) bool tensor")
    id_s8 = id_scale = id_f32 = None
    if identity is not None:
        _require(identity.shape == (m, cout) and identity.device == dev,
                 "identity must be (M, Cout) on the features' device")
        if identity.dtype == torch.int8:
            _require(identity_scale is not None,
                     "an s8 identity needs its scale")
            id_s8 = identity.contiguous()
            id_scale = _f32_scalar(identity_scale, "identity_scale", dev)
        else:
            _require(identity.dtype in (torch.float32, torch.bfloat16)
                     and identity_scale is None,
                     "a float identity is f32 or bf16, without a scale")
            id_f32 = identity.float().contiguous()
        _require((id_s8 if id_f32 is None else id_f32).data_ptr() % 16 == 0,
                 "identity must be 16-byte aligned")
    out = torch.empty((m, cout), device=dev, dtype=torch.int8)

    def ptr(t):
        return None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        KERNEL.call(REQUANT_ENTRY,
                    features.data_ptr(), gather_idx.data_ptr(),
                    weight.data_ptr(), out_scale.data_ptr(), ptr(out_valid),
                    out.data_ptr(), n, m, k_taps, cin, cout,
                    k.data_ptr(), b.data_ptr(), ptr(row_valid), ptr(id_s8),
                    ptr(id_scale), ptr(id_f32), scale.data_ptr(),
                    torch.cuda.current_stream(dev).cuda_stream)
    KERNEL.launches[REQUANT_ENTRY] += 1
    return out


def sparse_gather_conv_requant(features, gather_idx, weight, out_scale, k, b,
                               scale, out_valid=None, row_valid=None,
                               identity=None, identity_scale=None, impl=None):
    """The s8 conv with the residency epilogue fused -> (M, Cout) int8.
    ``impl`` as in ``sparse_gather_conv``."""
    if impl is None:
        impl = "cuda" if features.is_cuda else "plain"
    fn = {"cuda": gather_conv_requant_cuda,
          "plain": gather_conv_requant_plain}.get(impl)
    if fn is None:
        raise ValueError(f"unknown impl {impl!r}")
    return fn(features, gather_idx, weight, out_scale, k, b, scale,
              out_valid, row_valid, identity, identity_scale)
