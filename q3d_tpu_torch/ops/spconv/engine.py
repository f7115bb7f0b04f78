"""Sparse-convolution rulebooks + the plain gather-GEMM.

Port of the rulebook builders of ``q3d_tpu/ops/spconv/engine.py``, in torch
on the tensor's device:

  * a rulebook is an (M, K) int32 gather-index matrix into the input rows;
    K enumerates the kernel offsets k0-major (x fastest, the layout of the
    (K, Cin, Cout) weights) and a miss is the input capacity N;
  * strided convs generate their output coordinates with spconv semantics
    (an output exists iff some kernel tap hits an input voxel), kept as the
    ascending unique keys with the lowest ``out_capacity`` kept on
    overflow — the reference's exact rule.

The reference's chunk tables (``chunk_anchor_code``, ``subm_chunk_indices``,
probe stacks, ``x_window_matrix``) only feed the TPU's one-hot span gather;
the Hopper kernel gathers rows by index from the direct table, so they have
no counterpart here.  ``gather_conv`` is the plain PyTorch version of the
sparse conv that ``gather_conv.sparse_gather_conv`` runs as a CUDA kernel.
"""

import itertools

import numpy as np
import torch

from .sparse_tensor import SparseConvTensor, linearize, BIG_KEY


def _tuplify(v, nd):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * nd


def kernel_offsets(kernel_size, nd):
    """Kernel offsets in the weight layout order (Cout, k0, k1, ..., Cin):
    k0-major."""
    ks = _tuplify(kernel_size, nd)
    return np.array(list(itertools.product(*[range(k) for k in ks])),
                    dtype=np.int64), ks


def out_spatial_shape(spatial_shape, kernel_size, stride, padding):
    nd = len(spatial_shape)
    ks = _tuplify(kernel_size, nd)
    s = _tuplify(stride, nd)
    p = _tuplify(padding, nd)
    return tuple((int(spatial_shape[d]) + 2 * int(p[d]) - int(ks[d]))
                 // int(s[d]) + 1 for d in range(nd))


def _in_bounds(coords, shape):
    lim = torch.as_tensor(shape, dtype=coords.dtype, device=coords.device)
    return ((coords >= 0) & (coords < lim)).all(-1)


def _query(st, batch_col, coords, ok):
    """Look up (R, K, nd) coordinates of batch ``batch_col`` (R, 1) in ``st``;
    entries with ``ok`` False miss.  -> (R, K) int32 row ids."""
    r, k, nd = coords.shape
    b = batch_col[:, None, :].expand(r, k, 1)
    q = torch.cat([b, coords], dim=-1).reshape(-1, 1 + nd)
    qkeys = linearize(q, st.spatial_shape)
    qkeys = torch.where(ok.reshape(-1), qkeys, torch.full_like(qkeys, BIG_KEY))
    return st.lookup(qkeys).reshape(r, k)


def subm_gather_indices(st: SparseConvTensor, kernel_size, dilation=1):
    """Rulebook for submanifold conv (out coords == in coords): (N, K) int32."""
    nd = len(st.spatial_shape)
    offsets, ks = kernel_offsets(kernel_size, nd)
    dil = np.array(_tuplify(dilation, nd), np.int64)
    center = np.array([(k - 1) // 2 for k in ks], np.int64)
    rel = torch.as_tensor((offsets - center) * dil, device=st.indices.device)
    coords = st.indices.long()
    q = coords[:, None, 1:] + rel[None]                          # (N, K, nd)
    ok = _in_bounds(q, st.spatial_shape) & st.valid[:, None]
    return _query(st, coords[:, 0:1], q, ok)


def _decode_keys(keys, spatial_shape):
    rem = keys
    parts = []
    for s in reversed([int(s) for s in spatial_shape]):
        parts.append(rem % s)
        rem = rem // s
    parts.append(rem)                                            # batch
    out = torch.stack(list(reversed(parts)), dim=1)
    out = torch.where((keys == BIG_KEY)[:, None], torch.full_like(out, -1), out)
    return out.to(torch.int32)


def downsample_out_keys(st: SparseConvTensor, kernel_size, stride, padding,
                        out_capacity=None):
    """Output coordinates of a strided SparseConvNd: -> (out_indices (M, 1+nd)
    int32, ascending keys, -1 padded; out_spatial)."""
    nd = len(st.spatial_shape)
    ks = _tuplify(kernel_size, nd)
    dev = st.indices.device
    s = torch.as_tensor(_tuplify(stride, nd), dtype=torch.int64, device=dev)
    p = torch.as_tensor(_tuplify(padding, nd), dtype=torch.int64, device=dev)
    out_spatial = out_spatial_shape(st.spatial_shape, kernel_size, stride,
                                    padding)
    m = out_capacity or st.capacity
    # candidate outputs of input i per dim: floor((i+p)/s) - delta for
    # delta < ceil(k/s), kept when the tap (i+p) - s*o lies inside the kernel
    deltas = torch.as_tensor(list(itertools.product(
        *[range((int(ks[d]) - 1) // int(_tuplify(stride, nd)[d]) + 1)
          for d in range(nd)])), dtype=torch.int64, device=dev)
    coords = st.indices.long()
    ip = coords[:, None, 1:] + p                                 # (N, 1, nd)
    o = torch.div(ip, s, rounding_mode="floor") - deltas[None]   # (N, Kc, nd)
    tap = ip - o * s
    hit = ((tap >= 0) & (tap < torch.as_tensor(ks, device=dev))).all(-1)
    ok = hit & _in_bounds(o, out_spatial) & st.valid[:, None]
    b = coords[:, None, 0:1].expand(*o.shape[:2], 1)
    ckeys = linearize(torch.cat([b, o], -1).reshape(-1, 1 + nd), out_spatial)
    ckeys = ckeys[ok.reshape(-1)]
    uniq = torch.unique(ckeys)[:m]                               # ascending
    out_keys = torch.full((m,), BIG_KEY, dtype=torch.int64, device=dev)
    out_keys[:uniq.numel()] = uniq
    return _decode_keys(out_keys, out_spatial), out_spatial


def sparse_conv_downsample(st: SparseConvTensor, kernel_size, stride, padding,
                           out_capacity=None):
    """Output coordinates + rulebook of a strided SparseConvNd.

    Returns (out_indices (M, 1+nd) int32, gather_idx (M, K) int32,
    out_spatial tuple)."""
    nd = len(st.spatial_shape)
    out_indices, out_spatial = downsample_out_keys(
        st, kernel_size, stride, padding, out_capacity)
    offsets, _ = kernel_offsets(kernel_size, nd)
    dev = st.indices.device
    s = torch.as_tensor(_tuplify(stride, nd), dtype=torch.int64, device=dev)
    p = torch.as_tensor(_tuplify(padding, nd), dtype=torch.int64, device=dev)
    oc = out_indices.long()
    # input of output o at offset k: i = o*s - p + k
    icoord = oc[:, None, 1:] * s - p + torch.as_tensor(offsets, device=dev)[None]
    ok = _in_bounds(icoord, st.spatial_shape) & (oc[:, 0:1] >= 0)
    return out_indices, _query(st, oc[:, 0:1], icoord, ok), out_spatial


def inverse_book(gather_idx, n):
    """The inverse of an (M, K) book over N input rows: the (N, K) int32
    book with inv[g[m, k], k] = m and -1 where no output row reads input
    row n at tap k, built by one scatter.  A SubM or strided conv reads each
    (n, k) from at most one output row, so the inverse is a plain gather
    book, and the input gradient of the conv is the conv of the output
    gradient over it with the weights transposed per tap."""
    m, k = gather_idx.shape
    dev = gather_idx.device
    g = gather_idx.long()
    taps = torch.arange(k, device=dev)
    # misses write to one sink slot past the end, which is dropped
    flat = torch.where((g >= 0) & (g < n), g * k + taps, n * k)
    rows = torch.arange(m, dtype=torch.int32, device=dev)[:, None].expand(m, k)
    inv = torch.full((n * k + 1,), -1, dtype=torch.int32, device=dev)
    inv.scatter_(0, flat.reshape(-1), rows.reshape(-1))
    return inv[:n * k].view(n, k)


def weight_grad(features, gather_idx, grad_out):
    """dW[k] = sum_m f[g[m, k]]^T grad_out[m] -> (K, Cin, Cout) f32: per tap,
    the tap's rows gathered (a miss reads the zero row) and one f32
    ``torch.matmul``.  The (M, K*Cin) gather of the forward's plain version
    is never built: at ref width it would take ~4.4 GB per 128-wide conv."""
    n, cin = features.shape
    m, k = gather_idx.shape
    padded = torch.cat([features.float(),
                        features.new_zeros((1, cin), dtype=torch.float32)])
    idx = gather_idx.long()
    idx = torch.where((idx >= 0) & (idx < n), idx, torch.full_like(idx, n))
    g = grad_out.float()
    dw = g.new_empty((k, cin, g.shape[1]))
    for t in range(k):
        torch.matmul(padded.index_select(0, idx[:, t]).t(), g, out=dw[t])
    return dw


# the CPU gather view's storage, kept from one conv to the next by dtype: a
# fresh (M, K*Cin) tensor a conv spends most of the gather faulting in new
# pages (4-5x the gather into a kept buffer, on this repository's tests)
_GATHER_SCRATCH = {}


def gather_view(features, gather_idx):
    """The (M, K*Cin) matrix of ``features`` gathered over the book
    ``gather_idx`` (None: a 1x1 SubM conv's rows as they are), columns
    k-major, c-minor; a miss reads a zero row.  On the CPU with gradients
    off, the matrix lives in a buffer that the next call overwrites: the
    caller uses it before gathering again (with gradients on, autograd may
    keep it for the backward)."""
    if gather_idx is None:
        return features
    n, cin = features.shape
    m, k = gather_idx.shape
    padded = torch.cat([features, features.new_zeros((1, cin))])
    idx = gather_idx.long()
    idx = torch.where((idx >= 0) & (idx < n), idx, torch.full_like(idx, n))
    if features.is_cuda or torch.is_grad_enabled():
        return padded.index_select(0, idx.reshape(-1)).reshape(m, k * cin)
    buf = _GATHER_SCRATCH.get(features.dtype)
    if buf is None or buf.numel() < m * k * cin:
        buf = _GATHER_SCRATCH[features.dtype] = torch.empty(
            m * k * cin, dtype=features.dtype)
    out = buf[:m * k * cin].view(m * k, cin)
    torch.index_select(padded, 0, idx.reshape(-1), out=out)
    return out.view(m, k * cin)


# the s8 product's columns per f32 GEMM: every partial sum of 1024 s8 x s8
# products is an integer below 2^24, so f32 holds it exactly
_S8_CHUNK = 1024
# an s32 sum of K s8 x s8 products is exact while K * 127^2 < 2^31
_S32_MAX_K = (2 ** 31 - 1) // 127 ** 2


def s8_matmul_exact(a, b):
    """s8 (M, K) x s8 (K, N) -> the exact integer product as f64 (M, N).
    CPU tensors: one ``torch._int_mm`` (s32 sums, exact for K below
    133,143; ~4x faster than the f32 chunks on the CPU).  Otherwise f32
    GEMMs over chunks of 1024 columns, each exact, their sums added in f64
    (the same integers as one f64 GEMM, 1.5-2x faster on the CPU); on the
    card this keeps the plain version off ``torch._int_mm``, the library
    route ``models.layers.int8_matmul`` is held against."""
    if not a.is_cuda and a.shape[1] <= _S32_MAX_K:
        return torch._int_mm(a, b).double()
    out = None
    for c0 in range(0, a.shape[1], _S8_CHUNK):
        part = (a[:, c0:c0 + _S8_CHUNK].float()
                @ b[c0:c0 + _S8_CHUNK].float()).double()
        out = part if out is None else out + part
    return out


def gather_conv(features, gather_idx, weight, out_scale=None, out_valid=None):
    """Plain PyTorch sparse conv: features (N, Cin), gather_idx (M, K) with
    misses outside [0, N), weight (K, Cin, Cout) -> (M, Cout).

    out[m] = (sum_k f[idx[m, k]] @ W[k]) * out_scale * out_valid[m], as one
    (M, K*Cin) @ (K*Cin, Cout) GEMM.  Float inputs accumulate in f32 and
    return the input dtype; s8 inputs accumulate exactly and return f32,
    like the s32 kernel (``s8_matmul_exact``)."""
    if features.dtype == torch.int8 and not features.is_cuda:
        # on the CPU only the rows with a present tap: the others' exact
        # sums are 0 (most of a deep stage's rows are padding)
        n = features.shape[0]
        rows = ((gather_idx >= 0) & (gather_idx < n)).any(1).nonzero()[:, 0]
        g = gather_view(features, gather_idx.index_select(0, rows))
        out = torch.zeros((gather_idx.shape[0], weight.shape[-1]))
        out[rows] = s8_matmul_exact(g, weight.reshape(g.shape[1], -1)).float()
    elif features.dtype == torch.int8:
        g = gather_view(features, gather_idx)
        out = s8_matmul_exact(g, weight.reshape(g.shape[1], -1)).float()
    else:
        g = gather_view(features.float(), gather_idx)
        out = g @ weight.float().reshape(g.shape[1], -1)
    if out_scale is not None:
        out = out * out_scale.reshape(-1)
    if out_valid is not None:
        out = out * out_valid.reshape(-1, 1).float()
    return out.to(torch.float32 if features.dtype == torch.int8
                  else features.dtype)
