"""Sparse conv layers and the sparse BatchNorm (port of
``q3d_tpu/ops/spconv/modules.py``, float path).

Weights are stored as (K, Cin, Cout) with K enumerating kernel offsets
k0-major (x fastest), as ``engine.kernel_offsets`` does.  A per-forward
rulebook cache, keyed like the reference's ``subm_cache_key`` /
``down_cache_key``, lets every SubM layer of a stage share one book and
every strided conv build its output coordinates once.  Every conv runs on
``gather_conv.sparse_gather_conv``; ``kernel_impl`` selects "cuda" or
"plain" for the whole model (None = by the tensors' device).
"""

import math

import torch
from torch import nn

from . import engine
from .gather_conv import sparse_gather_conv
from .sparse_tensor import SparseConvTensor


def _fmt(v):
    return "x".join(str(int(x)) for x in v) if isinstance(v, (tuple, list)) \
        else str(int(v))


def subm_cache_key(indice_key, spatial_shape, kernel_size, dilation):
    return f"subm|{indice_key}|{_fmt(spatial_shape)}|{_fmt(kernel_size)}" \
           f"|{_fmt(dilation)}"


def down_cache_key(spatial_shape, kernel_size, stride, padding,
                   out_capacity):
    return f"down|{_fmt(spatial_shape)}|{_fmt(kernel_size)}|{_fmt(stride)}" \
           f"|{_fmt(padding)}|{out_capacity}"


class _SparseConvBase(nn.Module):
    ND = 3

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 padding=0, dilation=1, bias=False, indice_key=None):
        super().__init__()
        self.kernel_size = engine._tuplify(kernel_size, self.ND)
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.indice_key = indice_key
        k = math.prod(self.kernel_size)
        self.weight = nn.Parameter(torch.empty(k, in_channels, out_channels))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None
        self.kernel_impl = None

    def reset_parameters(self, generator):
        """U(-1/sqrt(fan_in), 1/sqrt(fan_in)), the reference's
        variance_scaling(1/3, fan_in, uniform); zero bias."""
        k, cin, _ = self.weight.shape
        bound = 1.0 / math.sqrt(k * cin)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def _conv(self, features, gather_idx, out_valid=None):
        return sparse_gather_conv(features, gather_idx,
                                  self.weight.to(features.dtype),
                                  out_valid=out_valid, impl=self.kernel_impl)


class SubMConv3d(_SparseConvBase):
    def forward(self, st: SparseConvTensor, rulebook_cache=None):
        key = subm_cache_key(self.indice_key or "", st.spatial_shape,
                             self.kernel_size, self.dilation)
        cache = {} if rulebook_cache is None else rulebook_cache
        if key not in cache:
            cache[key] = engine.subm_gather_indices(st, self.kernel_size,
                                                    self.dilation)
        out = self._conv(st.features, cache[key])
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        return st.replace(features=out)


class SparseConv3d(_SparseConvBase):
    def forward(self, st: SparseConvTensor, rulebook_cache=None,
                out_capacity=None):
        """out_capacity: static output voxel capacity (None = the input's);
        on overflow the highest-key voxels are dropped."""
        key = down_cache_key(st.spatial_shape, self.kernel_size, self.stride,
                             self.padding, out_capacity)
        cache = {} if rulebook_cache is None else rulebook_cache
        if key not in cache:
            cache[key] = engine.sparse_conv_downsample(
                st, self.kernel_size, self.stride, self.padding, out_capacity)
        out_indices, gather_idx, out_spatial = cache[key]
        out_valid = out_indices[:, 0] >= 0
        out = self._conv(st.features, gather_idx, out_valid=out_valid)
        if self.bias is not None:
            out = out + self.bias.to(out.dtype) * out_valid[:, None]
        return SparseConvTensor(features=out, indices=out_indices,
                                spatial_shape=out_spatial,
                                batch_size=st.batch_size, sorted_rows=True)


class SparseBatchNorm(nn.Module):
    """Eval-mode BatchNorm1d over sparse features:
    y = (x - mean) * rsqrt(var + eps) * weight + bias, in f32, returned in
    the features' dtype.  Padding rows are transformed too and stay unread."""

    def __init__(self, num_features, eps=1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, st: SparseConvTensor):
        x = st.features
        y = (x.float() - self.running_mean) \
            * torch.rsqrt(self.running_var + self.eps) * self.weight + self.bias
        return st.replace(features=y.to(x.dtype))
