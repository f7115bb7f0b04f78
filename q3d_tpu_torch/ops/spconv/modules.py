"""Sparse conv layers and the sparse BatchNorm (port of
``q3d_tpu/ops/spconv/modules.py``: the float path, the fake-quant path and
the int8 deploy path).

Weights are stored as (K, Cin, Cout) with K enumerating kernel offsets
k0-major (x fastest), as ``engine.kernel_offsets`` does.  A per-forward
rulebook cache, keyed like the reference's ``subm_cache_key`` /
``down_cache_key``, lets every SubM layer of a stage share one book and
every strided conv build its output coordinates once.  Every conv runs on
``gather_conv.sparse_gather_conv``; ``kernel_impl`` selects "cuda" or
"plain" for the whole model (None = by the tensors' device).

Under a fake-quant rule a conv quantize-dequantizes its masked features and
its weight and runs the float conv on them, on the same kernel as the float
path (``_fake_quantize``).  Under an int8-residency deploy rule (attached by
``quant.api.quantize_model``) a conv quantizes its features per tensor (or
takes int8 residency features as they are) and its f32 master weight per
output channel, runs the s8 GEMM and rescales by ``feat_scale * s_w``
(``_quantize``, reference :104-130).  Its block passes a ``Requant``
epilogue, and the conv emits int8 features with their ``feat_scale``,
through the fused s8 entry ``sparse_gather_conv_requant`` (or, while
calibrating, through the unfused s8 conv and ``requant_epilogue``, whose
quantizer needs the f32 values).  The quantized weight and the rescale are
computed once per calibrated model (``QuantLayer.constant``).
"""

import dataclasses
import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from ...quant.tensor_quant import QuantLayer, QuantSpec, memo, rescale
from . import engine
from .gather_conv import (epilogue_f32, sparse_gather_conv,
                          sparse_gather_conv_requant)
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


class Requant(NamedTuple):
    """A residency block's epilogue for its conv: the BN fold (y * k + b),
    the requant spec, and the residual input (or None)."""
    k: torch.Tensor
    b: torch.Tensor
    act_spec: QuantSpec
    identity: Optional[SparseConvTensor] = None


def requant_epilogue(layer, st, requant, name="out_quant"):
    """The residency epilogue in torch (reference ``requant_epilogue``,
    :397-416): y * k + b, + identity, ReLU, * valid, then per-tensor int8
    requant by ``layer``'s quantizer ``name``.  -> int8 tensor with its
    feat_scale."""
    ident = requant.identity
    y = epilogue_f32(st.features, requant.k, requant.b, st.valid,
                     None if ident is None else ident.features,
                     None if ident is None else ident.feat_scale)
    q, s = layer.quantize(name, requant.act_spec, y)
    return st.replace(features=q, feat_scale=s)


def dequantize_tensor(st: SparseConvTensor, dtype=torch.bfloat16):
    """Exit an int8-residency chain: real-valued features again (bf16 by
    default, as the reference's)."""
    if st.features.dtype == torch.int8 and st.feat_scale is not None:
        f = (st.features.float() * st.feat_scale).to(dtype)
        return st.replace(features=f, feat_scale=None)
    return st


class _SparseConvBase(QuantLayer, nn.Module):
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

    def _quantize(self, st):
        """-> (int8 features, int8 weight, out_scale (Cout,)): the
        reference's ``_quantize`` deploy branch (:104-130, :177-188).  int8
        residency features skip the act quantizer; otherwise pad rows are
        masked before the act amax.  The weight is quantized per output
        channel (axis 2 of (K, Cin, Cout)) from the f32 master, before any
        cast."""
        if st.features.dtype == torch.int8 and st.feat_scale is not None:
            features, s_act = st.features, st.feat_scale
        else:
            features, s_act = self.quantize(
                "act_quant", self.rule.act, st.features * st.valid[:, None])
        wspec = dataclasses.replace(self.rule.weight, axis=2)
        wq = self.constant("wq", (self.weight,), lambda: self.quantize(
            "weight_quant", wspec, self.weight)[0])
        out_scale = self.constant("out_scale", (s_act, self.weight),
                                  lambda: rescale(s_act, self.weight, 2,
                                                  not self.eager))
        return features, wq, out_scale

    def _fake_quantize(self, features, valid):
        """-> (features, f32 weight) quantize-dequantized: the reference's
        ``_quantize`` fake-quant branch (:130, :189-197).  Pad rows are
        masked before the act amax; the act is quantized per tensor, or per
        input channel under an ``axis=1`` spec (SmoothQuant recipes), the
        weight per output channel (axis 2 of (K, Cin, Cout))."""
        feats = self.fake_quantize("act_quant", self.rule.act,
                                   features * valid[:, None])
        wspec = self.rule.weight
        if wspec is not None and wspec.axis is not None:
            wspec = dataclasses.replace(wspec, axis=2)
        return feats, self.fake_quantize("weight_quant", wspec, self.weight)

    def _run(self, st, gather_idx, out_st, out_valid=None, requant=None):
        """The conv of ``st`` over ``gather_idx`` into the coordinates of
        ``out_st``: float without a rule (a residency input is dequantized
        first), float on fake-quantized features and weight under a
        fake-quant rule, else int8 with ``requant``, its block's residency
        epilogue."""
        if self.rule is None or self.fake:
            feats = dequantize_tensor(st).features
            weight = self.weight
            if self.fake:
                feats, weight = self._fake_quantize(feats, st.valid)
            out = sparse_gather_conv(feats, gather_idx,
                                     weight.to(feats.dtype), None,
                                     out_valid, impl=self.kernel_impl)
            if self.bias is not None:
                bias = self.bias.to(out.dtype)
                out = out + (bias if out_valid is None
                             else bias * out_valid[:, None])
            return out_st.replace(features=out, feat_scale=None)
        if requant is None:
            raise ValueError("an int8 sparse conv runs in a residency block, "
                             "which passes its Requant epilogue")
        if self.bias is not None:
            raise NotImplementedError("conv bias under int8 residency")
        feats, wq, out_scale = self._quantize(st)
        ident = requant.identity
        if self.calibrating:
            # the quantizer records the f32 values, so the unfused conv
            y = sparse_gather_conv(feats, gather_idx, wq, out_scale, out_valid,
                                   impl=self.kernel_impl)
            return requant_epilogue(self, out_st.replace(features=y), requant)
        s = self.quantizer("out_quant", requant.act_spec, feats).scale()
        q = sparse_gather_conv_requant(
            feats, gather_idx, wq, out_scale, requant.k, requant.b, s,
            out_valid=out_valid, row_valid=out_st.valid,
            identity=None if ident is None else ident.features,
            identity_scale=None if ident is None else ident.feat_scale,
            impl=self.kernel_impl)
        return out_st.replace(features=q, feat_scale=s)


class SubMConv3d(_SparseConvBase):
    QUANT_KIND = "subm_conv3d"

    def forward(self, st: SparseConvTensor, rulebook_cache=None,
                requant=None):
        key = subm_cache_key(self.indice_key or "", st.spatial_shape,
                             self.kernel_size, self.dilation)
        cache = {} if rulebook_cache is None else rulebook_cache
        if key not in cache:
            cache[key] = engine.subm_gather_indices(st, self.kernel_size,
                                                    self.dilation)
        return self._run(st, cache[key], st, requant=requant)


class SparseConv3d(_SparseConvBase):
    QUANT_KIND = "sparse_conv3d"

    def forward(self, st: SparseConvTensor, rulebook_cache=None,
                out_capacity=None, requant=None):
        """out_capacity: static output voxel capacity (None = the input's);
        on overflow the highest-key voxels are dropped."""
        key = down_cache_key(st.spatial_shape, self.kernel_size, self.stride,
                             self.padding, out_capacity)
        cache = {} if rulebook_cache is None else rulebook_cache
        if key not in cache:
            cache[key] = engine.sparse_conv_downsample(
                st, self.kernel_size, self.stride, self.padding, out_capacity)
        out_indices, gather_idx, out_spatial = cache[key]
        out_st = SparseConvTensor(features=st.features[:0],
                                  indices=out_indices,
                                  spatial_shape=out_spatial,
                                  batch_size=st.batch_size, sorted_rows=True)
        return self._run(st, gather_idx, out_st,
                         out_valid=out_indices[:, 0] >= 0, requant=requant)


class SparseBatchNorm(nn.Module):
    """Eval-mode BatchNorm1d over sparse features:
    y = (x - mean) * rsqrt(var + eps) * weight + bias, in f32, returned in
    the features' dtype, or in f32 when ``out_f32`` is set (an int8 deploy
    model: the reference's BN promotes a bf16 input with its f32
    parameters).  Padding rows are transformed too and stay unread."""

    def __init__(self, num_features, eps=1e-3):
        super().__init__()
        self.eps = eps
        self.out_f32 = False
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
        return st.replace(features=y if self.out_f32 else y.to(x.dtype))

    def fold(self):
        """The eval affine as (k, b), y = x * k + b, for a conv epilogue
        (reference fold mode, :500-502), computed once per set of BN
        parameters."""
        def compute():
            k = torch.rsqrt(self.running_var + self.eps) * self.weight
            return k, self.bias - self.running_mean * k
        return memo(self, "fold", (self.running_var, self.weight, self.bias,
                                   self.running_mean), compute)
