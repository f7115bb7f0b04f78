"""Sparse conv layers and the sparse BatchNorm (port of
``q3d_tpu/ops/spconv/modules.py``: the float path, the fake-quant path and
the int8 deploy path; BN's train mode).

The 3D kinds (``SubMConv3d``, ``SparseConv3d``) and the 2D ones
(``SubMConv2d``, ``SparseConv2d``, VoxelNeXt's BEV convs and head) share
one nd-generic body.  Weights are stored as (K, Cin, Cout) with K
enumerating kernel offsets k0-major (x fastest), as
``engine.kernel_offsets`` does.  A per-forward rulebook cache, keyed
like the reference's ``subm_cache_key`` / ``down_cache_key``, lets every
SubM layer of a stage share one book and every strided conv build its
output coordinates once; a book's inverse, which a float conv's input
gradient runs over, is kept beside it.  Every
conv runs on ``gather_conv.sparse_gather_conv``; ``kernel_impl`` selects
"cuda" or "plain" for the whole model (None = by the tensors' device).
The one exception is a SubM conv with a 1x1 kernel (VoxelNeXt's head
convs): the reference sends every conv whose last kernel dimension is not
3 to its XLA gather-GEMM, never to the Pallas kernel
(``q3d_tpu/ops/spconv/engine.py:427-433``), and kernel 1 has no instance
for their 1-3 output channels, so such a conv is the plain product
``(features * valid) @ W[0]`` (``pointwise_conv``: ``torch.matmul``, or the
exact s8 product of ``models.layers.int8_matmul`` under an int8 rule),
chosen from the conv's shape and counted in ``POINTWISE_CALLS``.

Under a fake-quant rule a conv quantize-dequantizes its masked features and
its weight and runs the float conv on them, on the same kernel as the float
path (``_fake_quantize``).  Under an int8 deploy rule (attached by
``quant.api.quantize_model``) a conv quantizes its masked features per
tensor, with the batch's amax or the calibrated one (or takes int8
residency features as they are), and its f32 master weight per output
channel, runs the s8 GEMM (kernel 1's unfused s8 entry) and rescales by
``s_act * s_w`` (``_quantize``, reference :104-130, :177-190).  Without
residency it hands the f32 result (+ bias) to its block's float BN and
ReLU.  Under residency its block passes a ``Requant`` epilogue, and the
conv emits int8 features with their ``feat_scale``, through the fused s8
entry ``sparse_gather_conv_requant`` (or, while
calibrating, through the unfused s8 conv and ``requant_epilogue``, whose
quantizer needs the f32 values).  The quantized weight and the rescale are
computed once per calibrated model (``QuantLayer.constant``).

Under a fake-quant rule with SmoothQuant (VoxelNeXt's sparse 2D convs) a
conv migrates scale per column of its gather view, as the reference's
``gemm_transform`` does (:131-179, its ``SQSubM2d``): ``_smoothquant_conv``
builds the (M, K*Cin) matrix of the masked features gathered over the
book, and ``QuantLayer.smoothquant_matmul``, which the dense SmoothQuant
conv shares, divides it by the column scale, fake-quantizes it and the
scaled weight and runs one ``torch.matmul``.  The reference never sends such a
conv to its Pallas kernel (``pallas_conv.py:402-406``), so neither does
the port.
"""

import collections
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


# the 1x1 SubM convs' products (``pointwise_conv``), by route: "float"
# (torch.matmul) or "int8" (the exact s8 product)
POINTWISE_CALLS = collections.Counter()


def pointwise_conv(features, valid, weight, out_scale=None, impl=None):
    """A SubM conv with a 1x1 kernel: ``(features * valid) @ weight`` over
    the (M, Cin) rows, the reference's ``engine.gather_conv`` on its (M, 1)
    book (a pad row misses and reads zeros).  Float features multiply in
    their dtype (``torch.matmul``); s8 features take the exact s32 product
    (``models.layers.int8_matmul``, ``impl`` as there), scaled by
    ``out_scale`` to f32, as kernel 1's s8 entry returns.  Counted in
    ``POINTWISE_CALLS``."""
    masked = torch.where(valid[:, None], features,
                         torch.zeros((), dtype=features.dtype,
                                     device=features.device))
    if features.dtype == torch.int8:
        from ...models.layers import int8_matmul
        POINTWISE_CALLS["int8"] += 1
        acc = int8_matmul(masked.contiguous(), weight.t().contiguous().t(),
                          impl, tag="sparse_pointwise")
        return acc.float() * out_scale.reshape(1, -1)
    POINTWISE_CALLS["float"] += 1
    return torch.matmul(masked, weight.to(features.dtype))


def _cached_inverse(cache, key, gather_idx, n):
    """-> a function returning the inverse of the book ``gather_idx`` over
    ``n`` input rows, built once per forward and kept in the rulebook cache
    beside the forward book (every SubM conv of a stage shares it)."""
    def inverse():
        inv_key = key + "|inverse"
        if inv_key not in cache:
            cache[inv_key] = engine.inverse_book(gather_idx, n)
        return cache[inv_key]
    return inverse


class _SparseConvBase(QuantLayer, nn.Module):
    ND = 3
    SUBM = False

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

    @property
    def pointwise(self):
        """True for a SubM conv with a 1x1 kernel (``pointwise_conv``)."""
        return self.SUBM and all(int(k) == 1 for k in self.kernel_size)

    def _fake_quantize(self, features, valid):
        """-> (features, f32 weight) quantize-dequantized: the reference's
        ``_quantize`` fake-quant branch (:130, :189-197).  Pad rows are
        masked before the act amax; the act is quantized per tensor, or per
        input channel under an ``axis=1`` spec (SmoothQuant recipes), the
        weight per output channel (axis 2 of (K, Cin, Cout))."""
        feats = self.fake_quantize("act_quant", self.rule.act,
                                   features * valid[:, None])
        return feats, self.fake_quantize("weight_quant", self.weight_spec(2),
                                         self.weight)

    def _smoothquant_conv(self, st, gather_idx, out_valid):
        """The gather-view SmoothQuant conv (the reference's
        ``gemm_transform``, :131-179): G, the masked features gathered over
        the book (``engine.gather_view``, (M, K*Cin) in f32, columns k-major,
        c-minor), and the (K*Cin, Cout) weight through
        ``QuantLayer.smoothquant_matmul``, masked by ``out_valid``, in the
        features' dtype."""
        feats = dequantize_tensor(st).features
        g = engine.gather_view(feats.float() * st.valid[:, None],
                               gather_idx)
        k, cin, cout = self.weight.shape
        out = self.smoothquant_matmul(g, self.weight.reshape(k * cin, cout))
        if out_valid is not None:
            out = out * out_valid[:, None]
        return out.to(feats.dtype)

    def _conv(self, feats, gather_idx, weight, out_scale, out_valid, valid,
              inverse):
        """Kernel 1 over the book, or, for a 1x1 SubM conv (no book),
        ``pointwise_conv`` over the rows ``valid`` marks."""
        if gather_idx is None:
            return pointwise_conv(feats, valid, weight[0], out_scale,
                                  impl=self.kernel_impl)
        return sparse_gather_conv(feats, gather_idx, weight, out_scale,
                                  out_valid, impl=self.kernel_impl,
                                  inverse=inverse)

    def _run(self, st, gather_idx, out_st, out_valid=None, requant=None,
             inverse=None):
        """The conv of ``st`` over ``gather_idx`` (None: a 1x1 SubM conv)
        into the coordinates of ``out_st``: float without a rule (a
        residency input is dequantized first), float on fake-quantized
        features and weight under a fake-quant rule (SmoothQuant: the
        gather view), int8 with f32 output (+ bias) under an int8 deploy
        rule without residency, else int8 with ``requant``, its block's
        residency epilogue.  ``inverse`` returns the book's inverse, which
        the float conv's input gradient runs over."""
        if requant is None:
            if self.fake and self.rule.smoothquant is not None:
                out = self._smoothquant_conv(st, gather_idx, out_valid)
            else:
                out_scale = None
                if self.rule is None or self.fake:
                    feats = dequantize_tensor(st).features
                    weight = self.weight
                    if self.fake:
                        feats, weight = self._fake_quantize(feats, st.valid)
                    weight = weight.to(feats.dtype)
                else:
                    feats, weight, out_scale = self._quantize(st)
                out = self._conv(feats, gather_idx, weight, out_scale,
                                 out_valid, st.valid, inverse)
            if self.bias is not None:
                bias = self.bias.to(out.dtype)
                out = out + (bias if out_valid is None
                             else bias * out_valid[:, None])
            return out_st.replace(features=out, feat_scale=None)
        if self.bias is not None or gather_idx is None:
            raise NotImplementedError("a conv bias or a 1x1 SubM conv under "
                                      "int8 residency")
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


class _SubMConv(_SparseConvBase):
    SUBM = True

    def forward(self, st: SparseConvTensor, rulebook_cache=None,
                requant=None):
        if self.pointwise:
            return self._run(st, None, st, requant=requant)
        key = subm_cache_key(self.indice_key or "", st.spatial_shape,
                             self.kernel_size, self.dilation)
        cache = {} if rulebook_cache is None else rulebook_cache
        if key not in cache:
            cache[key] = engine.subm_gather_indices(st, self.kernel_size,
                                                    self.dilation)
        return self._run(st, cache[key], st, requant=requant,
                         inverse=_cached_inverse(cache, key, cache[key],
                                                 st.capacity))


class _SparseConv(_SparseConvBase):
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
                         out_valid=out_indices[:, 0] >= 0, requant=requant,
                         inverse=_cached_inverse(cache, key, gather_idx,
                                                 st.capacity))


class SubMConv3d(_SubMConv):
    QUANT_KIND = "subm_conv3d"


class SparseConv3d(_SparseConv):
    QUANT_KIND = "sparse_conv3d"


class SubMConv2d(_SubMConv):
    ND = 2
    QUANT_KIND = "subm_conv2d"


class SparseConv2d(_SparseConv):
    ND = 2
    QUANT_KIND = "sparse_conv2d"


class SparseBatchNorm(nn.Module):
    """BatchNorm1d over sparse features (reference ``SparseBatchNorm``,
    :474-517): y = (x - mean) * rsqrt(var + eps) * weight + bias, in f32,
    returned in the features' dtype, or in f32 when ``out_f32`` is set (an
    int8 deploy model: the reference's BN promotes a bf16 input with its f32
    parameters).

    In eval mode mean and var are the running statistics, and padding rows
    are transformed too and stay unread.  In train mode (``nn.Module.
    training``) they are the batch's, masked to the valid rows (the
    reference's spconv tensors hold no padding), the variance in two passes;
    the running mean and variance move by ``MOMENTUM``, the variance
    corrected by n / (n - 1)."""

    MOMENTUM = 0.01    # the reference's (q3d_tpu/ops/spconv/modules.py:482)

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
        mean, var = self.running_mean, self.running_var
        if self.training:
            mean, var = self._batch_stats(x.float(), st.valid)
        y = (x.float() - mean) * torch.rsqrt(var + self.eps) * self.weight \
            + self.bias
        return st.replace(features=y if self.out_f32 else y.to(x.dtype))

    def _batch_stats(self, x, valid):
        """The valid rows' mean and (biased, two-pass) variance; the running
        statistics updated as the reference's are."""
        n = valid.sum().clamp_min(1).to(x.dtype)
        vm = valid[:, None].to(x.dtype)
        mean = (x * vm).sum(0) / n
        var = (((x - mean) ** 2) * vm).sum(0) / n
        with torch.no_grad():
            m = self.MOMENTUM
            self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
            self.running_var.copy_((1 - m) * self.running_var
                                   + m * var * n / torch.clamp_min(n - 1, 1))
        return mean, var

    def fold(self):
        """The eval affine as (k, b), y = x * k + b, for a conv epilogue
        (reference fold mode, :500-502), computed once per set of BN
        parameters."""
        def compute():
            k = torch.rsqrt(self.running_var + self.eps) * self.weight
            return k, self.bias - self.running_mean * k
        return memo(self, "fold", (self.running_var, self.weight, self.bias,
                                   self.running_mean), compute)
