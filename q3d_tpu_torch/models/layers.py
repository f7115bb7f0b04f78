"""Dense NCHW building blocks of the CenterPoint path (port of
``q3d_tpu/models/layers.py``: the float path, the fake-quant and SmoothQuant
paths, and the int8 deploy path).

Precision follows the reference (``layers.py:167-201``): the input stays in
the compute dtype, weights are cast to it, and the convolution accumulates
in f32 (cuDNN does so for bf16 inputs; f32 comparisons must turn TF32 off).
The dense convs are library calls, as the reference leaves them to XLA.

Under a fake-quant rule a ``Conv2d`` quantize-dequantizes its weight (per
output channel) and its input (per tensor) and runs the float conv; with
SmoothQuant it runs ``_smoothquant_conv`` (im2col, per-column scale
migration, fake-quant, ``torch.matmul``).
Under an int8-residency deploy rule a ``Conv2d`` quantizes first (per
tensor; a ``QTensor`` input is int8 already) and runs ``int8_conv2d``, an
s8 x s8 -> s32 conv (im2col of the NHWC int8 map, then ``torch._int_mm`` on
the card; the reference's is XLA's native s8 conv, not a Pallas kernel),
rescales by ``s_act * s_w`` and hands back the raw f32 (+ bias) for its
block's ``requant_epilogue``; blocks pass int8 ``QTensor``s from conv to
conv.  The quantized weight, the rescale and the BN folds are computed once
per calibrated model (``quant.tensor_quant.memo``).  The int8 maps are
NCHW-shaped views of NHWC (channels-last) memory, the layout the patch GEMM
reads and writes.
"""

import collections
import dataclasses
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..quant.tensor_quant import QuantLayer, memo, rescale

# int8_conv2d calls through torch._int_mm (a library GEMM, counted so that a
# run can show the int8 path went through it)
INT_MM_CALLS = collections.Counter()


class QTensor(NamedTuple):
    """Dense int8-residency carrier: ``data`` (int8, NCHW-shaped) with its
    dequantization ``scale`` (f32; ``data * scale`` is the real value)."""
    data: torch.Tensor
    scale: torch.Tensor


def dequantize(x, dtype=torch.bfloat16):
    """Exit a dense int8-residency chain: real values again (bf16 by
    default, as the reference's)."""
    if isinstance(x, QTensor):
        return (x.data.float() * x.scale).to(dtype)
    return x


def requant_epilogue(layer, y, k, b, act_spec, identity=None,
                     name="out_quant"):
    """The dense residency epilogue (reference :80-95): y * k + b (BN
    fold), + identity, ReLU, then per-tensor int8 requant by ``layer``'s
    quantizer ``name`` -> QTensor.  No row mask (dense maps have no pads)."""
    c = (1, -1, 1, 1)
    y = y.float() * k.reshape(c) + b.reshape(c)
    if identity is not None:
        y = y + dequantize(identity, torch.float32)
    y = torch.relu(y)
    return QTensor(*layer.quantize(name, act_spec, y))


def _patches(x, kernel_size, stride, padding):
    """im2col of an NCHW-shaped int8 map: (B*Ho*Wo, kh*kw*C), columns in
    (kh, kw, C) order (the HWIO weight's), copied once from a strided
    window view of the padded NHWC map (PyTorch's unfold has no int8
    kernel)."""
    (kh, kw), (sh, sw), (ph, pw) = kernel_size, stride, padding
    xp = F.pad(x.permute(0, 2, 3, 1), (0, 0, pw, pw, ph, ph))
    b, hp, wp, c = xp.shape
    ho, wo = (hp - kh) // sh + 1, (wp - kw) // sw + 1
    s_b, s_h, s_w, s_c = xp.stride()
    win = xp.as_strided((b, ho, wo, kh, kw, c),
                        (s_b, s_h * sh, s_w * sw, s_h, s_w, s_c))
    return win.reshape(b * ho * wo, kh * kw * c), (b, ho, wo)


def int8_conv2d(x, w, stride, padding, impl=None):
    """s8 x s8 -> s32 conv: x (B, C, H, W) int8, w (O, C, kh, kw) int8 ->
    (B, O, Ho, Wo) int32, an NCHW-shaped view of NHWC memory.

    ``impl``: "cuda" (``torch._int_mm``), "plain" (an exact product: int32
    on the CPU, f64 on the card, where |sum| <= kh*kw*C*127^2 < 2^53), or
    None = by the tensors' device."""
    if impl is None:
        impl = "cuda" if x.is_cuda else "plain"
    a, (b, ho, wo) = _patches(x, w.shape[2:], stride, padding)
    wm = w.permute(0, 2, 3, 1).reshape(w.shape[0], -1)        # (O, kh*kw*C)
    if impl == "cuda":
        if not (x.is_cuda and a.shape[0] > 16 and a.shape[1] % 8 == 0
                and wm.shape[0] % 8 == 0):
            raise ValueError(
                f"int8_conv2d: _int_mm needs CUDA tensors, M > 16 and K, N "
                f"multiples of 8 (got {tuple(a.shape)} x {tuple(wm.shape)})")
        out = torch._int_mm(a, wm.t())
        INT_MM_CALLS["int8_conv2d"] += 1
    elif impl == "plain":
        acc = torch.int32 if a.device.type == "cpu" else torch.float64
        out = (a.to(acc) @ wm.t().to(acc)).to(torch.int32)
    else:
        raise ValueError(f"unknown impl {impl!r}")
    return out.view(b, ho, wo, -1).permute(0, 3, 1, 2)


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


class Conv2d(QuantLayer, nn.Module):
    """2D conv, OIHW weight; bias initialised to ``bias_init``."""
    QUANT_KIND = "conv2d"

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, bias=True, bias_init=0.0):
        super().__init__()
        self.kernel_impl = None
        kh, kw = _pair(kernel_size)
        self.stride = _pair(stride)
        self.padding = _pair(padding)
        self.bias_init = bias_init
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kh, kw))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None

    def reset_parameters(self, generator):
        """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (the reference's
        variance_scaling(1/3, fan_in, uniform)); bias = bias_init."""
        bound = 1.0 / math.sqrt(self.weight[0].numel())
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            if self.bias is not None:
                self.bias.fill_(self.bias_init)

    def forward(self, x):
        if self.rule is None or self.fake:
            # float (a residency chain feeding a float layer is dequantized
            # first), on fake-quantized inputs under a fake-quant rule
            x = dequantize(x)
            if self.fake and self.rule.smoothquant is not None:
                y = self._smoothquant_conv(x)
                y = y if self.bias is None else y + self.bias.reshape(1, -1, 1, 1)
                return y.to(x.dtype)
            w = self.weight
            if self.fake:
                wspec = self.rule.weight
                if wspec is not None and wspec.axis is not None:
                    wspec = dataclasses.replace(wspec, axis=0)
                w = self.fake_quantize("weight_quant", wspec, w)
                x = self.fake_quantize("act_quant", self.rule.act, x)
            bias = None if self.bias is None else self.bias.to(x.dtype)
            return F.conv2d(x, w.to(x.dtype), bias, self.stride, self.padding)
        # int8 residency: the raw f32 (+ bias) for the caller's epilogue
        y = self._int8_conv(x)
        return y if self.bias is None else y + self.bias.reshape(1, -1, 1, 1)

    def _smoothquant_conv(self, x):
        """im2col + SmoothQuant scale migration + fake-quant + GEMM (the
        reference's ``_smoothquant_conv``, :265-308): the columns of
        ``F.unfold`` are in (cin, kh, kw) order, as the reference's patches;
        per column, scale = max(act_amax^alpha / w_amax^(1-alpha), 1e-5),
        with act_amax the batch's (dynamic) or the calibrated
        ``sq_act_amax`` (static); then the act is fake-quantized per tensor,
        the weight per output channel, and one f32 GEMM (the reference's
        ``einsum``, outside any Pallas kernel) -> (B, O, Ho, Wo)."""
        o, _, kh, kw = self.weight.shape
        b, _, h, w_ = x.shape
        (sh, sw), (ph, pw) = self.stride, self.padding
        ho, wo = (h + 2 * ph - kh) // sh + 1, (w_ + 2 * pw - kw) // sw + 1
        patches = F.unfold(x, (kh, kw), padding=self.padding,
                           stride=self.stride).transpose(1, 2)   # (B, L, K)
        w2d = self.weight.reshape(o, -1).t()                      # (K, O)
        sq = self.rule.smoothquant
        w_amax = w2d.abs().amax(1).clamp_min(1e-5)
        if sq.dynamic:
            a_amax = patches.abs().amax((0, 1)).clamp_min(1e-5)
        else:
            if self.calibrating:
                if not hasattr(self, "sq_act_amax"):
                    # the reference's quant/sq_act_amax (ones until
                    # committed) and calib/sq_act_absmax
                    self.register_buffer("sq_act_amax", torch.ones(
                        w2d.shape[0], device=x.device))
                    self.register_buffer("sq_act_absmax", torch.zeros(
                        w2d.shape[0], device=x.device), persistent=False)
                self.sq_act_absmax = torch.maximum(
                    self.sq_act_absmax, patches.detach().abs().amax((0, 1)))
            elif not hasattr(self, "sq_act_amax"):
                raise RuntimeError("a static SmoothQuant conv was never "
                                   "calibrated: run quant.api.quantize_model")
            a_amax = self.sq_act_amax.clamp_min(1e-5)
        scale = torch.clamp_min(torch.pow(a_amax, sq.alpha)
                                / torch.pow(w_amax, 1.0 - sq.alpha),
                                1e-5).detach()
        p = self.fake_quantize("act_quant", self.rule.act, patches / scale)
        wspec = self.rule.weight
        if wspec is not None and wspec.axis is not None:
            wspec = dataclasses.replace(wspec, axis=1)
        wq = self.fake_quantize("weight_quant", wspec, w2d * scale[:, None])
        y = torch.matmul(p, wq.to(p.dtype))                       # (B, L, O)
        return y.transpose(1, 2).reshape(b, o, ho, wo)

    def _int8_conv(self, x):
        """The reference's quantize-first ``_int8_conv`` (:237-253): int8
        input (quantized here, or a QTensor), weight per output channel
        (axis 3 of the reference's HWIO, 0 of OIHW) from the f32 master, s32
        conv, then out * (s_act * s_w) in f32."""
        if isinstance(x, QTensor):
            xq, s_act = x.data, x.scale
        else:
            xq, s_act = self.quantize("act_quant", self.rule.act, x)
        wspec = dataclasses.replace(self.rule.weight, axis=0)
        wq = self.constant("wq", (self.weight,), lambda: self.quantize(
            "weight_quant", wspec, self.weight)[0])
        out_scale = self.constant("out_scale", (s_act, self.weight),
                                  lambda: rescale(s_act, self.weight, 0,
                                                  not self.eager))
        out = int8_conv2d(xq, wq, self.stride, self.padding,
                          impl=self.kernel_impl)
        return out.float() * out_scale.reshape(1, -1, 1, 1)


class ConvTranspose2d(nn.Module):
    """Transposed conv (torch ConvTranspose2d geometry), IOHW weight."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, bias=True):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.stride = _pair(stride)
        self.padding = _pair(padding)
        self.weight = nn.Parameter(torch.empty(in_channels, out_channels, kh, kw))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None

    def reset_parameters(self, generator):
        # the reference's fan_in for its (kh, kw, cout, cin) kernel layout
        bound = 1.0 / math.sqrt(self.weight[0].numel())
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(x, self.weight.to(x.dtype), bias,
                                  self.stride, self.padding)


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm2d over NCHW maps, computed as the reference's
    flax BatchNorm does, (x - mean) * (rsqrt(var + eps) * weight) + bias,
    in f32 and returned in the input dtype, or in f32 when ``out_f32`` is
    set (an int8 deploy model: flax promotes a bf16 input with its f32
    parameters)."""

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

    def _affine(self, x):
        def c(v):
            return v[None, :, None, None]
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return (x - c(self.running_mean)) * c(mul) + c(self.bias)

    def forward(self, x):
        y = self._affine(x.float())
        return y if self.out_f32 else y.to(x.dtype)

    def fold(self):
        """The eval affine as (k, b), y = x * k + b, probed as the reference
        does (:536-542): b = bn(0), k = bn(1) - b; computed once per set of
        BN parameters."""
        def compute():
            probe = self.weight.new_zeros((1, self.weight.numel(), 1, 1))
            b = self._affine(probe).reshape(-1)
            return self._affine(probe + 1).reshape(-1) - b, b
        return memo(self, "fold", (self.running_var, self.weight, self.bias,
                                   self.running_mean), compute)


class DenseRequant(QuantLayer, nn.Module):
    """Quantize a dense map once into a QTensor (reference :98-125): the
    CenterHead's shared feature, so that its int8 branch convs start from
    int8 data.  A no-op unless an int8-residency conv2d rule matches."""
    QUANT_KIND = "conv2d"

    def forward(self, x):
        if not self.residency or isinstance(x, QTensor):
            return x
        return QTensor(*self.quantize("quant", self.rule.act, x))

