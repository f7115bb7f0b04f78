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


def int8_matmul(a, b, impl=None, tag="int8_conv2d"):
    """s8 (M, K) x s8 (K, N) -> s32 (M, N).

    ``impl``: "cuda" (``torch._int_mm``, counted in ``INT_MM_CALLS[tag]``),
    "plain" (an exact product: int32 on the CPU, f64 on the card, where
    |sum| <= K*127^2 < 2^53), or None = by the tensors' device."""
    if impl is None:
        impl = "cuda" if a.is_cuda else "plain"
    if impl == "cuda":
        if not (a.is_cuda and a.shape[0] > 16 and a.shape[1] % 8 == 0
                and b.shape[1] % 8 == 0):
            raise ValueError(
                f"int8_matmul: _int_mm needs CUDA tensors, M > 16 and K, N "
                f"multiples of 8 (got {tuple(a.shape)} x {tuple(b.shape)})")
        INT_MM_CALLS[tag] += 1
        return torch._int_mm(a, b)
    if impl == "plain":
        acc = torch.int32 if a.device.type == "cpu" else torch.float64
        return (a.to(acc) @ b.to(acc)).to(torch.int32)
    raise ValueError(f"unknown impl {impl!r}")


def int8_conv2d(x, w, stride, padding, impl=None):
    """s8 x s8 -> s32 conv: x (B, C, H, W) int8, w (O, C, kh, kw) int8 ->
    (B, O, Ho, Wo) int32, an NCHW-shaped view of NHWC memory: the im2col of
    ``_patches``, then ``int8_matmul`` (``impl`` as there)."""
    a, (b, ho, wo) = _patches(x, w.shape[2:], stride, padding)
    wm = w.permute(0, 2, 3, 1).reshape(w.shape[0], -1)        # (O, kh*kw*C)
    out = int8_matmul(a, wm.t(), impl)
    return out.view(b, ho, wo, -1).permute(0, 3, 1, 2)


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def smoothquant_scale(a_amax, w_amax, alpha):
    """SmoothQuant's per-column scale migration,
    max(act_amax^alpha / w_amax^(1-alpha), 1e-5), from the clamped column
    amaxes of the patches and of the (K, O) weight."""
    return torch.clamp_min(torch.pow(a_amax, alpha)
                           / torch.pow(w_amax, 1.0 - alpha), 1e-5).detach()


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
        rule = self.rule
        if isinstance(x, QTensor) and not (
                rule is not None and rule.deploy_int8
                and rule.smoothquant is None):
            # a residency chain feeding a float, fake-quant or SmoothQuant
            # layer: real values first
            x = dequantize(x)
        if rule is None or self.fake:
            # float, on fake-quantized inputs under a fake-quant rule
            if self.fake and rule.smoothquant is not None:
                y = self._smoothquant_conv(x)
                y = y if self.bias is None else y + self.bias.reshape(1, -1, 1, 1)
                return y.to(x.dtype)
            w = self.weight
            if self.fake:
                wspec = rule.weight
                if wspec is not None and wspec.axis is not None:
                    wspec = dataclasses.replace(wspec, axis=0)
                w = self.fake_quantize("weight_quant", wspec, w)
                x = self.fake_quantize("act_quant", rule.act, x)
            bias = None if self.bias is None else self.bias.to(x.dtype)
            return F.conv2d(x, w.to(x.dtype), bias, self.stride, self.padding)
        if rule.smoothquant is not None:
            y = self._smoothquant_int8_conv(x)
        else:
            y = self._int8_conv(x)
            if isinstance(x, QTensor) or rule.int8_residency:
                # int8 residency: the raw f32 (+ bias) for the caller's
                # epilogue
                return y if self.bias is None \
                    else y + self.bias.reshape(1, -1, 1, 1)
        # without residency the input's dtype, cast before and after the
        # (f32) bias as the reference casts
        y = y.to(x.dtype)
        if self.bias is not None:
            y = (y + self.bias.reshape(1, -1, 1, 1)).to(x.dtype)
        return y

    def _unfold(self, x):
        """im2col of a float NCHW map -> ((B, L, C*kh*kw) patches, columns
        in (cin, kh, kw) order as the reference's, (B, Ho, Wo))."""
        _, _, kh, kw = self.weight.shape
        b, _, h, w_ = x.shape
        (sh, sw), (ph, pw) = self.stride, self.padding
        ho, wo = (h + 2 * ph - kh) // sh + 1, (w_ + 2 * pw - kw) // sw + 1
        patches = F.unfold(x, (kh, kw), padding=self.padding,
                           stride=self.stride).transpose(1, 2)
        return patches, (b, ho, wo)

    def _smoothquant_conv(self, x):
        """im2col + SmoothQuant scale migration + fake-quant + GEMM (the
        reference's ``_smoothquant_conv``, :265-308): the columns of
        ``F.unfold`` are in (cin, kh, kw) order, as the reference's patches;
        per column, scale = max(act_amax^alpha / w_amax^(1-alpha), 1e-5),
        with act_amax the batch's (dynamic) or the calibrated
        ``sq_act_amax`` (static); then the act is fake-quantized per tensor,
        the weight per output channel, and one f32 GEMM (the reference's
        ``einsum``, outside any Pallas kernel) -> (B, O, Ho, Wo)."""
        o = self.weight.shape[0]
        patches, (b, ho, wo) = self._unfold(x)                    # (B, L, K)
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
        scale = smoothquant_scale(a_amax, w_amax, sq.alpha)
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

    def _smoothquant_int8_conv(self, x):
        """The reference's SmoothQuant ``_int8_conv`` (:213-236, :255-260):
        the float im2col (``_unfold``), the per-column scale of
        ``smoothquant_scale`` from the batch's column amax, patches divided
        by it and the weight multiplied by it; then the patches quantized
        per tensor, the weight per output channel, an s8 x s8 -> s32 GEMM
        (``int8_matmul``, the reference's ``dot_general`` outside any Pallas
        kernel) and * (s_act * s_w) -> f32 (B, O, Ho, Wo)."""
        o = self.weight.shape[0]
        patches, (b, ho, wo) = self._unfold(x)                    # (B, L, K)
        w2d = self.weight.reshape(o, -1).t()                      # (K, O)
        scale = smoothquant_scale(patches.abs().amax((0, 1)).clamp_min(1e-5),
                                  w2d.abs().amax(1).clamp_min(1e-5),
                                  self.rule.smoothquant.alpha)
        pq, s_act = self.quantize("act_quant", self.rule.act, patches / scale)
        w_s = w2d * scale[:, None]
        wspec = dataclasses.replace(self.rule.weight, axis=1)
        wq = self.quantize("weight_quant", wspec, w_s)[0]
        out_scale = rescale(s_act, w_s, 1, not self.eager)
        # A row-major, B column-major, the layouts int8_conv2d gives _int_mm
        acc = int8_matmul(pq.reshape(-1, pq.shape[-1]).contiguous(),
                          wq.t().contiguous().t(), self.kernel_impl,
                          tag="int8_conv2d_sq")
        y = acc.float() * out_scale.reshape(1, -1)
        return y.view(b, ho, wo, o).permute(0, 3, 1, 2)


class Linear(QuantLayer, nn.Module):
    """Dense layer, (O, I) weight: ``x @ weight.T (+ bias)`` in the input's
    dtype (the reference's ``Linear``, a plain matmul outside any Pallas
    kernel).  Its quant kind, "linear", is TransFusion's SmoothQuant
    target, which is not ported: ``quant.api`` raises on a rule for it."""
    QUANT_KIND = "linear"

    def __init__(self, in_features, out_features, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None

    def reset_parameters(self, generator):
        """U(-1/sqrt(fan_in), 1/sqrt(fan_in)); bias 0 (the reference's
        variance_scaling(1/3, fan_in, uniform) and zeros)."""
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        y = x @ self.weight.t().to(x.dtype)
        return y if self.bias is None else y + self.bias


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
    """BatchNorm2d over NCHW maps, computed as the reference's flax
    BatchNorm does, (x - mean) * (rsqrt(var + eps) * weight) + bias, in f32
    and returned in the input dtype, or in f32 when ``out_f32`` is set (an
    int8 deploy model: flax promotes a bf16 input with its f32
    parameters).

    Eval mode takes the running statistics.  Train mode (``nn.Module.
    training``) is flax's ``nn.BatchNorm(momentum=1 - momentum)``
    (reference ``layers.py:513-543``): the batch's statistics over N, H and
    W, the variance as E[x^2] - E[x]^2 clipped at 0 (flax's fast variance),
    and that biased variance in the running average.  ``F.batch_norm``
    would average the unbiased one, so the update is written out."""

    def __init__(self, num_features, eps=1e-3, momentum=0.01):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
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

    def _affine(self, x, mean=None, var=None):
        def c(v):
            return v[None, :, None, None]
        mean = self.running_mean if mean is None else mean
        var = self.running_var if var is None else var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - c(mean)) * c(mul) + c(self.bias)

    def forward(self, x):
        xf = x.float()
        if self.training:
            y = self._affine(xf, *self._batch_stats(xf))
        else:
            y = self._affine(xf)
        return y if self.out_f32 else y.to(x.dtype)

    def _batch_stats(self, x):
        """flax's batch mean and fast variance over all dims but the
        channels; the running statistics move as flax moves them."""
        dims = [d for d in range(x.dim()) if d != 1]
        mean = x.mean(dims)
        var = torch.clamp_min((x * x).mean(dims) - mean * mean, 0.0)
        with torch.no_grad():
            keep = 1.0 - self.momentum              # flax's momentum
            self.running_mean.copy_(keep * self.running_mean
                                    + (1 - keep) * mean)
            self.running_var.copy_(keep * self.running_var + (1 - keep) * var)
        return mean, var

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


class BatchNorm1d(BatchNorm):
    """BatchNorm over the last dim of (..., C) features (the PFN layers'),
    computed as ``BatchNorm`` computes it.  Train mode is flax's, as the
    reference's PFN runs it (``pillar_vfe.py:31-33``): the statistics of
    all (N * P) rows, the padded point slots included (they were zeroed
    before the linear layer and take part, as OpenPCDet's do)."""

    def _affine(self, x, mean=None, var=None):
        mean = self.running_mean if mean is None else mean
        var = self.running_var if var is None else var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * mul + self.bias

    def _batch_stats(self, x):
        return super()._batch_stats(x.reshape(-1, x.shape[-1]))


class DenseRequant(QuantLayer, nn.Module):
    """Quantize a dense map once into a QTensor (reference :98-125): the
    CenterHead's shared feature, so that its int8 branch convs start from
    int8 data.  A no-op unless an int8-residency conv2d rule matches."""
    QUANT_KIND = "conv2d"

    def forward(self, x):
        if not self.residency or isinstance(x, QTensor):
            return x
        return QTensor(*self.quantize("quant", self.rule.act, x))

