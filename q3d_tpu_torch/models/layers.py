"""Dense NCHW building blocks of the CenterPoint path (port of the float
path of ``q3d_tpu/models/layers.py``).

Precision follows the reference (``layers.py:167-201``): the input stays in
the compute dtype, weights are cast to it, and the convolution accumulates
in f32 (cuDNN does so for bf16 inputs; f32 comparisons must turn TF32 off).
The dense convs are library calls, as the reference leaves them to XLA.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


class Conv2d(nn.Module):
    """2D conv, OIHW weight; bias initialised to ``bias_init``."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, bias=True, bias_init=0.0):
        super().__init__()
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
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), bias, self.stride,
                        self.padding)


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
    in f32 and returned in the input dtype."""

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

    def forward(self, x):
        def c(v):
            return v[None, :, None, None]
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x.float() - c(self.running_mean)) * c(mul) + c(self.bias)
        return y.to(x.dtype)

