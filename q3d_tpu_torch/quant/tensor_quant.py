"""Integer quantization and its calibration state (port of the int path of
``q3d_tpu/quant/tensor_quant.py``).

``quantize_to_int`` divides by ``scale = max(amax, 1e-12) / 127`` and rounds
half to even, as the reference does, and rounds where the reference does.
The reference runs two ways, and the port follows both (``fused``):

* fused (its jitted calibration steps and forwards, the default): XLA turns
  the division by the constant 127 into a multiplication by the f32
  reciprocal, keeps a bf16 batch's scale and quotient in f32, and computes
  a conv's rescale ``s_in * s_w`` as ``(s_in * (1/127)) * amax_w``
  (``rescale``); ``x / scale`` stays a true division;
* eager (the seed pass of ``quantize_model``, whose ``model.init`` runs op
  by op): a true division by 127, every op rounded in its own dtype (a bf16
  batch stays bf16), ``s_in * s_w`` as written.

PyTorch would keep a dimensioned bf16 tensor in bf16 against a 0-dim f32
scale where JAX promotes to f32, so the casts are written out.

A ``TensorQuantizer`` is an ``nn.Module`` whose committed ``amax`` is a
buffer, so ``state_dict()`` carries the calibrated scales.  Its calibration
state (running absmax; for ``calibrator="histogram"`` also the reference's
2048-bin absmax histogram with integer range growth) lives in
non-persistent buffers.  A quantizer's owner passes ``calibrating``; while
calibrating, it records the batch and quantizes with the batch's own amax
(``tensor_quant.py:141-158``).  ``commit_amax`` resolves the committed amax
as the reference's method "max" does: the histogram's top filled bin, else
the running absmax.

Outside calibration a layer's int8 constants (its quantized weight, its
rescale, the committed scales, the BN folds) are fixed, so ``memo`` keeps
each until one of the tensors it was computed from changes.
"""

import dataclasses
from typing import Optional

import torch
from torch import nn

NUM_HIST_BINS = 2048


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Static description of one quantizer.

    axis: None = per-tensor; int = per-channel along that axis.
    dynamic: compute amax from each batch on the fly.
    calibrator: 'max' or 'histogram' (the calibration state kept).
    """
    num_bits: int = 8
    axis: Optional[int] = None
    unsigned: bool = False
    narrow_range: bool = False
    dynamic: bool = True
    calibrator: str = "max"
    enabled: bool = True
    group_size: Optional[int] = None

    @property
    def bound(self):
        if self.unsigned:
            return 2.0 ** self.num_bits - 1.0
        return 2.0 ** (self.num_bits - 1) - 1.0


def _reduce_amax(x, axis):
    """abs-max over all dims except ``axis`` (None -> scalar amax), in x's
    dtype."""
    if axis is None:
        return x.abs().amax()
    ax = axis % x.dim()
    return x.abs().amax(dim=tuple(d for d in range(x.dim()) if d != ax))


def _broadcast_amax(amax, x, axis):
    if axis is None:
        return amax
    shape = [1] * x.dim()
    shape[axis % x.dim()] = -1
    return amax.reshape(shape)


def memo(owner, name, sources, fn):
    """``fn()``, kept on ``owner`` under ``name`` until one of ``sources``
    changes: becomes another tensor, moves to other storage (``.to``), or is
    written in place (``load_state_dict`` and ``commit_amax`` copy in place,
    which bumps the tensor's version).  The memo holds its sources, so their
    storage cannot be reused by another tensor while it lives."""
    key = tuple((t, 0 if t.is_inference() else t._version, t.data_ptr())
                for t in sources)
    cache = owner.__dict__.setdefault("_memo", {})
    hit = cache.get(name)
    if hit is None or len(hit[0]) != len(key) or any(
            a[0] is not b[0] or a[1:] != b[1:] for a, b in zip(hit[0], key)):
        hit = cache[name] = (key, fn())
    return hit[1]


def quantize_with_scale(x, scale):
    """clip(round(x / scale), -127, 127) as int8, computed in the promotion
    of x's and scale's dtypes."""
    dt = torch.promote_types(x.dtype, scale.dtype)
    q = torch.round(x.to(dt) / scale.to(dt))
    return q.clamp_(-127.0, 127.0).to(torch.int8)


def amax_to_scale(amax, bound=127.0, fused=True):
    """max(amax, 1e-12) / bound: fused, times the f32 reciprocal of the
    bound (back in amax's dtype); eager, a true division in amax's dtype."""
    if fused:
        return (amax.clamp_min(1e-12).float() * (1.0 / bound)).to(amax.dtype)
    return amax.clamp_min(1e-12) / bound


def quantize_to_int(x, amax, num_bits=8, axis=None, fused=True):
    """True integer quantization: returns (int8 values, scale broadcastable
    over x).  The scale keeps amax's dtype."""
    if num_bits != 8:
        raise NotImplementedError("int8 only")
    scale = amax_to_scale(_broadcast_amax(amax, x, axis), fused=fused)
    return quantize_with_scale(x, scale), scale


class TensorQuantizer(nn.Module):
    """int-mode quantizer: ``forward(x, calibrating) -> (int8, scale)``.

    A dynamic spec quantizes with each batch's amax.  A static spec
    quantizes with the committed ``amax`` and raises if it was never
    calibrated (the reference would quantize with amax 0 and give
    garbage)."""

    def __init__(self, spec: QuantSpec, amax_shape=(), device=None):
        super().__init__()
        if spec.group_size or spec.unsigned or spec.narrow_range:
            raise NotImplementedError(
                "group, unsigned and narrow-range quantizers are not ported")
        self.spec = spec
        self.register_buffer("amax", torch.zeros(amax_shape, device=device))
        self.register_buffer("absmax", torch.zeros(amax_shape, device=device),
                             persistent=False)
        if spec.calibrator == "histogram":
            if spec.axis is not None:
                raise ValueError("histogram calibration is per-tensor")
            self.register_buffer("hist", torch.zeros(NUM_HIST_BINS,
                                                     device=device),
                                 persistent=False)
            self.register_buffer("bin_width", torch.zeros((), device=device),
                                 persistent=False)
        elif spec.calibrator != "max":
            raise ValueError(f"unknown calibrator {spec.calibrator!r}")
        self.calibrated = False

    def forward(self, x, calibrating=False, fused=True):
        spec = self.spec
        if spec.dynamic and not calibrating:
            return quantize_to_int(x, _reduce_amax(x, spec.axis), spec.num_bits,
                                   spec.axis, fused)
        if calibrating:
            batch_amax = _reduce_amax(x, spec.axis)
            self.absmax = torch.maximum(self.absmax, batch_amax.float())
            if spec.calibrator == "histogram":
                self._update_histogram(x.abs().reshape(-1), batch_amax.float())
            if fused:          # XLA keeps a bf16 batch's amax in f32
                batch_amax = batch_amax.float()
            return quantize_to_int(x, batch_amax.clamp_min(1e-12),
                                   spec.num_bits, spec.axis, fused)
        scale = _broadcast_amax(self.scale(), x, spec.axis)
        return quantize_with_scale(x, scale), scale

    def scale(self):
        """The committed scale, max(amax, 1e-12) / 127 (f32; see
        ``amax_to_scale``), computed once per committed amax."""
        if not self.calibrated:
            raise RuntimeError(
                "a static quantizer has no calibrated amax: run "
                "collect_stats and compute_amax, or load a calibrated "
                "state dict, first")
        return memo(self, "scale", (self.amax,),
                    lambda: amax_to_scale(self.amax, self.spec.bound))

    def _update_histogram(self, abs_vals, batch_max):
        """The reference's ``_update_histogram`` (tensor_quant.py:176-198):
        the first batch sets the bin width to its max / 2048; a batch past
        the range multiplies the width by the smallest integer that fits and
        re-bins the old counts (index // factor)."""
        width = self.bin_width
        cur_range = width * NUM_HIST_BINS
        need_width = torch.clamp_min(batch_max / NUM_HIST_BINS, 1e-12)
        first = width == 0
        factor = torch.where(
            (batch_max > cur_range) & ~first,
            torch.ceil(batch_max / torch.clamp_min(cur_range, 1e-30)),
            torch.ones_like(width))
        new_width = torch.where(first, need_width, width * factor)
        old_idx = torch.arange(NUM_HIST_BINS, device=abs_vals.device).float()
        new_idx = (old_idx / factor).to(torch.int32).clamp_(0, NUM_HIST_BINS - 1)
        rebinned = torch.zeros_like(self.hist).index_add_(0, new_idx, self.hist)
        idx = (abs_vals.float() / new_width).to(torch.int32).clamp_(
            0, NUM_HIST_BINS - 1)
        self.hist = rebinned.index_add_(
            0, idx, torch.ones_like(idx, dtype=rebinned.dtype))
        self.bin_width = new_width

    def commit_amax(self):
        """Resolve the calibration state into ``amax`` (the reference's
        ``resolve_amax`` with ``compute_amax_from_hist(method="max")``)."""
        if self.spec.calibrator == "histogram":
            nz = torch.nonzero(self.hist).reshape(-1)
            top = float((int(nz[-1]) + 1) * float(self.bin_width)) \
                if len(nz) else 0.0
            amax = torch.tensor(top, dtype=torch.float32)
        else:
            amax = self.absmax
        self.amax.copy_(amax.reshape(self.amax.shape))
        self.calibrated = True

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)
        if prefix + "amax" in state_dict:
            self.calibrated = bool((self.amax > 0).all())


def rescale(s_in, w, axis, fused=True):
    """A conv's output rescale s_in * s_w (Cout,): s_in the input's scale,
    s_w = max(amax_w, 1e-12) / 127 the weight's per output channel
    (``axis``).  Fused, as XLA reassociates it: (s_in * (1/127)) * amax_w."""
    amax_w = _reduce_amax(w, axis).clamp_min(1e-12)
    if not fused:
        return s_in * (amax_w / 127.0)
    return (s_in.float() * (1.0 / 127.0)) * amax_w


class QuantLayer:
    """Mixin of a quantizable layer: the int8-residency deploy rule
    ``quant.api.quantize_model`` attached (None = the layer stays float),
    the flags its calibration passes set (``calibrating``; ``eager`` in the
    seed pass, which rounds as the reference's un-jitted ``model.init``
    does), and its quantizers, created as child modules on first use while
    calibrating (as the reference declares its quantizer variables in
    ``model.init``)."""
    rule = None
    calibrating = False
    eager = False

    @property
    def residency(self):
        """True under an int8-residency deploy rule (the only rules
        ``quantize_model`` attaches)."""
        return self.rule is not None

    def quantize(self, name, spec, x):
        """(int8, scale) from quantizer ``name`` (created while calibrating)."""
        return self.quantizer(name, spec, x)(x, self.calibrating,
                                             not self.eager)

    def constant(self, name, sources, fn):
        """An int8 constant of this layer: ``fn()`` while calibrating (the
        quantizers record), else kept by ``memo``."""
        return fn() if self.calibrating else memo(self, name, sources, fn)

    def quantizer(self, name, spec, like):
        q = self._modules.get(name)
        if q is None:
            if not self.calibrating:
                raise RuntimeError(
                    f"{type(self).__name__}.{name} was never calibrated: run "
                    f"quant.api.quantize_model (and collect_stats) first")
            shape = () if spec.axis is None else (like.shape[spec.axis % like.dim()],)
            q = TensorQuantizer(spec, shape, like.device)
            self.add_module(name, q)
        return q
