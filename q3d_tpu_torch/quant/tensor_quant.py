"""Fake and integer quantization and their calibration state (port of
``q3d_tpu/quant/tensor_quant.py``).

``fake_quant`` is the reference's quantize-dequantize (:78-95), op for op:
``scale = bound / max(amax, 1e-12)`` (a true division: PyTorch's
``scalar / tensor`` would multiply by the reciprocal),
``clip(round_half_even(x * scale), min_bound, bound) / scale``, then the
straight-through form ``x + (deq - x).detach()``.  The reference's jitted
steps round it exactly as its eager ops do (pinned by
``tests/test_torch_port_fakequant.py``), so it has no fused form.

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

from .calib import compute_amax_from_hist

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


def fake_quant(x, amax, num_bits=8, unsigned=False, narrow_range=False,
               axis=None):
    """Quantize-dequantize with a straight-through gradient (reference
    ``fake_quant``): symmetric range, round half to even, clamp to
    [min_bound, bound]; any ``num_bits`` (the sweeps use 2..16)."""
    bound = (2.0 ** num_bits - 1.0) if unsigned \
        else (2.0 ** (num_bits - 1) - 1.0)
    min_bound = (1.0 - bound) if (not unsigned and narrow_range) \
        else (-bound if not unsigned else 0.0)
    amax_b = _broadcast_amax(amax, x, axis).clamp_min(1e-12)
    scale = torch.div(amax_b.new_tensor(bound), amax_b)
    deq = torch.clamp(torch.round(x * scale), min_bound, bound) / scale
    return x + (deq - x).detach()


def fake_quant_groups(x, spec):
    """Group quantization (the reference's grouped dynamic branch,
    ``tensor_quant.py:122-131``, its GQConv3d): the rows of ``x`` are
    zero-padded to a multiple of ``spec.group_size``, split into groups of
    that many rows, and each group is fake-quantized with its own amax."""
    g, n = spec.group_size, x.shape[0]
    pad = (-n) % g
    xp = torch.cat([x, x.new_zeros((pad, *x.shape[1:]))]) if pad else x
    grouped = xp.reshape((n + pad) // g, -1)
    amax = grouped.detach().abs().amax(1, keepdim=True).clamp_min(1e-12)
    q = fake_quant(grouped, amax, spec.num_bits, spec.unsigned,
                   spec.narrow_range, axis=0)
    return q.reshape(xp.shape)[:n]


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
    """A quantizer with its committed ``amax`` and calibration state.

    ``mode="int"``: ``forward(x, calibrating) -> (int8, scale)``.  A dynamic
    spec quantizes with each batch's amax; while calibrating it records the
    batch and quantizes with the batch's amax.  A static spec quantizes with
    the committed ``amax`` and raises if it was never calibrated (the
    reference would quantize with amax 0 and give garbage).

    ``mode="fake"`` (reference :104-173): ``forward(x, calibrating) -> x``
    quantize-dequantized.  A dynamic spec takes each batch's amax (per
    tensor, per ``axis``, or per group of ``group_size`` rows); while
    calibrating every spec records the batch
    and passes ``x`` through unquantized; a static spec takes the committed
    ``amax``, and passes ``x`` through while that is 0 (never calibrated)."""

    def __init__(self, spec: QuantSpec, amax_shape=(), device=None,
                 mode="int"):
        super().__init__()
        if mode == "int" and (spec.unsigned or spec.narrow_range
                              or spec.num_bits != 8 or spec.group_size):
            raise NotImplementedError(
                "int mode is signed 8-bit, full range, without groups")
        if mode not in ("int", "fake"):
            raise ValueError(f"unknown quantizer mode {mode!r}")
        self.spec = spec
        self.mode = mode
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
        if self.mode == "fake":
            return self._fake(x, calibrating)
        spec = self.spec
        if spec.dynamic and not calibrating:
            return quantize_to_int(x, _reduce_amax(x, spec.axis), spec.num_bits,
                                   spec.axis, fused)
        if calibrating:
            batch_amax = self._record(x)
            if fused:          # XLA keeps a bf16 batch's amax in f32
                batch_amax = batch_amax.float()
            return quantize_to_int(x, batch_amax.clamp_min(1e-12),
                                   spec.num_bits, spec.axis, fused)
        scale = _broadcast_amax(self.scale(), x, spec.axis)
        return quantize_with_scale(x, scale), scale

    def _fake(self, x, calibrating):
        spec = self.spec
        if not spec.enabled:
            return x
        if spec.group_size and spec.dynamic and not calibrating:
            return fake_quant_groups(x, spec)
        if spec.dynamic and not calibrating:
            return fake_quant(x, _reduce_amax(x, spec.axis).detach(),
                              spec.num_bits, spec.unsigned, spec.narrow_range,
                              spec.axis)
        if calibrating:
            self._record(x)
            return x
        if not memo(self, "committed", (self.amax,),
                    lambda: bool((self.amax > 0).all())):
            return x
        return fake_quant(x, self.amax, spec.num_bits, spec.unsigned,
                          spec.narrow_range, spec.axis)

    def _record(self, x):
        """Fold a calibration batch into the running absmax (and the
        histogram) -> the batch's amax, in x's dtype."""
        batch_amax = _reduce_amax(x, self.spec.axis).detach()
        self.absmax = torch.maximum(self.absmax, batch_amax.float())
        if self.spec.calibrator == "histogram":
            self._update_histogram(x.detach().abs().reshape(-1),
                                   batch_amax.float())
        return batch_amax

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

    def commit_amax(self, method="max", **kwargs):
        """Resolve the calibration state into ``amax`` (the reference's
        ``resolve_amax``): a histogram quantizer by
        ``calib.compute_amax_from_hist(method, **kwargs)``, a max-only one
        by its running absmax."""
        if self.spec.calibrator == "histogram":
            amax = torch.tensor(compute_amax_from_hist(
                self.hist.cpu().numpy(), float(self.bin_width), method=method,
                **kwargs), dtype=torch.float32)
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


def smoothquant_scale(a_amax, w_amax, alpha):
    """SmoothQuant's per-column scale migration,
    max(act_amax^alpha / w_amax^(1-alpha), 1e-5), from the clamped column
    amaxes of the patches (a dense conv's im2col, a sparse conv's gather
    view) and of the (K, O) weight."""
    return torch.clamp_min(torch.pow(a_amax, alpha)
                           / torch.pow(w_amax, 1.0 - alpha), 1e-5).detach()


class QuantLayer:
    """Mixin of a quantizable layer: the rule ``quant.api.quantize_model``
    attached (None = the layer stays float; a fake-quant rule, with or
    without SmoothQuant; or an int8-residency deploy rule), the flags its
    calibration passes set (``calibrating``; ``eager`` in the seed pass,
    which rounds as the reference's un-jitted ``model.init`` does), and its
    quantizers, created as child modules on first use while calibrating (as
    the reference declares its quantizer variables in ``model.init``)."""
    rule = None
    calibrating = False
    eager = False

    @property
    def residency(self):
        """True under an int8-residency deploy rule."""
        return self.rule is not None and self.rule.deploy_int8 \
            and self.rule.int8_residency

    @property
    def fake(self):
        """True under a fake-quant rule (no int8 deploy)."""
        return self.rule is not None and not self.rule.deploy_int8

    def quantize(self, name, spec, x):
        """(int8, scale) from int-mode quantizer ``name`` (created while
        calibrating)."""
        return self.quantizer(name, spec, x)(x, self.calibrating,
                                             not self.eager)

    def fake_quantize(self, name, spec, x):
        """``x`` quantize-dequantized by fake-mode quantizer ``name`` (None
        spec: ``x`` as it is)."""
        if spec is None:
            return x
        return self.quantizer(name, spec, x, "fake")(x, self.calibrating)

    def constant(self, name, sources, fn):
        """An int8 constant of this layer: ``fn()`` while calibrating (the
        quantizers record), else kept by ``memo``."""
        return fn() if self.calibrating else memo(self, name, sources, fn)

    def smoothquant_column_scale(self, act_amax, w_amax, dynamic=None):
        """SmoothQuant's per-column scale (``smoothquant_scale``) from the
        weight's clamped column amax ``w_amax`` and the activation's: the
        batch's, ``act_amax()`` (dynamic), or the calibrated ``sq_act_amax``
        (static; calibration records ``sq_act_absmax``, the reference's
        quant/sq_act_amax and calib/sq_act_absmax).  ``dynamic`` overrides
        the rule's (a Conv1d takes the batch's always, as the reference's
        does)."""
        sq = self.rule.smoothquant
        dynamic = sq.dynamic if dynamic is None else dynamic
        if dynamic:
            a_amax = act_amax().clamp_min(1e-5)
        else:
            if self.calibrating:
                if not hasattr(self, "sq_act_amax"):
                    # ones until committed, as the reference's
                    self.register_buffer("sq_act_amax", torch.ones_like(
                        w_amax, dtype=torch.float32))
                    self.register_buffer("sq_act_absmax", torch.zeros_like(
                        w_amax, dtype=torch.float32), persistent=False)
                self.sq_act_absmax = torch.maximum(
                    self.sq_act_absmax, act_amax().detach())
            elif not hasattr(self, "sq_act_amax"):
                raise RuntimeError("a static SmoothQuant layer was never "
                                   "calibrated: run quant.api.quantize_model")
            a_amax = self.sq_act_amax.clamp_min(1e-5)
        return smoothquant_scale(a_amax, w_amax, sq.alpha)

    def smoothquant_matmul(self, patches, w2d, dynamic=None):
        """The fake-quant SmoothQuant product of a layer's patch matrix
        ``patches`` (..., K) (a dense conv's im2col, a sparse conv's gather
        view, a Linear's input) and its weight ``w2d`` (K, O) (the
        reference's ``_smoothquant_conv``, ``gemm_transform``, ``Linear``
        and ``Conv1d``): per column, scale = ``smoothquant_column_scale``
        (``dynamic`` as there); then patches / scale fake-quantized per
        tensor, w2d * scale per output column, and one ``torch.matmul``
        (the reference's einsum or ``@``, outside any Pallas kernel) ->
        (..., O) in the patches' dtype."""
        rows = tuple(range(patches.dim() - 1))
        scale = self.smoothquant_column_scale(
            lambda: patches.abs().amax(rows),
            w2d.abs().amax(1).clamp_min(1e-5), dynamic)
        p = self.fake_quantize("act_quant", self.rule.act,
                               torch.div(patches, scale))
        wq = self.fake_quantize("weight_quant", self.weight_spec(1),
                                w2d * scale[:, None])
        return torch.matmul(p, wq.to(p.dtype))

    def weight_spec(self, axis):
        """The rule's weight spec, per channel along ``axis`` of the
        weight as this layer holds it when the rule's is per channel."""
        wspec = self.rule.weight
        if wspec is not None and wspec.axis is not None:
            wspec = dataclasses.replace(wspec, axis=axis)
        return wspec

    def quantizer(self, name, spec, like, mode="int"):
        q = self._modules.get(name)
        if q is None:
            if not self.calibrating:
                raise RuntimeError(
                    f"{type(self).__name__}.{name} was never calibrated: run "
                    f"quant.api.quantize_model (and collect_stats) first")
            shape = () if spec.axis is None else (like.shape[spec.axis % like.dim()],)
            q = TensorQuantizer(spec, shape, like.device, mode)
            self.add_module(name, q)
        return q
