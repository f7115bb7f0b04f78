"""Optimizer and learning-rate schedules (port of
``q3d_tpu/optimization.py``), held to optax's numbers, not torch's
defaults.

``build_optimizer(params, optim_cfg, total_steps)`` returns an
``Optimizer``: the reference's optax chain over torch parameters,

  * ``adam`` / ``adam_onecycle``: ``optax.adamw(b1=0.9, b2=0.99, eps=1e-8,
    weight_decay=WEIGHT_DECAY)`` on every parameter, the decay decoupled —
    ``torch.optim.AdamW(betas=(0.9, 0.99), eps=1e-8)``;
  * ``sgd``: ``add_decayed_weights`` then momentum —
    ``torch.optim.SGD(momentum=MOMENTUM, weight_decay=WEIGHT_DECAY)``;
  * with ``GRAD_NORM_CLIP > 0`` the chain starts with optax's
    ``clip_by_global_norm``: g stays below the norm, else g / |g| * c.

Update ``i`` (from 0) takes the learning rate ``schedule(i)``.  ``MOMS`` is
ignored, as the reference ignores it.  A parameter that got no gradient is
updated with a zero one (its moments decay and its weight decays), as
optax updates every leaf.

The schedules are plain functions of the step, computed as optax's
schedules compute them when called with a Python step (f32 where optax
rounds to f32; the cosine of an f32 argument rounded once to f32): the
one-cycle cosine tail cancels (cos(pi p) + 1 -> 0), so a schedule computed
in f64 would differ from optax's by up to ~3e-5 relative there.
"""

import math

import numpy as np
import torch

_F = np.float32


def _cos32(x):
    """cos of an f32 argument, rounded to f32."""
    return _F(math.cos(float(x)))


def onecycle_schedule(total_steps, peak, pct_start, div_factor,
                      final_div_factor=1e4):
    """``optax.cosine_onecycle_schedule``: a cosine ramp from peak /
    div_factor to peak over int(pct_start * total_steps) steps, then a
    cosine decay to peak / (div_factor * final_div_factor)."""
    boundary = int(pct_start * total_steps)
    values = np.cumprod([peak / div_factor, div_factor,
                         1.0 / (div_factor * final_div_factor)])
    bounds = (0, boundary, int(total_steps))

    def schedule(step):
        if step >= bounds[-1]:
            return float(values[-1])
        seg = 0 if step < boundary else 1
        lo, hi = bounds[seg], bounds[seg + 1]
        c = _cos32(_F(math.pi * ((step - lo) / (hi - lo))))
        start, end = values[seg], values[seg + 1]
        return float(_F(end) + _F((start - end) / 2.0) * (c + _F(1)))
    return schedule


def warmup_cosine_schedule(total_steps, lr):
    """``optax.warmup_cosine_decay_schedule(lr / 10, lr, warmup, total,
    lr / 1000)`` with warmup = max(int(0.02 * total), 1): linear from lr /
    10 to lr, then a cosine decay to lr / 1000."""
    init, end = lr * 0.1, lr * 1e-3
    warmup = max(int(total_steps * 0.02), 1)
    decay = float(total_steps - warmup)
    alpha = end / lr

    def schedule(step):
        if step < warmup:
            frac = _F(1) - _F(min(max(step, 0), warmup)) / _F(warmup)
            return float(_F(init - lr) * frac + _F(lr))
        count = _F(min(float(step - warmup), decay))
        cosine = _F(0.5) * (_F(1) + _cos32(_F(math.pi) * count / _F(decay)))
        return float(_F(lr) * (_F(1 - alpha) * cosine + _F(alpha)))
    return schedule


def step_decay_schedule(lr, decay_steps, decay, lr_clip):
    """The reference's LambdaLR step decay: lr times ``decay`` per boundary
    passed, at least ``lr_clip`` (in f32, as its jnp arithmetic)."""
    def schedule(step):
        factor = _F(1)
        for s in decay_steps:
            factor = factor * (_F(decay) if step >= s else _F(1))
        return float(max(_F(lr) * factor, _F(lr_clip)))
    return schedule


def build_schedule(optim_cfg, total_steps):
    """The learning rate as a function of the update's index (reference
    ``build_schedule``), or a constant."""
    lr = float(optim_cfg.LR)
    opt = optim_cfg.OPTIMIZER
    if opt == "adam_onecycle":
        return onecycle_schedule(total_steps, lr,
                                 float(optim_cfg.get("PCT_START", 0.4)),
                                 float(optim_cfg.get("DIV_FACTOR", 10)))
    if optim_cfg.get("SCHEDULER", None) == "CosineAnnealing" \
            or opt == "sgd_cosine":
        return warmup_cosine_schedule(total_steps, lr)
    decay_steps = [int(x) for x in optim_cfg.get("DECAY_STEP_LIST", [])]
    if not decay_steps:
        return lr
    return step_decay_schedule(lr, decay_steps,
                               float(optim_cfg.get("LR_DECAY", 0.1)),
                               float(optim_cfg.get("LR_CLIP", 1e-7)))


def global_norm(tensors):
    """sqrt of the sum of squares of every element (optax's global_norm)."""
    return torch.sqrt(sum(t.float().pow(2).sum() for t in tensors))


class Optimizer:
    """The reference's optax chain over torch parameters (see the module
    docstring): ``step()`` clips the gradients (when the config asks),
    sets the learning rate of this update and runs the torch optimizer.
    ``state_dict()`` holds the torch optimizer's state and the update
    count, which the schedule reads."""

    def __init__(self, params, optim_cfg, total_steps):
        self.params = [p for p in params if p.requires_grad]
        opt = optim_cfg.OPTIMIZER
        wd = float(optim_cfg.get("WEIGHT_DECAY", 0.0))
        self.schedule = build_schedule(optim_cfg, total_steps)
        if opt in ("adam", "adam_onecycle"):
            self.torch_optimizer = torch.optim.AdamW(
                self.params, lr=self.lr(0), betas=(0.9, 0.99), eps=1e-8,
                weight_decay=wd)
        elif opt == "sgd":
            self.torch_optimizer = torch.optim.SGD(
                self.params, lr=self.lr(0),
                momentum=float(optim_cfg.get("MOMENTUM", 0.9)),
                weight_decay=wd)
        else:
            raise NotImplementedError(opt)
        self.clip = float(optim_cfg.get("GRAD_NORM_CLIP", 0) or 0)
        self.count = 0

    def lr(self, step):
        return self.schedule(step) if callable(self.schedule) \
            else self.schedule

    def zero_grad(self):
        self.torch_optimizer.zero_grad(set_to_none=True)

    def step(self):
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        if self.clip > 0:
            norm = global_norm(grads)
            if not bool(norm < self.clip):
                for g in grads:
                    g.copy_(g / norm.to(g.dtype) * self.clip)
        for group in self.torch_optimizer.param_groups:
            group["lr"] = self.lr(self.count)
        self.torch_optimizer.step()
        self.count += 1

    def state_dict(self):
        return {"optimizer": self.torch_optimizer.state_dict(),
                "count": self.count}

    def load_state_dict(self, state):
        self.torch_optimizer.load_state_dict(state["optimizer"])
        self.count = int(state["count"])


def build_optimizer(params, optim_cfg, total_steps):
    """-> ``Optimizer`` over ``params`` (reference ``build_optimizer``,
    which returns the optax transformation and its schedule)."""
    return Optimizer(params, optim_cfg, total_steps)
