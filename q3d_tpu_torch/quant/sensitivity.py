"""Quantization sensitivity analysis: per-layer activation diffs, bit-width
sweeps, alpha sweeps (port of ``q3d_tpu/quant/sensitivity.py``).

The reference captures every module's output with flax's
``capture_intermediates``; here forward hooks on the quantizable modules
capture theirs, keyed by ``utils.weights.reference_module_path``, so that
a report names the same layers as the reference's (a sparse conv's output
is its features, a dense conv's its NCHW map).  The model carries its
rules, so ``layer_l1_diff`` takes the float model and its quantized copy.
"""

import dataclasses

import numpy as np
import torch

from .rules import QuantRules


def capture_layer_outputs(model, batch):
    """One forward of ``model`` on ``batch`` -> {reference path: output}
    of every quantizable module."""
    from ..utils.weights import reference_module_path
    from .api import quantizable_modules

    out, hooks = {}, []

    def hook(path):
        def grab(_mod, _args, y):
            y = getattr(y, "features", y)
            if isinstance(y, torch.Tensor) and y.dim() >= 1:
                out[path] = y.detach()
        return grab
    for name, mod in quantizable_modules(model):
        path = reference_module_path(name, mod)
        if path is not None:
            hooks.append(mod.register_forward_hook(hook(path)))
    try:
        with torch.no_grad():
            model(dict(batch))
    finally:
        for h in hooks:
            h.remove()
    return out


def layer_l1_diff(float_model, quant_model, batch, top=30):
    """Per-layer mean-L1 between float and quantized activations, sorted
    worst first: rows (path, l1, l1 / mean |float|) (the reference's
    get_l1_loss report)."""
    fp = capture_layer_outputs(float_model, batch)
    q = capture_layer_outputs(quant_model, batch)
    rows = []
    for name, a in fp.items():
        b = q.get(name)
        if b is None or a.shape != b.shape or not a.is_floating_point() \
                or not b.is_floating_point():
            continue
        a, b = a.float(), b.float()
        l1 = float((a - b).abs().mean())
        ref = float(a.abs().mean()) + 1e-12
        rows.append((name, l1, l1 / ref))
    rows.sort(key=lambda r: -r[2])
    return rows[:top]


def with_bits(rules: QuantRules, w_bits=None, act_bits=None) -> QuantRules:
    """Clone a rule set at different bit widths (sweep helper)."""
    new_rules = []
    for r in rules.rules:
        w = dataclasses.replace(r.weight, num_bits=w_bits) \
            if (r.weight and w_bits) else r.weight
        a = dataclasses.replace(r.act, num_bits=act_bits) \
            if (r.act and act_bits) else r.act
        new_rules.append(dataclasses.replace(r, weight=w, act=a))
    return dataclasses.replace(rules, rules=tuple(new_rules))


def with_alpha(rules: QuantRules, alpha) -> QuantRules:
    new_rules = []
    for r in rules.rules:
        sq = dataclasses.replace(r.smoothquant, alpha=alpha) \
            if r.smoothquant else None
        new_rules.append(dataclasses.replace(r, smoothquant=sq))
    return dataclasses.replace(rules, rules=tuple(new_rules))


def bit_sweep(eval_fn, base_rules, weight_bits=(16, 8, 4, 3, 2),
              act_bits=(16, 8), logger=None):
    """Accuracy grid over (w_bits, act_bits).  ``eval_fn(rules) -> metric
    dict``."""
    results = {}
    for ab in act_bits:
        for wb in weight_bits:
            rules = with_bits(base_rules, w_bits=wb, act_bits=ab)
            metrics = eval_fn(rules)
            results[(wb, ab)] = metrics
            if logger:
                logger.info(f"W{wb}A{ab}: {metrics}")
    return results


def alpha_sweep(eval_fn, base_rules, alphas=tuple(np.arange(0.1, 1.0, 0.05)),
                logger=None):
    results = {}
    for a in alphas:
        metrics = eval_fn(with_alpha(base_rules, float(a)))
        results[round(float(a), 3)] = metrics
        if logger:
            logger.info(f"alpha={a:.2f}: {metrics}")
    return results


def top_magnitudes(model, k=5):
    """Largest |weight| entries per parameter of ``model``, by the port's
    name."""
    return {name: np.sort(np.abs(v.detach().cpu().numpy()).ravel())[::-1][:k]
            for name, v in model.named_parameters()}
