"""BN statistics for a model with seeded random weights.

A trained model's BNs match their inputs; random weights with identity BNs
fade to constants.  ``calibrate_bns`` gives every BN the statistics of its
own input in one forward, as the chip script, ``tools/nms_ab.py`` and the
anchor-head parity tests set up their seeded models.
"""

import torch

from ..models.layers import BatchNorm, BatchNorm1d
from ..ops.spconv.modules import SparseBatchNorm


def calibrate_bns(model, batch):
    """Every BN's running statistics := the batch statistics (biased
    variance, in f32) of its input in one forward on ``batch``."""
    def calibrate(mod, args):
        x = args[0]
        if isinstance(mod, SparseBatchNorm):
            rows = x.features[x.valid].float()
        elif isinstance(mod, BatchNorm1d):          # (..., C) PFN features
            rows = x.float().reshape(-1, x.shape[-1])
        else:                                       # (N, C, H, W)
            rows = x.float().permute(0, 2, 3, 1).reshape(-1, x.shape[1])
        mod.running_mean.copy_(rows.mean(0))
        mod.running_var.copy_(rows.var(0, unbiased=False))
    hooks = [m.register_forward_pre_hook(calibrate) for m in model.modules()
             if isinstance(m, (SparseBatchNorm, BatchNorm))]
    try:
        with torch.no_grad():
            model(dict(batch))
    finally:
        for h in hooks:
            h.remove()
