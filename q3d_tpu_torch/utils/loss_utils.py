"""Losses (port of ``q3d_tpu/utils/loss_utils.py``): the anchor heads'
sigmoid focal classification loss, weighted smooth-L1 and weighted
cross-entropy (:16-79), and the CenterNet losses (:86-134), the gaussian
focal loss on the heatmaps and the L1 regression at the objects' heatmap
peaks.  Each returns per-element losses (the CenterNet ones their reduced
value), as the reference's do.  The other losses of the reference come
with the heads that use them."""

import torch


def sigmoid_focal_cls_loss(pred, target, weights, alpha=0.25, gamma=2.0):
    """Sigmoid focal loss (RetinaNet form): pred (B, N, C) logits, target
    (B, N, C) one-hot, weights (B, N) or (B, N, C) -> (B, N, C)."""
    pred_sigmoid = torch.sigmoid(pred)
    alpha_weight = target * alpha + (1 - target) * (1 - alpha)
    pt = target * (1.0 - pred_sigmoid) + (1.0 - target) * pred_sigmoid
    focal_weight = alpha_weight * torch.pow(pt, gamma)
    # the numerically stable BCE with logits
    bce = torch.clamp_min(pred, 0) - pred * target \
        + torch.log1p(torch.exp(-torch.abs(pred)))
    loss = focal_weight * bce
    if weights.dim() == 2 or weights.dim() + 1 == pred.dim():
        weights = weights[..., None]
    return loss * weights


def smooth_l1_loss(diff, beta=1.0 / 9.0):
    if beta < 1e-5:
        return torch.abs(diff)
    n = torch.abs(diff)
    return torch.where(n < beta, 0.5 * n ** 2 / beta, n - 0.5 * beta)


class WeightedSmoothL1Loss:
    """Smooth-L1 with optional per-code weights and (B, N) weights; NaN
    targets take the prediction (no loss)."""

    def __init__(self, beta=1.0 / 9.0, code_weights=None):
        self.beta = beta
        self.code_weights = None if code_weights is None \
            else [float(w) for w in code_weights]

    def __call__(self, pred, target, weights=None):
        target = torch.where(torch.isnan(target), pred, target)
        diff = pred - target
        if self.code_weights is not None:
            diff = diff * torch.tensor(self.code_weights, dtype=diff.dtype,
                                       device=diff.device)
        loss = smooth_l1_loss(diff, self.beta)
        if weights is not None:
            loss = loss * weights[..., None]
        return loss


def weighted_cross_entropy(pred, target, weights):
    """pred (B, N, C) logits, target (B, N, C) one-hot, weights (B, N) ->
    (B, N)."""
    logp = torch.log_softmax(pred, dim=-1)
    return -(target * logp).sum(-1) * weights


def _neg_loss(pred, gt, mask=None):
    """Modified gaussian focal loss (CornerNet/CenterNet form): pred is the
    sigmoid heatmap, gt the gaussian-splatted targets of the same shape;
    positives are the cells where gt == 1."""
    pos_inds = (gt == 1.0).to(pred.dtype)
    neg_inds = (gt < 1.0).to(pred.dtype)
    neg_weights = torch.pow(1.0 - gt, 4)
    pred = torch.clamp(pred, 1e-4, 1 - 1e-4)
    pos_loss = torch.log(pred) * torch.pow(1 - pred, 2) * pos_inds
    neg_loss = torch.log(1 - pred) * torch.pow(pred, 2) * neg_weights * neg_inds
    if mask is not None:
        pos_loss = pos_loss * mask
        neg_loss = neg_loss * mask
    num_pos = pos_inds.sum()
    pos_loss = pos_loss.sum()
    neg_loss = neg_loss.sum()
    return torch.where(num_pos == 0, -neg_loss,
                       -(pos_loss + neg_loss) / torch.clamp_min(num_pos, 1.0))


class FocalLossCenterNet:
    """Reference ``FocalLossCenterNet``."""

    def __call__(self, out, target, mask=None):
        return _neg_loss(out, target, mask=mask)


class RegLossCenterNet:
    """L1 regression at gathered heatmap peaks (reference
    ``RegLossCenterNet``): pred (B, C, H, W) or already gathered (B, K, C),
    ind (B, K) flat spatial indices, mask (B, K), target (B, K, C)."""

    def __call__(self, pred, mask, ind, target):
        if pred.dim() == 4:
            b, c = pred.shape[:2]
            feat = pred.reshape(b, c, -1)                       # (B, C, HW)
            pred = feat.gather(2, ind[:, None, :].expand(b, c, -1)) \
                .transpose(1, 2)                                # (B, K, C)
        m = mask[..., None].to(pred.dtype)
        loss = torch.abs(pred * m - target * m)
        return loss.sum() / torch.clamp_min(m.sum(), 1e-4)
