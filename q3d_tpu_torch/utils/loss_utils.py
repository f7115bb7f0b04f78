"""CenterNet losses (port of ``q3d_tpu/utils/loss_utils.py:86-134``): the
gaussian focal loss on the heatmaps and the L1 regression at the objects'
heatmap peaks, as CenterHead trains with them.  The other losses of the
reference come with the heads that use them."""

import torch


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
