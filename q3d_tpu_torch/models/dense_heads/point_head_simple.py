"""PointHeadSimple — a foreground score per keypoint (port of
``q3d_tpu/models/dense_heads/point_head.py``: ``_MLP`` :22,
``PointHeadTemplate.assign_targets`` :53 and ``PointHeadSimple`` :84).
``cls_layers``: per CLS_FC width a Linear (no bias), BN and ReLU, then the
``out`` Linear to the classes; ``point_cls_scores`` is the largest
sigmoid.  The head reads the fused ``point_features``, as the reference
does whatever USE_POINT_FEATURES_BEFORE_FUSION says (``ROADMAP.md`` §3).

In training each keypoint gets a target: the class of the first gt box
that holds it, -1 (ignored) if it lies only in a box grown by 0.2 m on
each side (the default ``extra_width``; GT_EXTRA_WIDTH is not read, as in
the reference), else 0; and the sigmoid focal loss over the cared
keypoints, normalised by the positives, is ``point_cls_loss``.  A
class-agnostic head (one class) takes every foreground keypoint as
positive, as OpenPCDet's does; the reference gives the gt's class id,
which its one-hot turns into a negative for every class but the first
(``ROADMAP.md`` §3)."""

import torch
from torch import nn

from ...ops.roiaware_pool3d import points_in_boxes
from ...utils import box_utils, loss_utils
from ..backbones_3d.pfe.voxel_set_abstraction import f32_batch_norm
from ..layers import Linear

EXTRA_WIDTH = (0.2, 0.2, 0.2)


class MLP(nn.Module):
    """The reference's ``_MLP``: fc<i> (no bias), norm<i>, ReLU, then
    ``out`` with a bias."""

    def __init__(self, in_channels, channels, out_channels):
        super().__init__()
        self.num_layers = len(channels)
        for i, c in enumerate(channels):
            self.add_module(f"fc{i}", Linear(in_channels, c, bias=False))
            self.add_module(f"norm{i}", f32_batch_norm(c))
            in_channels = c
        self.out = Linear(in_channels, out_channels)

    def forward(self, x):
        for i in range(self.num_layers):
            x = torch.relu(getattr(self, f"norm{i}")(
                getattr(self, f"fc{i}")(x)))
        return self.out(x)


def assign_point_targets(xyz, batch_idx, gt_boxes, num_class,
                         extra_width=EXTRA_WIDTH):
    """Per-point class targets (the reference's ``assign_targets``): xyz
    (N, 3), batch_idx (N,), gt_boxes (B, M, 8) -> (N,) int64: the class of
    the first valid gt box holding the point (1 for a one-class head), -1
    inside only an enlarged valid box, else 0."""
    return assign_point_boxes(xyz, batch_idx, gt_boxes, num_class,
                              extra_width)[0]


def assign_point_boxes(xyz, batch_idx, gt_boxes, num_class,
                       extra_width=EXTRA_WIDTH):
    """``assign_point_targets`` -> (labels, box index (N,) int64): the
    labels, and per point the index within its frame's gt rows of the
    first box that holds it (0 where none does), as the reference's
    ``assign_targets`` returns them."""
    m = gt_boxes.shape[1]
    labels = torch.zeros_like(batch_idx, dtype=torch.long)
    box_idx = torch.zeros_like(labels)
    for b in range(gt_boxes.shape[0]):
        boxes = gt_boxes[b]
        idx = points_in_boxes(xyz, boxes[:, :7])
        idx_big = points_in_boxes(
            xyz, box_utils.enlarge_box3d(boxes[:, :7], extra_width))
        valid_box = boxes[:, -1] > 0
        safe = idx.clamp(0, m - 1)
        cls = boxes[safe, -1].long() if num_class > 1 \
            else torch.ones_like(safe)
        cls = torch.where((idx >= 0) & valid_box[safe], cls,
                          torch.zeros_like(cls))
        ignored = (idx < 0) & (idx_big >= 0) \
            & valid_box[idx_big.clamp(0, m - 1)]
        cls = torch.where(ignored, torch.full_like(cls, -1), cls)
        mine = batch_idx == b
        labels = torch.where(mine, cls, labels)
        box_idx = torch.where(mine, safe, box_idx)
    return labels, box_idx


class PointHeadSimple(nn.Module):
    def __init__(self, model_cfg, input_channels, num_class):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        self.cls_layers = MLP(input_channels, list(model_cfg.CLS_FC),
                              num_class)

    def forward(self, batch_dict):
        logits = self.cls_layers(batch_dict["point_features"])
        batch_dict["point_cls_scores"] = torch.sigmoid(logits).amax(dim=-1)
        if self.training:
            loss = self.get_loss(logits, batch_dict["point_coords"],
                                 batch_dict["gt_boxes"])
            batch_dict["loss"] = batch_dict.get("loss", 0.0) + loss
            batch_dict["tb_dict"] = {**batch_dict.get("tb_dict", {}),
                                     "point_cls_loss": loss}
        return batch_dict

    def get_loss(self, logits, point_coords, gt_boxes):
        """The focal loss of the keypoints' logits against their targets
        (reference :92-107); ``point_coords`` (N, 4) [b, x, y, z] as the
        VSA gives them."""
        with torch.no_grad():
            labels = assign_point_targets(
                point_coords[:, 1:4], point_coords[:, 0].long(),
                gt_boxes.float(), self.num_class)
        valid = point_coords[:, 0] >= 0
        cared = (labels >= 0) & valid
        one_hot = nn.functional.one_hot(
            labels.clamp(min=0), self.num_class + 1)[..., 1:].float()
        positives = ((labels > 0) & valid).sum().float().clamp_min(1.0)
        weights = cared.float() / positives
        weight = self.model_cfg.LOSS_CONFIG.LOSS_WEIGHTS["point_cls_weight"]
        return loss_utils.sigmoid_focal_cls_loss(
            logits[None].float(), one_hot[None], weights[None]).sum() \
            * weight
