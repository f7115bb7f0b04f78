"""PointIntraPartOffsetHead — PartA2's per-voxel segmentation and
intra-object part location (port of ``q3d_tpu/models/dense_heads/
point_head.py:165``, OpenPCDet's ``point_intra_part_head.py``).

Over the UNet's stride-1 ``point_features``: ``cls_layers`` (the
foreground score, ``point_cls_scores`` its largest sigmoid) and
``part_reg_layers`` (``point_part_offset``, the sigmoid of 3 logits: where
the point lies inside its object, in [0, 1]^3 of the box's frame), each
``point_head_simple.MLP``; with ``TARGET_CONFIG.BOX_CODER`` also
``box_layers`` (a ``PointResidualCoder`` box a point, for the loss only).
The points are the voxel centres of ``point_coords`` [b, z, y, x]
(``_point_xyz``).

In training each point gets ``point_head_simple``'s targets with the ring
``TARGET_CONFIG.GT_EXTRA_WIDTH`` (a one-class head labels every foreground
point 1, ``ROADMAP.md`` §3) and, if foreground, its part target: its
offset from its gt box's centre rotated into the box's frame, over the
box's size, + 0.5, clipped to [0, 1] (``part_targets``).  The losses: the
focal loss over the cared points normalised by the positives
(``point_cls_loss``), the binary cross-entropy of the clipped part
probabilities over the positives divided by 3 x max(positives, 1)
(``point_part_loss``) and, with a box branch, the L1 of its residuals over
the positives (``point_box_loss``), each times its LOSS_WEIGHTS entry.
"""

import torch
from torch import nn

from ...utils import box_coder_utils, common_utils, loss_utils
from .point_head_simple import EXTRA_WIDTH, MLP, assign_point_boxes


class PointIntraPartOffsetHead(nn.Module):
    # the part features a PartA2 ROI head pools beside the point features:
    # the part offset and the segmentation score
    PART_CHANNELS = 4

    def __init__(self, model_cfg, input_channels, num_class, voxel_size,
                 point_cloud_range):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.cls_layers = MLP(input_channels, list(model_cfg.CLS_FC),
                              num_class)
        self.part_reg_layers = MLP(input_channels, list(model_cfg.PART_FC), 3)
        target_cfg = model_cfg.get("TARGET_CONFIG", {})
        self.box_coder = None
        if target_cfg.get("BOX_CODER", None) is not None:
            self.box_coder = getattr(box_coder_utils, target_cfg.BOX_CODER)(
                **target_cfg.get("BOX_CODER_CONFIG", {}))
            self.box_layers = MLP(input_channels, list(model_cfg.REG_FC),
                                  self.box_coder.code_size)
        self.extra_width = tuple(target_cfg.get("GT_EXTRA_WIDTH",
                                                EXTRA_WIDTH))

    def point_xyz(self, point_coords):
        """Integer [b, z, y, x] rows -> (voxel centres (N, 3), frame (N,))."""
        return (common_utils.get_voxel_centers(
            point_coords[:, 1:], 1, self.voxel_size, self.point_cloud_range),
            point_coords[:, 0].long())

    def forward(self, batch_dict):
        feats = batch_dict["point_features"]
        cls_logits = self.cls_layers(feats)
        part_logits = self.part_reg_layers(feats)
        batch_dict["point_cls_scores"] = torch.sigmoid(cls_logits).amax(-1)
        batch_dict["point_part_offset"] = torch.sigmoid(part_logits)
        if self.training:
            box_preds = None if self.box_coder is None \
                else self.box_layers(feats)
            terms = self.get_loss(cls_logits, part_logits, box_preds,
                                  batch_dict["point_coords"],
                                  batch_dict["gt_boxes"].float())
            batch_dict["loss"] = batch_dict.get("loss", 0.0) \
                + sum(terms.values())
            batch_dict["tb_dict"] = {**batch_dict.get("tb_dict", {}), **terms}
        return batch_dict

    def part_targets(self, xyz, gt_of_point, labels):
        """(N, 3) part targets: a foreground point's offset in its box's
        frame over the box's size, + 0.5, clipped to [0, 1]; 0 elsewhere
        (reference ``_part_targets``, :194)."""
        rel = common_utils.rotate_points_along_z(
            (xyz - gt_of_point[:, 0:3])[:, None, :], -gt_of_point[:, 6])[:, 0]
        part = rel / gt_of_point[:, 3:6].clamp_min(1e-4) + 0.5
        return torch.where((labels > 0)[:, None], part.clamp(0.0, 1.0),
                           torch.zeros_like(part))

    def get_loss(self, cls_logits, part_logits, box_preds, point_coords,
                 gt_boxes):
        """-> {point_cls_loss, point_part_loss[, point_box_loss]}."""
        lw = self.model_cfg.LOSS_CONFIG.LOSS_WEIGHTS
        xyz, bidx = self.point_xyz(point_coords)
        with torch.no_grad():
            labels, box_idx = assign_point_boxes(
                xyz, bidx, gt_boxes, self.num_class, self.extra_width)
            m = gt_boxes.shape[1]
            gt_of_point = gt_boxes.reshape(-1, gt_boxes.shape[-1])[
                bidx.clamp_min(0) * m + box_idx]
            targets = self.part_targets(xyz, gt_of_point, labels)
        valid = point_coords[:, 0] >= 0
        cared = ((labels >= 0) & valid).float()
        pos = ((labels > 0) & valid).float()
        n_pos = pos.sum().clamp_min(1.0)
        one_hot = nn.functional.one_hot(
            labels.clamp(min=0), self.num_class + 1)[..., 1:].float()
        terms = {"point_cls_loss": loss_utils.sigmoid_focal_cls_loss(
            cls_logits[None].float(), one_hot[None],
            (cared / n_pos)[None]).sum() * lw["point_cls_weight"]}
        prob = torch.sigmoid(part_logits.float()).clamp(1e-6, 1 - 1e-6)
        bce = -(targets * torch.log(prob) + (1 - targets) * torch.log(1 - prob))
        terms["point_part_loss"] = (bce.sum(-1) * pos).sum() / (3.0 * n_pos) \
            * lw["point_part_weight"]
        if box_preds is not None:
            with torch.no_grad():
                box_t = self.box_coder.encode(gt_of_point[:, :7], xyz,
                                              labels.clamp(min=1))
            diff = (box_preds.float() - box_t).abs() * pos[:, None]
            terms["point_box_loss"] = diff.sum() / n_pos \
                * lw.get("point_box_weight", 1.0)
        return terms
