"""The anchor heads' shared machinery (port of
``q3d_tpu/models/dense_heads/anchor_head_template.py``): the box coder, the
anchors, the target assigner, the losses (focal classification, smooth-L1
on the sin-difference heading, direction-bin cross-entropy) and
``generate_predicted_boxes`` with the direction-bin correction.

The anchors are laid out (z, y, x, Nsize, Nrot, 7) per class and
concatenated over the classes along the size axis, as the reference's
are; the head's NHWC conv channels are (anchor, code) in that same order,
so the port's NCHW maps are permuted to NHWC before they are flattened to
(B, Na, code).  The assigner's targets come out in that order too.
"""

import numpy as np
import torch
from torch import nn

from ...utils import box_coder_utils, common_utils, loss_utils
from .target_assigner.anchor_generator import generate_anchors_from_cfg
from .target_assigner.axis_aligned_target_assigner import \
    AxisAlignedTargetAssigner


class AnchorHeadTemplate(nn.Module):
    def __init__(self, model_cfg, num_class, class_names, grid_size,
                 point_cloud_range, predict_boxes_when_training=True):
        super().__init__()
        cfg = model_cfg
        self.model_cfg = cfg
        self.num_class = num_class
        self.class_names = tuple(class_names)
        self.predict_boxes_when_training = predict_boxes_when_training
        self.box_coder = getattr(box_coder_utils,
                                 cfg.get("BOX_CODER", "ResidualCoder"))(
            num_dir_bins=cfg.get("NUM_DIR_BINS", 6),
            **cfg.get("BOX_CODER_CONFIG", {}))
        anchors, self.num_anchors_per_location = generate_anchors_from_cfg(
            cfg.ANCHOR_GENERATOR_CONFIG, np.asarray(grid_size),
            point_cloud_range, anchor_ndim=max(self.box_coder.code_size, 7))
        cat = np.concatenate(anchors, axis=-3)
        # (Na, 7): the reference's cat(anchors, dim=-3).view(-1, 7)
        self.register_buffer("anchors", torch.from_numpy(
            np.ascontiguousarray(cat.reshape(-1, cat.shape[-1]))),
            persistent=False)
        assigner_cfg = cfg.get("TARGET_ASSIGNER_CONFIG", None)
        self.target_assigner = None
        if assigner_cfg is not None:
            self.target_assigner = AxisAlignedTargetAssigner(
                cfg, self.class_names, box_coder=self.box_coder,
                match_height=assigner_cfg.get("MATCH_HEIGHT", False))
            for name, table in zip(
                    ("anchor_cls", "matched_thresh", "unmatched_thresh"),
                    self.target_assigner.anchor_tables(anchors)):
                self.register_buffer(name, torch.from_numpy(table),
                                     persistent=False)

    @staticmethod
    def _flat(preds, batch_size, na):
        """(B, A*D, H, W) NCHW -> (B, Na, D) in the reference's NHWC order."""
        return preds.permute(0, 2, 3, 1).reshape(batch_size, na, -1)

    def generate_predicted_boxes(self, batch_size, cls_preds, box_preds,
                                 dir_cls_preds=None):
        """cls/box/dir preds: (B, A*D, H, W) -> (batch_cls (B, Na, C),
        batch_box (B, Na, 7+)), decoded against the anchors."""
        cfg = self.model_cfg
        na = self.anchors.shape[0]
        batch_cls = self._flat(cls_preds, batch_size, na)
        batch_box = self.box_coder.decode(
            self._flat(box_preds, batch_size, na), self.anchors[None])
        if dir_cls_preds is not None:
            dir_offset = cfg.DIR_OFFSET
            dir_labels = self._flat(dir_cls_preds, batch_size, na).argmax(-1)
            period = 2 * np.pi / cfg.NUM_DIR_BINS
            dir_rot = common_utils.limit_period(
                batch_box[..., 6] - dir_offset, cfg.DIR_LIMIT_OFFSET, period)
            rot = dir_rot + dir_offset + period * dir_labels.to(batch_box.dtype)
            batch_box = torch.cat([batch_box[..., :6], rot[..., None],
                                   batch_box[..., 7:]], dim=-1)
        return batch_cls, batch_box

    # ------------------------------ training ------------------------------

    def assign_targets(self, gt_boxes):
        """gt_boxes (B, M, 8), zero-padded -> the assigner's targets, in the
        head's anchor order."""
        return self.target_assigner.assign_targets(
            self.anchors, self.anchor_cls, self.matched_thresh,
            self.unmatched_thresh, gt_boxes)

    @staticmethod
    def add_sin_difference(boxes1, boxes2, dim=6):
        """The heading residual as sin(a - b) = sin a cos b - cos a sin b,
        split over the two boxes."""
        rad_pred = torch.sin(boxes1[..., dim]) * torch.cos(boxes2[..., dim])
        rad_tg = torch.cos(boxes1[..., dim]) * torch.sin(boxes2[..., dim])
        b1 = torch.cat([boxes1[..., :dim], rad_pred[..., None],
                        boxes1[..., dim + 1:]], dim=-1)
        b2 = torch.cat([boxes2[..., :dim], rad_tg[..., None],
                        boxes2[..., dim + 1:]], dim=-1)
        return b1, b2

    def get_direction_target(self, reg_targets, one_hot=True):
        """The direction bin of each anchor's target heading, (B, Na) or
        one-hot (B, Na, NUM_DIR_BINS)."""
        cfg = self.model_cfg
        rot_gt = reg_targets[..., 6] + self.anchors[None, :, 6]
        offset_rot = common_utils.limit_period(rot_gt - cfg.DIR_OFFSET, 0,
                                               2 * np.pi)
        dir_cls = torch.clamp((offset_rot / (2 * np.pi / cfg.NUM_DIR_BINS))
                              .to(torch.int64), 0, cfg.NUM_DIR_BINS - 1)
        if one_hot:
            return nn.functional.one_hot(dir_cls, cfg.NUM_DIR_BINS).to(
                reg_targets.dtype)
        return dir_cls

    def get_loss(self, forward_ret):
        """The losses of a training forward (reference :98-141) -> (total,
        tb_dict of rpn_loss_cls, rpn_loss_loc, rpn_loss_dir, rpn_loss)."""
        lw = self.model_cfg.LOSS_CONFIG.LOSS_WEIGHTS
        labels = forward_ret["box_cls_labels"]                  # (B, Na)
        reg_targets = forward_ret["box_reg_targets"]
        reg_weights = forward_ret["reg_weights"]
        b, na = labels.shape

        cared = labels >= 0
        positives = labels > 0
        cls_weights = (cared & (labels == 0)).to(torch.float32) \
            + positives.to(torch.float32)
        pos_norm = torch.clamp_min(
            positives.sum(dim=1, keepdim=True).to(torch.float32), 1.0)
        cls_weights = cls_weights / pos_norm

        cls_flat = self._flat(forward_ret["cls_preds"], b, na)
        one_hot = nn.functional.one_hot(
            torch.where(cared, labels, 0), self.num_class + 1).to(
            cls_flat.dtype)[..., 1:]
        cls_loss = loss_utils.sigmoid_focal_cls_loss(
            cls_flat, one_hot, cls_weights).sum() / b * lw["cls_weight"]

        box_p, box_t = self.add_sin_difference(
            self._flat(forward_ret["box_preds"], b, na), reg_targets)
        smooth_l1 = loss_utils.WeightedSmoothL1Loss(
            code_weights=lw.get("code_weights", None))
        loc_loss = smooth_l1(box_p, box_t, reg_weights).sum() / b \
            * lw["loc_weight"]

        total = cls_loss + loc_loss
        tb = {"rpn_loss_cls": cls_loss, "rpn_loss_loc": loc_loss}
        if forward_ret.get("dir_cls_preds", None) is not None:
            dir_targets = self.get_direction_target(reg_targets)
            dir_logits = self._flat(forward_ret["dir_cls_preds"], b, na)
            weights = positives.to(torch.float32)
            weights = weights / torch.clamp_min(
                weights.sum(-1, keepdim=True), 1.0)
            dir_loss = loss_utils.weighted_cross_entropy(
                dir_logits, dir_targets, weights).sum() / b * lw["dir_weight"]
            total = total + dir_loss
            tb["rpn_loss_dir"] = dir_loss
        tb["rpn_loss"] = total
        return total, tb
