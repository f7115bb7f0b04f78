"""Axis-aligned anchor-to-gt matching, on the device, batched over the frames
(port of ``q3d_tpu/models/dense_heads/target_assigner/
axis_aligned_target_assigner.py``).

One (B, Na, M) IoU of every anchor with every padded gt box (nearest-BEV,
or 3D under MATCH_HEIGHT), with class identity enforced by masking, then
per anchor its best gt, per gt its best IoU: an anchor is foreground when
its best IoU reaches its class's matched threshold, or when it ties a gt's
best IoU (> 0) (the forced match); background below the unmatched
threshold; ignored (-1) in between.  No host loop and no host sync.

The targets come out in the head's anchor order (z, y, x, class, size,
rotation), the order of the head's conv channels and of the anchors the
losses and the decode read.  The reference lays its targets out class by
class instead, so that for more than one class its label at an index
belongs to another anchor than its prediction there; the port does not
copy that (``ROADMAP.md`` §3).
"""

import numpy as np
import torch

from ....ops.iou3d_nms.iou3d_nms_utils import boxes_iou3d
from ....utils import box_utils


class AxisAlignedTargetAssigner:
    def __init__(self, model_cfg, class_names, box_coder, match_height=False):
        cfg = model_cfg.TARGET_ASSIGNER_CONFIG
        self.box_coder = box_coder
        self.match_height = match_height
        self.class_names = list(class_names)
        gen = model_cfg.ANCHOR_GENERATOR_CONFIG
        self.anchor_class_names = [c["class_name"] for c in gen]
        self.matched_thresholds = {c["class_name"]: c["matched_threshold"]
                                   for c in gen}
        self.unmatched_thresholds = {c["class_name"]: c["unmatched_threshold"]
                                     for c in gen}
        self.norm_by_num_examples = cfg.get("NORM_BY_NUM_EXAMPLES", False)

    def anchor_tables(self, anchors_list):
        """Per-class anchors (nz, ny, nx, Ns, Nr, 7+) -> numpy (class id,
        matched threshold, unmatched threshold) of each anchor, (Na,) each,
        in the head's order (the classes concatenated along the size
        axis)."""
        cols = []
        for name, anch in zip(self.anchor_class_names, anchors_list):
            shape = anch.shape[:-1]
            cols.append(np.stack([
                np.full(shape, self.class_names.index(name) + 1, np.float32),
                np.full(shape, self.matched_thresholds[name], np.float32),
                np.full(shape, self.unmatched_thresholds[name], np.float32),
            ], axis=-1))
        cat = np.concatenate(cols, axis=-2).reshape(-1, 3)
        return cat[:, 0].astype(np.int64), cat[:, 1], cat[:, 2]

    def assign_targets(self, anchors, anchor_cls, m_thresh, u_thresh,
                       gt_boxes_with_classes):
        """anchors (Na, 7+) in the head's order, with each anchor's class id
        and thresholds (Na,); gt_boxes_with_classes (B, M, 8), zero rows
        padding -> dict of box_cls_labels (B, Na) int64, box_reg_targets
        (B, Na, code), reg_weights (B, Na), matched_gt_boxes (B, Na, 7)."""
        gt_boxes = gt_boxes_with_classes[..., :7]
        gt_cls = gt_boxes_with_classes[..., -1].to(torch.int64)
        gt_valid = gt_cls > 0                                      # (B, M)
        if self.match_height:
            iou = boxes_iou3d(anchors[None, :, :7], gt_boxes)
        else:
            iou = box_utils.boxes3d_nearest_bev_iou(anchors[:, :7], gt_boxes)
        same_cls = anchor_cls[None, :, None] == gt_cls[:, None, :]
        iou = torch.where(same_cls & gt_valid[:, None, :], iou,
                          iou.new_tensor(-1.0))                    # (B, Na, M)

        # argmax: the first of tied maxima, as jnp.argmax
        anchor_best_iou, anchor_best_gt = iou.amax(dim=2), iou.argmax(dim=2)
        gt_best_iou = iou.amax(dim=1)                              # (B, M)
        # the forced match: anchors that tie a gt's best IoU (> 0)
        force = (iou == gt_best_iou[:, None, :]) \
            & (gt_best_iou[:, None, :] > 0) & gt_valid[:, None, :]
        force_any = force.any(dim=2)
        force_gt = force.to(torch.uint8).argmax(dim=2)

        matched = anchor_best_iou >= m_thresh
        assigned_gt = torch.where(force_any & ~matched, force_gt,
                                  anchor_best_gt)
        fg = matched | force_any
        bg = (anchor_best_iou < u_thresh) & ~fg

        labels = torch.where(fg, gt_cls.gather(1, assigned_gt),
                             torch.where(bg, 0, -1))
        matched_boxes = gt_boxes.gather(
            1, assigned_gt[..., None].expand(-1, -1, gt_boxes.shape[-1]))
        reg_targets = self.box_coder.encode(matched_boxes,
                                            anchors[None, :, :7])
        reg_targets = torch.where(fg[..., None], reg_targets,
                                  reg_targets.new_tensor(0.0))
        reg_weights = fg.to(torch.float32)
        if self.norm_by_num_examples:
            norm = (labels >= 0).sum(dim=1, keepdim=True)
        else:
            norm = fg.sum(dim=1, keepdim=True)
        reg_weights = reg_weights / torch.clamp_min(norm.to(torch.float32),
                                                    1.0)
        return {"box_cls_labels": labels, "box_reg_targets": reg_targets,
                "reg_weights": reg_weights,
                "matched_gt_boxes": torch.where(
                    fg[..., None], matched_boxes,
                    matched_boxes.new_tensor(0.0))}
