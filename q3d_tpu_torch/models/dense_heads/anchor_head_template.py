"""The anchor heads' shared machinery, eval mode (port of
``q3d_tpu/models/dense_heads/anchor_head_template.py:29-72``): the box
coder, the anchors and ``generate_predicted_boxes`` with the direction-bin
correction.

The anchors are laid out (z, y, x, Nsize, Nrot, 7) per class and
concatenated over the classes along the size axis, as the reference's
are; the head's NHWC conv channels are (anchor, code) in that same order,
so the port's NCHW maps are permuted to NHWC before they are flattened to
(B, Na, code).  The target assigner and the losses (:76-141) wait for
training.
"""

import numpy as np
import torch
from torch import nn

from ...utils import box_coder_utils, common_utils
from .target_assigner.anchor_generator import generate_anchors_from_cfg


class AnchorHeadTemplate(nn.Module):
    def __init__(self, model_cfg, num_class, class_names, grid_size,
                 point_cloud_range):
        super().__init__()
        cfg = model_cfg
        self.model_cfg = cfg
        self.num_class = num_class
        self.class_names = tuple(class_names)
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
