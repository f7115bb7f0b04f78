"""AnchorHeadSingle — 1x1 conv cls/box/dir head, eval mode (port of
``q3d_tpu/models/dense_heads/anchor_head_single.py``).  The conv maps are
kept in the batch dict (NCHW) as ``cls_preds``, ``box_preds`` and
``dir_cls_preds``; the decoded boxes go to the detector's
``post_processing``."""

import numpy as np

from ..layers import Conv2d
from .anchor_head_template import AnchorHeadTemplate


class AnchorHeadSingle(AnchorHeadTemplate):
    def __init__(self, model_cfg, input_channels, num_class, class_names,
                 grid_size, point_cloud_range):
        super().__init__(model_cfg, num_class, class_names, grid_size,
                         point_cloud_range)
        n_anchors = sum(self.num_anchors_per_location)
        self.conv_cls = Conv2d(input_channels, n_anchors * num_class, 1,
                               bias_init=float(-np.log((1 - 0.01) / 0.01)))
        self.conv_box = Conv2d(input_channels,
                               n_anchors * self.box_coder.code_size, 1)
        self.conv_dir_cls = Conv2d(
            input_channels, n_anchors * model_cfg.NUM_DIR_BINS, 1) \
            if model_cfg.get("USE_DIRECTION_CLASSIFIER", None) is not None \
            else None

    def forward(self, batch_dict):
        x = batch_dict["spatial_features_2d"]               # (B, C, H, W)
        cls_preds = self.conv_cls(x)
        box_preds = self.conv_box(x)
        dir_preds = self.conv_dir_cls(x) if self.conv_dir_cls is not None \
            else None
        batch_dict.update(cls_preds=cls_preds, box_preds=box_preds,
                          dir_cls_preds=dir_preds)
        batch_dict["batch_cls_preds"], batch_dict["batch_box_preds"] = \
            self.generate_predicted_boxes(x.shape[0], cls_preds, box_preds,
                                          dir_preds)
        batch_dict["cls_preds_normalized"] = False
        return batch_dict
