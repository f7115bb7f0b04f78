"""AnchorHeadMulti — grouped multi-head anchor prediction (port of
``q3d_tpu/models/dense_heads/anchor_head_multi.py``).

An optional shared 3x3 conv + BN + ReLU (``SHARED_CONV_NUM_FILTER``), then
one tower per ``RPN_HEAD_CFGS`` group of classes: ``NUM_CONVS_PER_HEAD`` x
[3x3 conv, BN, ReLU], then 1x1 ``conv_cls`` (bias -log 99), ``conv_box``
and, with ``USE_DIRECTION_CLASSIFIER``, ``conv_dir``.  The towers' maps are
put back into the template's anchor order (per location the classes in
turn, then each class's sizes and rotations), so the template's target
assignment, losses and decode apply unchanged; the maps are kept in the
batch dict NCHW, as AnchorHeadSingle keeps them.

A tower scores its anchors only for its own classes.  The reference fills
every other class channel of an anchor with a logit of 0, which the
sigmoid makes a score of 0.5, above any usual SCORE_THRESH, so its
per-class NMS takes every other class's anchors at 0.5 (``ROADMAP.md``
§3).  The port fills them with ``ABSENT_LOGIT``, whose sigmoid is exactly
0 in f32 and bf16 and whose focal-loss term is exactly 0.

The BNs return f32 for a bf16 input, as flax's do (``out_f32``), so a bf16
head runs in f32 past its first BN, as the reference's does.
"""

import numpy as np
import torch
from torch import nn

from ..layers import BatchNorm, Conv2d
from .anchor_head_template import AnchorHeadTemplate

# a finite logit (-inf would make the BCE's x * t term NaN) whose sigmoid
# is 0: exp(1e4) overflows f32, so 1 / (1 + exp(-x)) is exactly 0
ABSENT_LOGIT = -1e4


class _HeadTower(nn.Module):
    def __init__(self, num_convs, channels, out_cls, out_box, out_dir):
        super().__init__()
        self.num_convs = num_convs
        for i in range(num_convs):
            self.add_module(f"conv{i}", Conv2d(channels, channels, 3, 1, 1,
                                               bias=False))
            self.add_module(f"norm{i}", BatchNorm(channels))
            getattr(self, f"norm{i}").out_f32 = True
        self.conv_cls = Conv2d(channels, out_cls, 1,
                               bias_init=float(-np.log(99.0)))
        self.conv_box = Conv2d(channels, out_box, 1)
        self.conv_dir = Conv2d(channels, out_dir, 1) if out_dir else None

    def forward(self, x):
        for i in range(self.num_convs):
            x = torch.relu(getattr(self, f"norm{i}")(
                getattr(self, f"conv{i}")(x)))
        dir_ = self.conv_dir(x) if self.conv_dir is not None else None
        return self.conv_cls(x), self.conv_box(x), dir_


class AnchorHeadMulti(AnchorHeadTemplate):
    def __init__(self, model_cfg, input_channels, num_class, class_names,
                 grid_size, point_cloud_range,
                 predict_boxes_when_training=True):
        super().__init__(model_cfg, num_class, class_names, grid_size,
                         point_cloud_range, predict_boxes_when_training)
        cfg = model_cfg
        shared_ch = int(cfg.get("SHARED_CONV_NUM_FILTER", input_channels))
        self.shared_conv = None
        if cfg.get("SHARED_CONV_NUM_FILTER", None):
            self.shared_conv = nn.Sequential(
                Conv2d(input_channels, shared_ch, 3, 1, 1, bias=False),
                BatchNorm(shared_ch))
            self.shared_conv[1].out_f32 = True
        head_cfgs = list(cfg.RPN_HEAD_CFGS) if cfg.get("RPN_HEAD_CFGS", None) \
            else [{"HEAD_CLS_NAME": list(self.class_names)}]
        use_dir = cfg.get("USE_DIRECTION_CLASSIFIER", None)
        code = self.box_coder.code_size
        self.groups = []                    # (class ids, anchors a location)
        towers = []
        for head_cfg in head_cfgs:
            names = [n for n in head_cfg["HEAD_CLS_NAME"]
                     if n in self.class_names]
            cls_ids = [self.class_names.index(n) for n in names]
            n_anchors = sum(self.num_anchors_per_location[i] for i in cls_ids)
            self.groups.append((cls_ids, n_anchors))
            towers.append(_HeadTower(
                int(cfg.get("NUM_CONVS_PER_HEAD", 1)), shared_ch,
                n_anchors * len(names), n_anchors * code,
                n_anchors * cfg.NUM_DIR_BINS if use_dir else 0))
        self.heads = nn.ModuleList(towers)
        # each class's first anchor in a location's anchors (the template's
        # order: the classes in turn)
        self.class_offsets = np.concatenate(
            [[0], np.cumsum(self.num_anchors_per_location)]).tolist()

    def _assemble(self, x):
        """The towers' NCHW maps -> cls (B, A*C, H, W), box (B, A*code, H,
        W) and dir (B, A*bins, H, W) or None, A the anchors a location, in
        the template's anchor order."""
        b, _, h, w = x.shape
        n_anchors = self.class_offsets[-1]
        code = self.box_coder.code_size
        cls_full = box_full = dir_full = None
        for (cls_ids, na_g), tower in zip(self.groups, self.heads):
            cls, box, dir_ = (None if t is None else
                              t.permute(0, 2, 3, 1).reshape(b, h, w, na_g, -1)
                              for t in tower(x))
            if cls_full is None:
                cls_full = cls.new_full((b, h, w, n_anchors, self.num_class),
                                        ABSENT_LOGIT)
                box_full = box.new_zeros((b, h, w, n_anchors, code))
                if dir_ is not None:
                    dir_full = dir_.new_zeros((b, h, w, n_anchors,
                                               dir_.shape[-1]))
            a0 = 0
            for li, ci in enumerate(cls_ids):
                na = self.num_anchors_per_location[ci]
                o = self.class_offsets[ci]
                cls_full[..., o:o + na, ci] = cls[..., a0:a0 + na, li]
                box_full[..., o:o + na, :] = box[..., a0:a0 + na, :]
                if dir_ is not None:
                    dir_full[..., o:o + na, :] = dir_[..., a0:a0 + na, :]
                a0 += na

        def nchw(t):
            return None if t is None else \
                t.reshape(b, h, w, -1).permute(0, 3, 1, 2)
        return nchw(cls_full), nchw(box_full), nchw(dir_full)

    def forward(self, batch_dict):
        x = batch_dict["spatial_features_2d"]               # (B, C, H, W)
        if self.shared_conv is not None:
            x = torch.relu(self.shared_conv(x))
        cls_preds, box_preds, dir_preds = self._assemble(x)
        batch_dict.update(cls_preds=cls_preds, box_preds=box_preds,
                          dir_cls_preds=dir_preds)
        if self.training and self.target_assigner is not None:
            with torch.no_grad():
                targets = self.assign_targets(batch_dict["gt_boxes"].float())
            loss, tb = self.get_loss({"cls_preds": cls_preds,
                                      "box_preds": box_preds,
                                      "dir_cls_preds": dir_preds, **targets})
            batch_dict["loss"] = batch_dict.get("loss", 0.0) + loss
            batch_dict["tb_dict"] = {**batch_dict.get("tb_dict", {}), **tb}
        if not self.training or self.predict_boxes_when_training:
            batch_dict["batch_cls_preds"], batch_dict["batch_box_preds"] = \
                self.generate_predicted_boxes(x.shape[0], cls_preds,
                                              box_preds, dir_preds)
            batch_dict["cls_preds_normalized"] = False
        return batch_dict
