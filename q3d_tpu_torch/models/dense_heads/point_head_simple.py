"""PointHeadSimple — a foreground score per keypoint (port of
``q3d_tpu/models/dense_heads/point_head.py``: ``_MLP`` :22 and
``PointHeadSimple`` :84, inference only).  ``cls_layers``: per CLS_FC
width a Linear (no bias), BN and ReLU, then the ``out`` Linear to the
classes; ``point_cls_scores`` is the largest sigmoid.  The head reads the
fused ``point_features``, as the reference does whatever
USE_POINT_FEATURES_BEFORE_FUSION says (``ROADMAP.md`` §3).  The targets
and the focal loss come with training."""

import torch
from torch import nn

from ..backbones_3d.pfe.voxel_set_abstraction import f32_batch_norm
from ..layers import Linear


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


class PointHeadSimple(nn.Module):
    def __init__(self, model_cfg, input_channels, num_class):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        self.cls_layers = MLP(input_channels, list(model_cfg.CLS_FC),
                              num_class)

    def forward(self, batch_dict):
        if self.training:
            raise NotImplementedError(
                "PointHeadSimple: the point targets and loss come with "
                "two-stage training")
        logits = self.cls_layers(batch_dict["point_features"])
        batch_dict["point_cls_scores"] = torch.sigmoid(logits).amax(dim=-1)
        return batch_dict
