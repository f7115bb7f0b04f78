"""CenterHead — CenterPoint's class-grouped heatmap head, eval mode.

Port of ``q3d_tpu/models/dense_heads/center_head.py`` (``SeparateHead``,
``__call__``, ``_decode``, ``_nms``): shared 3x3 conv, per-class-group
branches, top-K decode per head, then ONE batched NMS over the stacked
(heads x batch) candidate sets.  Target assignment and losses are not part
of the port yet.  Module slots follow pcdet's, so a pcdet-named state dict
loads strictly.
"""

import numpy as np
import torch
from torch import nn

from ..layers import Conv2d, BatchNorm
from ..model_utils import centernet_utils, model_nms_utils


class SeparateHead(nn.Module):
    """Per-group regression branches (reference center_head.py:12-46): each
    branch is (num_conv - 1) x [conv BN ReLU] then an output conv."""

    def __init__(self, sep_head_dict, input_channels, init_bias=-2.19,
                 use_bias=False, bn_eps=1e-5):
        super().__init__()
        self.names = list(sep_head_dict)
        for name, spec in sep_head_dict.items():
            layers = [nn.Sequential(
                Conv2d(input_channels, input_channels, 3, 1, 1, bias=use_bias),
                BatchNorm(input_channels, eps=bn_eps), nn.ReLU())
                for _ in range(int(spec["num_conv"]) - 1)]
            layers.append(Conv2d(input_channels, int(spec["out_channels"]), 3,
                                 1, 1, bias=True,
                                 bias_init=init_bias if "hm" in name else 0.0))
            setattr(self, name, nn.Sequential(*layers))

    def forward(self, x):
        return {name: getattr(self, name)(x) for name in self.names}


class CenterHead(nn.Module):
    def __init__(self, model_cfg, input_channels, num_class, class_names,
                 grid_size, point_cloud_range, voxel_size):
        super().__init__()
        cfg = model_cfg
        self.model_cfg = cfg
        self.point_cloud_range = tuple(point_cloud_range)
        self.voxel_size = tuple(voxel_size)
        self.feature_map_stride = cfg.TARGET_ASSIGNER_CONFIG.get(
            "FEATURE_MAP_STRIDE", None)
        self.class_names_each_head = []
        self.class_id_mapping_each_head = []
        for names in cfg.CLASS_NAMES_EACH_HEAD:
            present = [x for x in names if x in class_names]
            self.class_names_each_head.append(present)
            self.class_id_mapping_each_head.append(
                np.array([list(class_names).index(x) for x in present], np.int64))
        bn_eps = cfg.get("BN_EPS", 1e-5)
        use_bias = cfg.get("USE_BIAS_BEFORE_NORM", False)
        ch = cfg.SHARED_CONV_CHANNEL
        self.shared_conv = nn.Sequential(
            Conv2d(input_channels, ch, 3, 1, 1, bias=use_bias),
            BatchNorm(ch, eps=bn_eps), nn.ReLU())
        heads = []
        for names in self.class_names_each_head:
            head_dict = {k: dict(v) for k, v in cfg.SEPARATE_HEAD_CFG.HEAD_DICT.items()}
            head_dict["hm"] = {"out_channels": len(names),
                               "num_conv": cfg.NUM_HM_CONV}
            heads.append(SeparateHead(head_dict, ch, init_bias=-2.19,
                                      use_bias=use_bias, bn_eps=bn_eps))
        self.heads_list = nn.ModuleList(heads)
        self.kernel_impl = None

    def forward(self, batch_dict):
        x = self.shared_conv(batch_dict["spatial_features_2d"])
        pred_dicts = [head(x) for head in self.heads_list]
        batch_dict["pred_dicts"] = pred_dicts
        self._nms(batch_dict, *self._decode(pred_dicts))
        return batch_dict

    def _decode(self, pred_dicts):
        """Per-head top-K decode -> the stacked (heads*batch) candidate sets,
        head-major."""
        pp = self.model_cfg.POST_PROCESSING
        out = []
        for idx, pred in enumerate(pred_dicts):
            boxes, scores, cls, valid = centernet_utils.decode_bbox_from_heatmap(
                pred["hm"], pred["rot"][:, 0:1], pred["rot"][:, 1:2],
                pred["center"], pred["center_z"], pred["dim"],
                self.point_cloud_range, self.voxel_size,
                self.feature_map_stride, vel=pred.get("vel"),
                K=pp.MAX_OBJ_PER_SAMPLE, score_thresh=pp.SCORE_THRESH,
                post_center_limit_range=list(pp.POST_CENTER_LIMIT_RANGE))
            ids = torch.as_tensor(self.class_id_mapping_each_head[idx],
                                  device=cls.device)
            out.append((boxes, scores, ids[cls] + 1, valid))
        return [torch.cat(t, dim=0) for t in zip(*out)]

    def _nms(self, batch_dict, sb, ss, sl, sv):
        """ONE NMS over the stacked candidate sets; rows come out of the
        top-K decode already score-descending."""
        nms_cfg = self.model_cfg.POST_PROCESSING.NMS_CONFIG
        n_heads = len(self.class_names_each_head)
        b = sb.shape[0] // n_heads
        sel, sel_valid = model_nms_utils.class_agnostic_nms(
            ss, sb[..., :7], nms_cfg, box_valid=sv, presorted=True,
            impl=self.kernel_impl)

        def take(x):
            if x.dim() == 3:
                return x.gather(1, sel[..., None].expand(-1, -1, x.shape[-1]))
            return x.gather(1, sel)

        def unstack(x):                  # (H*B, P, ...) -> (B, H*P, ...)
            return torch.cat([x[i * b:(i + 1) * b] for i in range(n_heads)],
                             dim=1)

        batch_dict["final_boxes"] = unstack(take(sb))
        batch_dict["final_scores"] = unstack(take(ss))
        batch_dict["final_labels"] = unstack(take(sl))
        batch_dict["final_valid"] = unstack(sel_valid)
