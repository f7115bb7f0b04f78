"""CenterHead — CenterPoint's class-grouped heatmap head.

Port of ``q3d_tpu/models/dense_heads/center_head.py`` (``SeparateHead``,
``assign_targets_one_head``, ``get_loss_one_head``, ``__call__``,
``_decode``, ``_nms``): shared 3x3 conv, per-class-group branches; in train
mode (``nn.Module.training``) the gaussian heatmap targets and the focal +
L1 losses per head, else the top-K decode per head, then ONE batched NMS
over the stacked (heads x batch) candidate sets.  Module slots follow
pcdet's, so a pcdet-named state dict loads strictly.
"""

import numpy as np
import torch
from torch import nn

from ...utils import loss_utils
from ..layers import Conv2d, BatchNorm, DenseRequant
from ..model_utils import centernet_utils, model_nms_utils


class SeparateHead(nn.Module):
    """Per-group regression branches (reference center_head.py:12-46): each
    branch is (num_conv - 1) x [conv BN ReLU] then an output conv."""

    def __init__(self, sep_head_dict, input_channels, init_bias=-2.19,
                 use_bias=False, bn_eps=1e-5, bn_mom=0.1):
        super().__init__()
        self.names = list(sep_head_dict)
        for name, spec in sep_head_dict.items():
            layers = [nn.Sequential(
                Conv2d(input_channels, input_channels, 3, 1, 1, bias=use_bias),
                BatchNorm(input_channels, eps=bn_eps, momentum=bn_mom),
                nn.ReLU())
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
        self.class_names = tuple(class_names)
        bn_eps = cfg.get("BN_EPS", 1e-5)
        bn_mom = cfg.get("BN_MOM", 0.1)
        use_bias = cfg.get("USE_BIAS_BEFORE_NORM", False)
        ch = cfg.SHARED_CONV_CHANNEL
        self.shared_conv = nn.Sequential(
            Conv2d(input_channels, ch, 3, 1, 1, bias=use_bias),
            BatchNorm(ch, eps=bn_eps, momentum=bn_mom), nn.ReLU())
        # int8 residency (the reference's shared_requant): the shared map is
        # quantized once and the int8 branch convs take it as it is; a
        # no-op otherwise
        self.shared_requant = DenseRequant()
        heads = []
        for names in self.class_names_each_head:
            head_dict = {k: dict(v) for k, v in cfg.SEPARATE_HEAD_CFG.HEAD_DICT.items()}
            head_dict["hm"] = {"out_channels": len(names),
                               "num_conv": cfg.NUM_HM_CONV}
            heads.append(SeparateHead(head_dict, ch, init_bias=-2.19,
                                      use_bias=use_bias, bn_eps=bn_eps,
                                      bn_mom=bn_mom))
        self.heads_list = nn.ModuleList(heads)
        self.kernel_impl = None

    # -------------------------- target assignment -------------------------

    def assign_targets_one_head(self, gt_boxes, head_class_ids, num_classes,
                                feat_hw):
        """gt_boxes (B, M, 8+) padded [box, class id], head_class_ids the
        head's global class ids (0-based) -> heatmap (B, C, H, W), boxes
        (B, M, code), inds (B, M), mask (B, M): the reference's vmapped
        ``assign_targets_one_head`` (:102-149).

        The regression target carries the box's columns past its class id
        (velocity) into the head's extra channels; a box without them (the
        synthetic scenes are single static sweeps) gets 0 there, so a head
        with a vel branch trains on velocity 0 (the reference's target has
        no such columns and cannot train such a head on these scenes)."""
        cfg = self.model_cfg.TARGET_ASSIGNER_CONFIG
        h, w = feat_hw
        stride = cfg.FEATURE_MAP_STRIDE
        dev = gt_boxes.device
        n_names = len(self.class_names)
        gt_cls_global = gt_boxes[..., -1].to(torch.int32) - 1     # 0-based
        mapping = torch.full((n_names + 1,), -1, dtype=torch.long, device=dev)
        for local, gid in enumerate(np.asarray(head_class_ids)):
            mapping[int(gid)] = local
        local_cls = mapping[gt_cls_global.clamp(0, n_names).long()]
        valid = (gt_boxes[..., -1] > 0) & (local_cls >= 0)

        pcr, vs = self.point_cloud_range, self.voxel_size
        coord_x = (gt_boxes[..., 0] - pcr[0]) / vs[0] / stride
        coord_y = (gt_boxes[..., 1] - pcr[1]) / vs[1] / stride
        coord_x = torch.clamp(coord_x, 0, w - 0.5)
        coord_y = torch.clamp(coord_y, 0, h - 0.5)
        center = torch.stack([coord_x, coord_y], dim=-1)
        center_int = torch.floor(center).to(torch.int32)

        dx = gt_boxes[..., 3] / vs[0] / stride
        dy = gt_boxes[..., 4] / vs[1] / stride
        radius = centernet_utils.gaussian_radius(dx, dy, cfg.GAUSSIAN_OVERLAP)
        radius = torch.clamp_min(radius.to(torch.int32), cfg.MIN_RADIUS)
        valid = valid & (dx > 0) & (dy > 0)

        heatmap = centernet_utils.splat_gaussians(
            center, radius, local_cls, valid, num_classes, h, w)

        inds = center_int[..., 1].long() * w + center_int[..., 0].long()
        inds = torch.where(valid, inds, 0)
        extra = centernet_utils.extra_targets(gt_boxes, self.code_size - 8)
        ret_boxes = torch.cat([
            center - center_int.to(center.dtype),
            gt_boxes[..., 2:3],
            torch.log(torch.clamp_min(gt_boxes[..., 3:6], 1e-6)),
            torch.cos(gt_boxes[..., 6:7]), torch.sin(gt_boxes[..., 6:7]),
            extra], dim=-1)
        ret_boxes = torch.where(valid[..., None], ret_boxes, 0.0)
        return heatmap, ret_boxes, inds, valid

    @property
    def code_size(self):
        """Channels of the concatenated regression branches."""
        head_dict = self.model_cfg.SEPARATE_HEAD_CFG.HEAD_DICT
        return sum(int(head_dict[k]["out_channels"])
                   for k in self.model_cfg.SEPARATE_HEAD_CFG.HEAD_ORDER)

    def get_loss_one_head(self, pred, target, head_order, code_weights, lw):
        """(hm_loss, loc_loss) of one head (reference :151-166): the focal
        loss on the clipped sigmoid heatmap, and the code-weighted L1 of
        the regression branches at the objects' peaks."""
        hm = torch.clamp(torch.sigmoid(pred["hm"]), 1e-4, 1 - 1e-4)
        hm_loss = loss_utils.FocalLossCenterNet()(hm, target["heatmap"]) \
            * lw["cls_weight"]
        preds = torch.cat([pred[k] for k in head_order], dim=1)  # (B, C, H, W)
        b, c = preds.shape[:2]
        gathered = preds.reshape(b, c, -1).gather(
            2, target["inds"][:, None, :].expand(b, c, -1)).transpose(1, 2)
        m = target["mask"][..., None].to(preds.dtype)
        diff = torch.abs(gathered * m - target["boxes"] * m)
        diff = diff * torch.as_tensor(code_weights, dtype=diff.dtype,
                                      device=diff.device)
        loc_loss = diff.sum() / torch.clamp_min(m.sum(), 1e-4) \
            * lw["loc_weight"]
        return hm_loss, loc_loss

    # ------------------------------ forward -------------------------------

    def forward(self, batch_dict):
        x = self.shared_requant(
            self.shared_conv(batch_dict["spatial_features_2d"]))
        pred_dicts = [head(x) for head in self.heads_list]
        batch_dict["pred_dicts"] = pred_dicts
        if self.training:
            self._losses(batch_dict, pred_dicts, x.shape[2:])
        else:
            self._nms(batch_dict, *self._decode(pred_dicts))
        return batch_dict

    def _losses(self, batch_dict, pred_dicts, feat_hw):
        """The train branch (reference :168-193): per head its targets and
        losses; ``loss`` is their sum, ``tb_dict`` holds
        ``hm_loss_head_i`` and ``loc_loss_head_i``."""
        cfg = self.model_cfg
        lw = cfg.LOSS_CONFIG.LOSS_WEIGHTS
        total, tb = 0.0, {}
        for idx, pred in enumerate(pred_dicts):
            ids = self.class_id_mapping_each_head[idx]
            with torch.no_grad():
                heat, boxes, inds, mask = self.assign_targets_one_head(
                    batch_dict["gt_boxes"].float(), ids, len(ids), feat_hw)
            target = {"heatmap": heat, "boxes": boxes, "inds": inds,
                      "mask": mask}
            hm_loss, loc_loss = self.get_loss_one_head(
                pred, target, cfg.SEPARATE_HEAD_CFG.HEAD_ORDER,
                lw["code_weights"], lw)
            total = total + hm_loss + loc_loss
            tb[f"hm_loss_head_{idx}"] = hm_loss
            tb[f"loc_loss_head_{idx}"] = loc_loss
        batch_dict["loss"] = batch_dict.get("loss", 0.0) + total
        batch_dict["tb_dict"] = {**batch_dict.get("tb_dict", {}), **tb}

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
