"""VoxelNeXtHead — the fully sparse CenterPoint-style head, inference (port
of ``q3d_tpu/models/dense_heads/voxelnext_head.py``: ``SparseSeparateHead``,
``__call__``'s eval branch, ``_merge_double_flip`` and ``_predict``).

Each head's branches are SubMConv2d stacks over the backbone's 2D voxel
rows: (num_conv - 1) x [conv, BN, ReLU] with KERNEL_SIZE_HEAD, then a 1x1
output conv with bias.  The boxes are decoded straight from the voxel rows
(sigmoid heatmap, exp dims, atan2 rotation, x and y from the voxel index
plus the centre offset), each frame keeps its top MAX_OBJ_PER_SAMPLE
(heatmap row, class) pairs by a stable sort (``centernet_utils.
topk_stable``: the off-frame rows tie at -1), and the (heads x frames)
candidate sets go to kernel 2 in one NMS.  Module slots follow pcdet's
(``heads_list.{i}.{name}.{k}.0/.1``, ``{name}.{num_conv - 1}``), so a
pcdet-named state dict loads strictly.

In train mode (``nn.Module.training``) the head computes its losses
instead (reference ``__call__``'s train branch, :164-193): per head and
frame the sparse gaussian targets over the frame's active voxel rows
(``assign_targets_one_head``), the heatmap target the max over the frames,
then ``FocalLossSparse`` on the clipped sigmoid heatmap and
``RegLossSparse`` on the regression branches at each object's nearest
active voxel.  Training runs no double flip.
"""

import numpy as np
import torch
from torch import nn

from ...ops.spconv import SubMConv2d
from ...ops.spconv.sparse_tensor import BIG_KEY
from ...utils import loss_utils
from ..backbones_3d.spconv_backbone_voxelnext import (_Sparse2dConvBNReLU,
                                                      segment_sum,
                                                      sort_segments)
from ..model_utils import centernet_utils
from .center_head import CenterHead


class _Branch(nn.Sequential):
    def forward(self, st, cache):
        for layer in self:
            st = layer(st, cache)
        return st


class SparseSeparateHead(nn.Module):
    """A head's branches (reference :25-52) -> {name: (N, out) features}."""

    def __init__(self, sep_head_dict, input_channels, kernel_size=3):
        super().__init__()
        self.names = list(sep_head_dict)
        for name, spec in sep_head_dict.items():
            layers = [_Sparse2dConvBNReLU(input_channels, input_channels,
                                          kernel_size, 1, kernel_size // 2,
                                          "subm")
                      for _ in range(int(spec["num_conv"]) - 1)]
            layers.append(SubMConv2d(input_channels, int(spec["out_channels"]),
                                     1, 1, 0, bias=True,
                                     indice_key=name + "out"))
            setattr(self, name, _Branch(*layers))

    def forward(self, st, cache):
        return {name: getattr(self, name)(st, cache).features
                for name in self.names}


class VoxelNeXtHead(nn.Module):
    def __init__(self, model_cfg, input_channels, num_class, class_names,
                 grid_size, point_cloud_range, voxel_size):
        super().__init__()
        cfg = model_cfg
        self.model_cfg = cfg
        self.point_cloud_range = tuple(point_cloud_range)
        self.voxel_size = tuple(voxel_size)
        self.feature_map_stride = cfg.TARGET_ASSIGNER_CONFIG.get(
            "FEATURE_MAP_STRIDE", 8)
        self.double_flip = bool(cfg.get("DOUBLE_FLIP", False))
        self.class_names_each_head = []
        self.class_id_mapping_each_head = []
        for names in cfg.CLASS_NAMES_EACH_HEAD:
            present = [x for x in names if x in class_names]
            self.class_names_each_head.append(present)
            self.class_id_mapping_each_head.append(
                np.array([list(class_names).index(x) for x in present],
                         np.int64))
        self.class_names = tuple(class_names)
        heads = []
        for names in self.class_names_each_head:
            head_dict = {k: dict(v)
                         for k, v in cfg.SEPARATE_HEAD_CFG.HEAD_DICT.items()}
            head_dict["hm"] = {"out_channels": len(names),
                               "num_conv": cfg.NUM_HM_CONV}
            heads.append(SparseSeparateHead(
                head_dict, input_channels,
                kernel_size=int(cfg.get("KERNEL_SIZE_HEAD", 3))))
        self.heads_list = nn.ModuleList(heads)
        self.kernel_impl = None

    code_size = CenterHead.code_size

    def assign_targets_one_head(self, gt_boxes, head_class_ids, num_classes,
                                voxel_xy, voxel_batch, voxel_valid, b_idx):
        """The sparse targets of one head and one frame (reference :93-149):
        gt_boxes (M, 8+) of frame ``b_idx`` [box, class id], voxel_xy (N, 2)
        [x, y] cells of the rows -> heatmap (N, C), boxes (M, code), inds
        (M,), mask (M,).

        Each object's gaussian (radius from ``gaussian_radius``, at least
        MIN_RADIUS) is evaluated at the frame's active rows within the
        radius of its continuous centre, and the class rows take the max.
        ``inds`` is each object's nearest active row of the frame (the
        lowest row among ties, as ``jnp.argmin``), ``mask`` marks the
        objects of this head's classes that have one.  The regression
        target is [centre - nearest cell, z, log dims, cos, sin, the box's
        columns past its class id] (``centernet_utils.extra_targets``: a
        box without velocity columns trains ``vel`` on velocity 0, as
        CenterHead's does)."""
        cfg = self.model_cfg.TARGET_ASSIGNER_CONFIG
        stride = self.feature_map_stride
        dev = gt_boxes.device
        m = gt_boxes.shape[0]
        n_names = len(self.class_names)
        mapping = torch.full((n_names + 1,), -1, dtype=torch.long, device=dev)
        for local, gid in enumerate(np.asarray(head_class_ids)):
            mapping[int(gid)] = local
        gt_cls = gt_boxes[:, -1].to(torch.int32) - 1
        local_cls = mapping[gt_cls.clamp(0, n_names).long()]
        pcr, vs = self.point_cloud_range, self.voxel_size
        cx = (gt_boxes[:, 0] - pcr[0]) / vs[0] / stride
        cy = (gt_boxes[:, 1] - pcr[1]) / vs[1] / stride
        dx = gt_boxes[:, 3] / vs[0] / stride
        dy = gt_boxes[:, 4] / vs[1] / stride
        radius = torch.clamp_min(centernet_utils.gaussian_radius(
            dx, dy, cfg.GAUSSIAN_OVERLAP).to(torch.int32),
            cfg.MIN_RADIUS).float()
        valid_obj = (gt_boxes[:, -1] > 0) & (local_cls >= 0) & (dx > 0) \
            & (dy > 0)

        in_frame = (voxel_batch == b_idx) & voxel_valid              # (N,)
        xy = voxel_xy.float()
        ddx = xy[None, :, 0] - cx[:, None]                           # (M, N)
        ddy = xy[None, :, 1] - cy[:, None]
        d2 = ddx ** 2 + ddy ** 2
        r = radius[:, None]
        inside = (ddx.abs() <= r) & (ddy.abs() <= r)
        del ddx, ddy
        sigma = (2 * r + 1) / 6.0
        g = torch.exp(-d2 / torch.clamp_min(2 * sigma ** 2, 1e-6))
        g = torch.where(inside & valid_obj[:, None] & in_frame[None, :], g,
                        0.0)
        del inside
        n = voxel_xy.shape[0]
        cls_row = torch.where(valid_obj, local_cls, num_classes)
        heatmap = g.new_zeros((num_classes + 1, n))
        heatmap.scatter_reduce_(0, cls_row[:, None].expand(m, n), g,
                                reduce="amax")
        del g
        d2 = torch.where(in_frame[None, :], d2, torch.inf)
        inds = torch.argmin(d2, dim=1)                               # (M,)
        mask = valid_obj & torch.isfinite(d2.gather(1, inds[:, None])[:, 0])
        del d2
        nearest = xy[inds]
        extra = centernet_utils.extra_targets(gt_boxes, self.code_size - 8)
        ret_boxes = torch.cat([
            torch.stack([cx, cy], 1) - nearest, gt_boxes[:, 2:3],
            torch.log(torch.clamp_min(gt_boxes[:, 3:6], 1e-6)),
            torch.cos(gt_boxes[:, 6:7]), torch.sin(gt_boxes[:, 6:7]), extra],
            dim=1)
        ret_boxes = torch.where(mask[:, None], ret_boxes, 0.0)
        return heatmap[:num_classes].t(), ret_boxes, inds, mask

    def forward(self, batch_dict):
        st = batch_dict["encoded_spconv_tensor"]
        cache = {}
        pred_dicts = [head(st, cache) for head in self.heads_list]
        batch_dict["pred_dicts"] = pred_dicts
        if self.training:
            self._losses(batch_dict, st, pred_dicts)
        else:
            self._nms(batch_dict, *self._candidates(st, pred_dicts))
        return batch_dict

    def _losses(self, batch_dict, st, pred_dicts):
        """The train branch (reference :164-193): per head, the targets of
        each frame (without gradient, one frame at a time), the heatmap
        target the max over the frames; ``FocalLossSparse`` over the valid
        rows and ``RegLossSparse`` of the HEAD_ORDER branches; ``loss`` is
        their weighted sum, ``tb_dict`` holds ``hm_loss_head_i`` and
        ``loc_loss_head_i``."""
        cfg = self.model_cfg
        lw = cfg.LOSS_CONFIG.LOSS_WEIGHTS
        voxel_xy = torch.stack([st.indices[:, 2], st.indices[:, 1]], dim=1)
        voxel_batch, voxel_valid = st.indices[:, 0], st.valid
        gt_boxes = batch_dict["gt_boxes"].float()
        total, tb = 0.0, {}
        for idx, pred in enumerate(pred_dicts):
            ids = self.class_id_mapping_each_head[idx]
            with torch.no_grad():
                targets = [self.assign_targets_one_head(
                    gt_boxes[b], ids, len(ids), voxel_xy, voxel_batch,
                    voxel_valid, b) for b in range(st.batch_size)]
                heat = torch.stack([t[0] for t in targets]).amax(0)
                boxes, inds, mask = (torch.stack([t[i] for t in targets])
                                     for i in (1, 2, 3))
                del targets
            hm = torch.clamp(torch.sigmoid(pred["hm"].float()), 1e-4,
                             1 - 1e-4)
            hm_loss = loss_utils.FocalLossSparse()(
                hm, heat, valid=voxel_valid) * lw["cls_weight"]
            preds = torch.cat([pred[k].float()
                               for k in cfg.SEPARATE_HEAD_CFG.HEAD_ORDER],
                              dim=-1)
            loc_loss = loss_utils.RegLossSparse()(preds, mask, inds, boxes) \
                * lw["loc_weight"]
            total = total + hm_loss + loc_loss
            tb[f"hm_loss_head_{idx}"] = hm_loss
            tb[f"loc_loss_head_{idx}"] = loc_loss
        batch_dict["loss"] = batch_dict.get("loss", 0.0) + total
        batch_dict["tb_dict"] = {**batch_dict.get("tb_dict", {}), **tb}

    def _candidates(self, st, pred_dicts):
        """The NMS candidate sets of the branch outputs over the rows of
        ``st`` (``_decode``; under double flip after ``_merge_double_flip``,
        on the frames before the expansion)."""
        if self.double_flip:
            merged = [self._merge_double_flip(p, st) for p in pred_dicts]
            _, m_xy, m_batch, m_valid = merged[0]
            return self._decode([m[0] for m in merged], m_xy, m_batch,
                                m_valid, st.batch_size // 4,
                                pre_activated=True)
        voxel_xy = torch.stack([st.indices[:, 2], st.indices[:, 1]], dim=1)
        return self._decode(pred_dicts, voxel_xy, st.indices[:, 0], st.valid,
                            st.batch_size)

    def _merge_double_flip(self, pred, st):
        """Un-flip the 4 TTA sub-batches and average the rows that land on
        one cell (reference :207-270: a stable sort by the un-flipped key and
        a segment mean) -> (merged predictions, hm sigmoided and dim
        exponentiated; voxel xy; frame; valid), at the input's row
        capacity."""
        h, w = (int(s) for s in st.spatial_shape)
        vb = st.indices[:, 0].long()
        y, x = st.indices[:, 1].long(), st.indices[:, 2].long()
        valid = st.valid
        variant = torch.remainder(vb, 4)
        orig = torch.div(vb, 4, rounding_mode="floor")
        fy = (variant == 1) | (variant == 3)          # y-mirrored copies
        fx = variant >= 2                              # x-mirrored copies
        yy = torch.where(fy, h - 1 - y, y)
        xx = torch.where(fx, w - 1 - x, x)

        def flip(v, neg_x, neg_y):
            return torch.stack([torch.where(fx, neg_x(v[:, 0]), v[:, 0]),
                                torch.where(fy, neg_y(v[:, 1]), v[:, 1])], 1)
        # the sub-cell offset mirrors to 1 - c on a flipped axis
        out = {"hm": torch.sigmoid(pred["hm"]), "dim": torch.exp(pred["dim"]),
               "center": flip(pred["center"], lambda c: 1.0 - c,
                              lambda c: 1.0 - c),
               "center_z": pred["center_z"],
               "rot": flip(pred["rot"], torch.neg, torch.neg)}
        if "vel" in pred:
            out["vel"] = flip(pred["vel"], torch.neg, torch.neg)

        order, slot, ukeys = sort_segments(orig * (h * w) + yy * w + xx,
                                           valid)
        n = slot.shape[0]
        cnt = torch.bincount(slot, minlength=n + 1)[:n].float()
        denom = torch.clamp_min(cnt, 1.0)[:, None]
        merged = {k: (segment_sum(v[order].float(), slot, n) / denom).to(
            v.dtype) for k, v in out.items()}
        m_valid = ukeys != BIG_KEY
        m_batch = torch.where(m_valid, torch.div(ukeys, h * w,
                                                 rounding_mode="floor"), -1)
        rem = torch.remainder(ukeys, h * w)
        m_xy = torch.stack([torch.where(m_valid, rem % w, 0),
                            torch.where(m_valid, rem // w, 0)], 1)
        return merged, m_xy, m_batch, m_valid

    def _decode(self, pred_dicts, voxel_xy, voxel_batch, voxel_valid,
                batch_size, pre_activated=False):
        """Per head, per frame: the top MAX_OBJ_PER_SAMPLE (row, class)
        scores of the frame's rows, their boxes decoded from the rows, the
        score threshold and the centre limit range (reference ``_predict``,
        :272-322, before its NMS) -> the stacked (heads x frames) candidate
        sets, head-major: boxes, scores, labels (1-based global), valid."""
        pp = self.model_cfg.POST_PROCESSING
        k = int(pp.MAX_OBJ_PER_SAMPLE)
        stride = self.feature_map_stride
        vs, pcr = self.voxel_size, self.point_cloud_range
        dev = voxel_xy.device
        lim = torch.as_tensor(list(pp.POST_CENTER_LIMIT_RANGE),
                              dtype=torch.float32, device=dev)
        frames = torch.arange(batch_size, device=dev)
        in_frame = (voxel_batch[None, :] == frames[:, None]) \
            & voxel_valid[None, :]                               # (B, N)
        xy = voxel_xy.float()
        out = []
        for idx, pred in enumerate(pred_dicts):
            hm = pred["hm"].float()
            hm = hm if pre_activated else torch.sigmoid(hm)      # (N, C)
            c = hm.shape[1]
            dims = pred["dim"].float()
            dims = dims if pre_activated else torch.exp(dims)
            rot = torch.atan2(pred["rot"][:, 1].float(),
                              pred["rot"][:, 0].float())
            center = pred["center"].float()
            xs = (xy[:, 0] + center[:, 0]) * stride * vs[0] + pcr[0]
            ys = (xy[:, 1] + center[:, 1]) * stride * vs[1] + pcr[1]
            parts = [xs[:, None], ys[:, None], pred["center_z"].float(),
                     dims, rot[:, None]]
            if "vel" in pred:
                parts.append(pred["vel"].float())
            boxes_all = torch.cat(parts, dim=1)                  # (N, 7/9)
            flat = torch.where(in_frame[:, :, None], hm[None],
                               torch.full((), -1.0, device=dev))
            scores, flat_idx = centernet_utils.topk_stable(
                flat.reshape(batch_size, -1), k)                 # (B, K)
            vox, cls = flat_idx // c, flat_idx % c
            boxes = boxes_all[vox]                               # (B, K, 7/9)
            valid = (scores > pp.SCORE_THRESH) \
                & (boxes[..., :3] >= lim[:3]).all(-1) \
                & (boxes[..., :3] <= lim[3:6]).all(-1)
            ids = torch.as_tensor(self.class_id_mapping_each_head[idx],
                                  device=dev)
            out.append((boxes, scores, ids[cls] + 1, valid))
        return [torch.cat(t, dim=0) for t in zip(*out)]

    _nms = CenterHead._nms
