"""TransFusionHead — the query-based LiDAR head, inference (port of
``q3d_tpu/models/dense_heads/transfusion_head.py``:
``SeparateHeadTransfusion``, ``predict``, ``decode_boxes`` and
``__call__``'s inference branch).

A dense heatmap over the BEV map, peak NMS by a max-pool, the top
NUM_PROPOSALS (class, cell) pairs as queries, one transformer decoder layer
of self-attention among the queries and cross-attention to every BEV cell,
Conv1d regression branches per query, and the query-score decode: the
head's outputs are final, with no NMS.  Maps are NCHW, as the rest of the
port's; the queries and keys are (B, L, C) rows, as the reference's.
Module slots follow OpenPCDet's ``TransFusionHead`` (``shared_conv``,
``heatmap_head.0.conv / .bn``, ``heatmap_head.1``, ``class_encoding``,
``decoder``, ``prediction_head.{name}.{k}.0 / .1``,
``prediction_head.{name}.{num_conv - 1}``).

The head's BNs return the promotion of their input's dtype and f32, as the
reference's flax BNs do, so in a bf16 forward the heatmap and the decoder
past its position embeddings run in f32, as the reference's do.

In train mode (``nn.Module.training``) the head returns the set loss
instead of predictions (reference ``compute_loss``, :174-266): each
query is matched to at most one gt box by a Hungarian assignment on the
host (``hungarian_assignment``), then the sigmoid focal loss of the
queries' classes, the L1 loss of the matched queries' encoded boxes and
the dense heatmap's gaussian focal loss.  The BNs run in train mode; the
heatmap that picks the queries is detached, as the reference's
``stop_gradient``, while the dense heatmap keeps its gradient through its
own loss.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...utils import loss_utils
from ..layers import BatchNorm, Conv1d, Conv2d
from ..model_utils import centernet_utils
from ..model_utils.centernet_utils import topk_stable
from ..model_utils.transfusion_utils import (TransformerDecoderLayer,
                                             clip_sigmoid, promoting_bn1d)


def hungarian_assignment(scores, boxes, gt_boxes):
    """The reference's assignment (:184-200): scores (B, P, classes), the
    queries' sigmoid class scores; boxes (B, P, 7+) decoded; gt_boxes (B,
    M, 8+) [box, class id], the valid rows first -> (B, P) int64, each
    query's gt row or -1.

    The batch goes to the host once; per frame scipy's
    ``linear_sum_assignment`` minimises the cost 0.15 * -score of the gt's
    class + 0.25 * the BEV centre distance over the frame's valid gts, in
    f32 as the reference's callback computes it (the cost weights of
    HUNGARIAN_ASSIGNER are not read, as there); one tensor goes back.  The
    assignment is piecewise constant, so it takes no gradient."""
    from scipy.optimize import linear_sum_assignment
    s, bx, gt = (t.detach().float().cpu().numpy()
                 for t in (scores, boxes, gt_boxes))
    out = np.full(s.shape[:2], -1, np.int64)
    for b in range(s.shape[0]):
        n_gt = int((gt[b, :, -1] > 0).sum())
        if n_gt == 0:
            continue
        g = gt[b, :n_gt]
        cls_cost = -s[b][:, g[:, -1].astype(np.int32) - 1]       # (P, n_gt)
        d = np.linalg.norm(bx[b][:, None, :2] - g[None, :, :2], axis=-1)
        row, col = linear_sum_assignment(0.15 * cls_cost + 0.25 * d)
        out[b, row] = col
    return torch.from_numpy(out).to(scores.device)


class _BasicBlock2D(nn.Module):
    """OpenPCDet's BasicBlock2D: 3x3 conv, BN (eps 1e-5, promoting), ReLU
    (the reference's heatmap_head_conv and heatmap_head_norm)."""

    def __init__(self, in_channels, out_channels, bias):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, 3, 1, 1, bias=bias)
        self.bn = BatchNorm(out_channels, eps=1e-5, momentum=0.1)
        self.bn.out_f32 = True

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


class SeparateHeadTransfusion(nn.Module):
    """Per-branch Conv1d stacks over the queries (reference :29-55): each
    branch is (num_conv - 1) x [Conv1d(head_channels), BN, ReLU], then a
    Conv1d with bias (the reference's initialiser leaves every bias 0, the
    heatmap's too)."""

    def __init__(self, input_channels, head_channels, sep_head_dict,
                 use_bias=False):
        super().__init__()
        self.names = list(sep_head_dict)
        for name, spec in sep_head_dict.items():
            layers, c = [], input_channels
            for _ in range(int(spec["num_conv"]) - 1):
                layers.append(nn.Sequential(
                    Conv1d(c, head_channels, 1, bias=use_bias),
                    promoting_bn1d(head_channels), nn.ReLU()))
                c = head_channels
            layers.append(Conv1d(c, int(spec["out_channels"]), 1, bias=True))
            setattr(self, name, nn.Sequential(*layers))

    def forward(self, x):
        return {name: getattr(self, name)(x) for name in self.names}


class TransFusionHead(nn.Module):
    def __init__(self, model_cfg, input_channels, num_class, class_names,
                 grid_size, point_cloud_range, voxel_size):
        super().__init__()
        cfg = model_cfg
        self.model_cfg = cfg
        self.num_class = num_class
        self.point_cloud_range = tuple(point_cloud_range)
        self.voxel_size = tuple(voxel_size)
        self.feature_map_stride = cfg.TARGET_ASSIGNER_CONFIG.get(
            "FEATURE_MAP_STRIDE", 8)
        dataset = cfg.TARGET_ASSIGNER_CONFIG.get("DATASET", "nuScenes")
        # the small-object classes keep their own heatmap value in the peak
        # NMS (reference :117-124)
        self.small_classes = ([8, 9] if dataset == "nuScenes" and num_class > 9
                              else [1, 2] if dataset == "Waymo"
                              and num_class > 2 else [])
        hidden = self.hidden = cfg.HIDDEN_CHANNEL
        self.num_proposals = cfg.NUM_PROPOSALS
        self.nms_kernel_size = cfg.NMS_KERNEL_SIZE
        bias = cfg.get("USE_BIAS_BEFORE_NORM", False)
        self.shared_conv = Conv2d(input_channels, hidden, 3, 1, 1)
        self.heatmap_head = nn.Sequential(
            _BasicBlock2D(hidden, hidden, bias),
            Conv2d(hidden, num_class, 3, 1, 1, bias_init=-2.19))
        self.class_encoding = Conv1d(num_class, hidden, 1)
        self.decoder = TransformerDecoderLayer(
            hidden, cfg.NUM_HEADS, cfg.FFN_CHANNEL, cfg.ACTIVATION)
        heads = {k: dict(v)
                 for k, v in cfg.SEPARATE_HEAD_CFG.HEAD_DICT.items()}
        heads["heatmap"] = {"out_channels": num_class,
                            "num_conv": cfg.NUM_HM_CONV}
        self.prediction_head = SeparateHeadTransfusion(hidden, 64, heads,
                                                       use_bias=bias)

    # ------------------------------ stages --------------------------------

    def dense_heatmap(self, bev):
        """bev (B, C_in, H, W) -> (shared feature (B, hidden, H, W), dense
        heatmap logits (B, classes, H, W))."""
        feat = self.shared_conv(bev)
        return feat, self.heatmap_head(feat)

    def proposals(self, dense_heatmap):
        """Peak NMS, then the class-major top NUM_PROPOSALS (reference
        :107-132) -> (class-major sigmoid heatmap (B, classes, H*W) after
        the NMS, top classes (B, P), top cells (B, P)).  A cell survives
        where it equals the max of its k x k window; the border rows and
        columns, which the unpadded window never centres on, are zeroed,
        and the small-object classes keep every cell.  The top-K is a
        stable sort: suppressed cells tie at exactly 0, and the lower index
        comes first, as ``lax.top_k``'s."""
        b, c, h, w = dense_heatmap.shape
        heatmap = torch.sigmoid(dense_heatmap).detach()
        pad = self.nms_kernel_size // 2
        local_max = torch.zeros_like(heatmap)
        local_max[:, :, pad:h - pad, pad:w - pad] = F.max_pool2d(
            heatmap, self.nms_kernel_size, stride=1)
        for cls in self.small_classes:
            local_max[:, cls] = heatmap[:, cls]
        heatmap = (heatmap * (heatmap == local_max)).reshape(b, c, h * w)
        _, top_idx = topk_stable(heatmap.reshape(b, -1), self.num_proposals)
        return heatmap, top_idx // (h * w), top_idx % (h * w)

    def queries(self, feat, top_class, top_spatial):
        """-> (keys (B, H*W, hidden): the shared feature's cells, query
        features (B, P, hidden): the top cells' plus the class encoding of
        their one-hot class, query positions (B, P, 2) and key positions
        (B, H*W, 2): (x, y) cell centres, in the map's dtype)."""
        b, _, h, w = feat.shape
        dtype = feat.dtype
        keys = feat.flatten(2).transpose(1, 2)
        query = keys.gather(1, top_spatial[..., None].expand(-1, -1,
                                                             keys.shape[2]))
        one_hot = F.one_hot(top_class, self.num_class).to(dtype)
        query = query + self.class_encoding(one_hot)
        query_pos = torch.stack([(top_spatial % w).to(dtype) + 0.5,
                                 (top_spatial // w).to(dtype) + 0.5], dim=-1)
        gy, gx = torch.meshgrid(
            torch.arange(h, device=feat.device, dtype=torch.float32) + 0.5,
            torch.arange(w, device=feat.device, dtype=torch.float32) + 0.5,
            indexing="ij")
        key_pos = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)
        return keys, query, query_pos, key_pos.expand(b, -1, -1).to(dtype)

    def predict(self, bev):
        """bev (B, C_in, H, W) -> res: the branches' (B, P, c) outputs
        (``center`` plus the query position), ``query_heatmap_score`` (B,
        P, classes), ``dense_heatmap`` and ``query_labels`` (reference
        :99-155)."""
        feat, dense_heatmap = self.dense_heatmap(bev)
        heatmap, top_class, top_spatial = self.proposals(dense_heatmap)
        keys, query, query_pos, key_pos = self.queries(feat, top_class,
                                                       top_spatial)
        query = self.decoder(query, keys, query_pos, key_pos)
        res = self.prediction_head(query)
        res["center"] = res["center"] + query_pos
        res["query_heatmap_score"] = heatmap.transpose(1, 2).gather(
            1, top_spatial[..., None].expand(-1, -1, self.num_class))
        res["dense_heatmap"] = dense_heatmap
        res["query_labels"] = top_class
        return res

    def decode_boxes(self, res):
        """(B, P, ...) branch outputs -> boxes (B, P, 7 or 9) in world units
        (reference :157-172)."""
        center = res["center"]
        xs = center[..., 0] * self.feature_map_stride * self.voxel_size[0] \
            + self.point_cloud_range[0]
        ys = center[..., 1] * self.feature_map_stride * self.voxel_size[1] \
            + self.point_cloud_range[1]
        rot = torch.atan2(res["rot"][..., 0], res["rot"][..., 1])
        parts = [xs[..., None], ys[..., None], res["height"],
                 torch.exp(res["dim"]), rot[..., None]]
        if "vel" in res:
            parts.append(res["vel"])
        return torch.cat(parts, dim=-1)

    def final_predictions(self, res):
        """The inference branch (reference :274-289): score = sigmoid of the
        query's class logits x its heatmap score x its one-hot class; the
        best class; valid where the score passes SCORE_THRESH and the
        centre lies in POST_CENTER_RANGE -> (boxes, scores, labels, valid)."""
        pp = self.model_cfg.POST_PROCESSING
        boxes = self.decode_boxes(res)
        one_hot = F.one_hot(res["query_labels"], self.num_class)
        score = torch.sigmoid(res["heatmap"]) * res["query_heatmap_score"] \
            * one_hot
        scores, labels = score.max(dim=-1)
        lim = torch.as_tensor(list(pp.POST_CENTER_RANGE), dtype=boxes.dtype,
                              device=boxes.device)
        valid = (scores > pp.SCORE_THRESH) \
            & (boxes[..., :3] >= lim[:3]).all(-1) \
            & (boxes[..., :3] <= lim[3:6]).all(-1)
        return boxes, scores, labels + 1, valid

    def heatmap_targets(self, gt_boxes, h, w):
        """The dense heatmap's gaussian targets (reference :241-259) ->
        (B, classes, H, W): each gt's gaussian (radius from
        ``gaussian_radius``, at least MIN_RADIUS) at its cell, in its
        class's plane."""
        cfg = self.model_cfg.TARGET_ASSIGNER_CONFIG
        pcr, vs, stride = self.point_cloud_range, self.voxel_size, \
            self.feature_map_stride
        cx = (gt_boxes[..., 0] - pcr[0]) / vs[0] / stride
        cy = (gt_boxes[..., 1] - pcr[1]) / vs[1] / stride
        dx = gt_boxes[..., 3] / vs[0] / stride
        dy = gt_boxes[..., 4] / vs[1] / stride
        radius = torch.clamp_min(centernet_utils.gaussian_radius(
            dx, dy, cfg.GAUSSIAN_OVERLAP).to(torch.int32), cfg.MIN_RADIUS)
        valid = (gt_boxes[..., -1] > 0) & (dx > 0) & (dy > 0)
        return centernet_utils.splat_gaussians(
            torch.stack([cx, cy], dim=-1), radius,
            gt_boxes[..., -1].to(torch.int32) - 1, valid, self.num_class, h, w)

    def compute_loss(self, res, gt_boxes):
        """The set loss of ``predict``'s outputs against gt_boxes (B, M,
        8+) -> (loss, tb_dict) (reference :174-266): the queries matched by
        ``hungarian_assignment``; ``trans_cls_loss``, the sigmoid focal
        loss of every query's class logits against its matched gt's class
        (none for an unmatched query), over the batch's matched count;
        ``trans_bbox_loss``, the L1 of the matched queries' [centre, height,
        dim, rot (sin, cos), vel] against the encoded gt [cells, z, log
        dims, sin, cos, the box's columns past its class id], over the
        matched count; ``trans_hm_loss``, the gaussian focal loss of the
        clipped sigmoid dense heatmap.  A gt without velocity columns
        trains ``vel`` on velocity 0 (the reference takes its class id
        there and cannot build the loss with ``vel``, ``ROADMAP.md`` §3)."""
        cfg = self.model_cfg
        lw = cfg.LOSS_CONFIG.LOSS_WEIGHTS
        gt_boxes = gt_boxes.float()
        cls_logits = res["heatmap"]                               # (B, P, C)
        with torch.no_grad():
            assigned = hungarian_assignment(torch.sigmoid(cls_logits),
                                            self.decode_boxes(res), gt_boxes)
        b, p = assigned.shape
        matched = assigned >= 0
        gt_matched = gt_boxes.gather(1, assigned.clamp_min(0)[..., None].expand(
            -1, -1, gt_boxes.shape[-1]))                          # (B, P, 8+)
        labels = torch.where(matched, gt_matched[..., -1].long() - 1,
                             self.num_class)
        one_hot = F.one_hot(labels, self.num_class + 1)[..., :-1].to(
            cls_logits.dtype)
        n_matched = matched.sum()
        cls_weights = torch.ones((b, p), device=cls_logits.device) \
            / torch.clamp_min(n_matched, 1)
        loss_cls = cfg.LOSS_CONFIG.LOSS_CLS
        cls_loss = loss_utils.sigmoid_focal_cls_loss(
            cls_logits, one_hot, cls_weights, alpha=loss_cls.alpha,
            gamma=loss_cls.gamma).sum() * lw["cls_weight"]

        preds = torch.cat([res["center"], res["height"], res["dim"],
                           res["rot"]] + ([res["vel"]] if "vel" in res
                                          else []), dim=-1)
        pcr, vs, stride = self.point_cloud_range, self.voxel_size, \
            self.feature_map_stride
        extra = centernet_utils.extra_targets(gt_matched, preds.shape[-1] - 8)
        target = torch.cat([
            ((gt_matched[..., 0] - pcr[0]) / (stride * vs[0]))[..., None],
            ((gt_matched[..., 1] - pcr[1]) / (stride * vs[1]))[..., None],
            gt_matched[..., 2:3],
            torch.log(torch.clamp_min(gt_matched[..., 3:6], 1e-6)),
            torch.sin(gt_matched[..., 6:7]), torch.cos(gt_matched[..., 6:7]),
            extra], dim=-1)
        m = matched[..., None].to(preds.dtype)
        bbox_loss = (torch.abs(preds - target) * m).sum() \
            / torch.clamp_min(m.sum(), 1.0) * lw["bbox_weight"]

        dense = res["dense_heatmap"]
        hm_target = self.heatmap_targets(gt_boxes, *dense.shape[2:])
        hm_loss = loss_utils.FocalLossCenterNet()(
            clip_sigmoid(dense.float()), hm_target) * lw["hm_weight"]
        return cls_loss + bbox_loss + hm_loss, {
            "trans_cls_loss": cls_loss, "trans_bbox_loss": bbox_loss,
            "trans_hm_loss": hm_loss}

    def forward(self, batch_dict):
        res = self.predict(batch_dict["spatial_features_2d"])
        if self.training:
            loss, tb = self.compute_loss(res, batch_dict["gt_boxes"])
            batch_dict["loss"] = batch_dict.get("loss", 0.0) + loss
            batch_dict["tb_dict"] = {**batch_dict.get("tb_dict", {}), **tb}
            return batch_dict
        (batch_dict["final_boxes"], batch_dict["final_scores"],
         batch_dict["final_labels"], batch_dict["final_valid"]) = \
            self.final_predictions(res)
        return batch_dict
