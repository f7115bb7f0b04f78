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
past its position embeddings run in f32, as the reference's do.  Training
(the Hungarian assignment and the set loss) is not ported
(``ROADMAP.md``).
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import BatchNorm, Conv1d, Conv2d
from ..model_utils.centernet_utils import topk_stable
from ..model_utils.transfusion_utils import (TransformerDecoderLayer,
                                             promoting_bn1d)


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

    def forward(self, batch_dict):
        if self.training:
            raise NotImplementedError(
                "TransFusion training (the Hungarian assignment and the set "
                "loss) is not ported yet (ROADMAP.md)")
        res = self.predict(batch_dict["spatial_features_2d"])
        (batch_dict["final_boxes"], batch_dict["final_scores"],
         batch_dict["final_labels"], batch_dict["final_valid"]) = \
            self.final_predictions(res)
        return batch_dict
