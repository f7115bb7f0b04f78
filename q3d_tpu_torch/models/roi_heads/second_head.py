"""SECONDHead — the IoU head of SECONDNetIoU (port of
``q3d_tpu/models/roi_heads/second_head.py``).

Each roi (in training each sampled roi, ``RoIHeadTemplate.pooled_rois``)
gets GRID_SIZE x GRID_SIZE points over its BEV footprint, rotated by its
heading, sampled bilinearly from ``spatial_features_2d`` (the port's maps
are NCHW: the map's stride is ``spatial_features_stride`` times the ratio
of the heights of ``spatial_features`` and the 2D map); the samples, grid
point major, go through the shared FCs, ``iou_fc_<i>`` and ``iou_out``:
one IoU logit a roi.

Inference rectifies the first stage's scores: roi_score^(1 - w) x
sigmoid(iou)^w (w = IOU_WEIGHT, 0.5 by default; both clipped to [1e-6,
1]); the boxes, labels and valid flags are the proposals', and no NMS
follows, as in the reference (OpenPCDet's SECONDNetIoU runs class-specific
NMS after; ``ROADMAP.md`` §3).  Training: the binary cross-entropy of the
IoU logit against the sampled rois' IoU-guided class target, averaged,
times LOSS_WEIGHTS.rcnn_cls_weight (``rcnn_iou_loss``), max(x, 0) written
(x + |x|) / 2 as the other ROI heads write it.
"""

import torch

from ...utils import common_utils
from ..backbones_3d.pfe.voxel_set_abstraction import bilinear
from .roi_head_template import RoIHeadTemplate


class SECONDHead(RoIHeadTemplate):
    BRANCHES = ("iou",)

    def __init__(self, model_cfg, input_channels, voxel_size,
                 point_cloud_range):
        grid = int(model_cfg.ROI_GRID_POOL.GRID_SIZE)
        super().__init__(model_cfg, grid * grid * input_channels)
        self.grid = grid
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)

    def grid_xy(self, rois, map_stride):
        """The rois' rotated grid points as map coordinates -> (xs, ys),
        each (B, R * g * g)."""
        b, r = rois.shape[:2]
        g, dev = self.grid, rois.device

        def const(v):
            return torch.tensor(v, dtype=torch.float32, device=dev)
        lin = torch.div(torch.arange(g, dtype=torch.float32, device=dev)
                        + 0.5, const(g)) - 0.5
        gy, gx = torch.meshgrid(lin, lin, indexing="ij")
        local = torch.stack([gx.reshape(-1), gy.reshape(-1),
                             torch.zeros(g * g, device=dev)], -1)
        local = local[None, None] * torch.cat(
            [rois[:, :, None, 3:5], torch.ones_like(rois[:, :, None, :1])], -1)
        rot = common_utils.rotate_points_along_z(
            local.reshape(b * r, -1, 3), rois[..., 6].reshape(-1))
        world = rot.reshape(local.shape)[..., :2] + rois[:, :, None, 0:2]
        pcr, vs = self.point_cloud_range, self.voxel_size
        xs = torch.div(torch.div(world[..., 0].reshape(b, -1) - const(pcr[0]),
                                 const(vs[0])), const(map_stride))
        ys = torch.div(torch.div(world[..., 1].reshape(b, -1) - const(pcr[1]),
                                 const(vs[1])), const(map_stride))
        return xs, ys

    def forward(self, batch_dict):
        rois = self.pooled_rois(batch_dict)
        b, r = rois.shape[:2]
        bev = batch_dict["spatial_features_2d"]                 # (B, C, H, W)
        down = batch_dict["spatial_features"].shape[2] // bev.shape[2]
        stride = batch_dict.get("spatial_features_stride", 1) * max(down, 1)
        xs, ys = self.grid_xy(rois.float(), stride)
        pooled = bilinear(bev, xs, ys)
        iou_preds = self._branch(self.shared(pooled.reshape(b * r, -1)),
                                 "iou").reshape(b, r)
        if self.training:
            targets = batch_dict.pop("rcnn_targets")
            x = iou_preds.float()
            bce = (x + x.abs()) / 2 - x * targets["cls_target"] \
                + torch.log1p(torch.exp(-x.abs()))
            loss = bce.mean() \
                * self.model_cfg.LOSS_CONFIG.LOSS_WEIGHTS["rcnn_cls_weight"]
            batch_dict["loss"] = batch_dict.get("loss", 0.0) + loss
            batch_dict["tb_dict"] = {**batch_dict.get("tb_dict", {}),
                                     "rcnn_iou_loss": loss}
            return batch_dict
        w = float(self.model_cfg.get("IOU_WEIGHT", 0.5))
        iou = torch.sigmoid(iou_preds.float())
        scores = batch_dict["roi_scores"].float()
        batch_dict["final_boxes"] = rois
        batch_dict["final_scores"] = torch.pow(scores.clamp(1e-6, 1.0),
                                               1 - w) \
            * torch.pow(iou.clamp(1e-6, 1.0), w)
        batch_dict["final_labels"] = batch_dict["roi_labels"]
        batch_dict["final_valid"] = batch_dict["roi_valid"]
        return batch_dict
