"""Detector3DTemplate — cfg-driven module slots and the generic
post-processing (port of ``q3d_tpu/models/detectors/detector3d_template.py``:
the slots the ported detectors use — vfe, backbone_3d, map_to_bev_module,
backbone_2d, dense_head — and ``post_processing``'s class-agnostic
branch, batched over the frames).  In training mode (``nn.Module.
training``) a detector's forward returns the batch dict with the head's
``loss`` and ``tb_dict`` and runs no post-processing."""

import dataclasses
from typing import Tuple

import torch
from torch import nn

from ..model_utils import model_nms_utils


@dataclasses.dataclass(frozen=True)
class DatasetInfo:
    """Static dataset facts a model build needs."""
    class_names: Tuple[str, ...]
    num_point_features: int
    grid_size: Tuple[int, int, int]            # [nx, ny, nz]
    point_cloud_range: Tuple[float, ...]
    voxel_size: Tuple[float, float, float]


class Detector3DTemplate(nn.Module):
    def __init__(self, model_cfg, num_class, dataset: DatasetInfo):
        super().__init__()
        from .. import builder as B

        self.model_cfg = model_cfg
        self.num_class = num_class
        self.dataset = dataset
        cfg = model_cfg
        num_point_features = dataset.num_point_features
        if cfg.get("VFE", None) is not None:
            self.vfe = B.build_vfe(cfg.VFE, dataset)
            num_point_features = self.vfe.get_output_feature_dim()
        if cfg.get("BACKBONE_3D", None) is not None:
            self.backbone_3d = B.build_backbone_3d(
                cfg.BACKBONE_3D, num_point_features, dataset)
        if cfg.get("MAP_TO_BEV", None) is not None:
            self.map_to_bev_module = B.build_map_to_bev(cfg.MAP_TO_BEV,
                                                        dataset)
            num_bev_features = self.map_to_bev_module.num_bev_features
        if cfg.get("BACKBONE_2D", None) is not None:
            self.backbone_2d = B.build_backbone_2d(cfg.BACKBONE_2D,
                                                   num_bev_features)
            num_bev_features = self.backbone_2d.num_bev_features
        if cfg.get("DENSE_HEAD", None) is not None:
            # decoded boxes in training only for a second stage (reference
            # :88, :92)
            self.dense_head = B.build_dense_head(
                cfg.DENSE_HEAD, num_bev_features, dataset, num_class,
                predict_boxes_when_training=cfg.get("ROI_HEAD") is not None)
        # the NMS kernel's route in post_processing (set_kernel_impl)
        self.kernel_impl = None

    @property
    def class_names(self):
        return self.dataset.class_names

    def init_weights(self, generator):
        """Seeded random init of every layer that has parameters."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def set_kernel_impl(self, impl):
        """Route every kernel op of the model: "cuda", "plain", or None (by
        the tensors' device)."""
        for m in self.modules():
            if hasattr(m, "kernel_impl"):
                m.kernel_impl = impl

    def post_processing(self, batch_dict):
        """Sigmoid, the best class per box, then one class-agnostic NMS over
        the frames (reference :127-164; each frame is one candidate set of
        kernel 2) -> fixed-size final_boxes/scores/labels/valid (B, P)."""
        post_cfg = self.model_cfg.POST_PROCESSING
        nms_cfg = post_cfg.NMS_CONFIG
        if nms_cfg.get("MULTI_CLASSES_NMS", False):
            raise NotImplementedError(
                "multi_classes_nms is not ported yet (ROADMAP.md)")
        cls_preds = batch_dict["batch_cls_preds"]           # (B, Na, C)
        box_preds = batch_dict["batch_box_preds"]           # (B, Na, 7+)
        if not batch_dict.get("cls_preds_normalized", False):
            cls_preds = torch.sigmoid(cls_preds)
        max_scores = cls_preds.amax(dim=-1)
        # argmax: the first of tied classes, as the reference's
        labels = cls_preds.argmax(dim=-1) + 1
        idx, valid = model_nms_utils.class_agnostic_nms(
            max_scores, box_preds[..., :7], nms_cfg,
            score_thresh=post_cfg.get("SCORE_THRESH", None),
            impl=self.kernel_impl)
        batch_dict["final_boxes"] = box_preds.gather(
            1, idx[..., None].expand(-1, -1, box_preds.shape[-1]))
        batch_dict["final_scores"] = max_scores.gather(1, idx)
        batch_dict["final_labels"] = labels.gather(1, idx)
        batch_dict["final_valid"] = valid
        return batch_dict
