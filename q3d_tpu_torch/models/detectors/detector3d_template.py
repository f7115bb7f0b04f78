"""Detector3DTemplate — cfg-driven module slots and the generic
post-processing (port of ``q3d_tpu/models/detectors/detector3d_template.py``:
the slots of ``build_networks`` :47-97 — vfe, backbone_3d,
map_to_bev_module, backbone_2d (PillarNet's fed by its 3D backbone's
multi-scale maps), pfe (the keypoint features, which read the BEV map
before the 2D backbone), dense_head (fed by the 3D backbone in a fully
sparse detector), point_head and roi_head —, the two-stage detectors'
``proposal_layer`` (:99) and ``post_processing``, class-agnostic or per
class (``MULTI_CLASSES_NMS``), batched over the frames).  In training mode
(``nn.Module.training``) a detector's forward returns the batch dict with
the head's ``loss`` and ``tb_dict`` and runs no post-processing."""

import dataclasses
from typing import Optional, Tuple

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
    # the data processor's MAX_NUMBER_OF_VOXELS (None without voxelization)
    max_voxels: Optional[int] = None


class Detector3DTemplate(nn.Module):
    def __init__(self, model_cfg, num_class, dataset: DatasetInfo):
        super().__init__()
        from .. import builder as B

        self.model_cfg = model_cfg
        self.num_class = num_class
        self.dataset = dataset
        cfg = model_cfg
        num_point_features = dataset.num_point_features
        num_bev_features = backbone_channels = None
        if cfg.get("VFE", None) is not None:
            self.vfe = B.build_vfe(cfg.VFE, dataset)
            num_point_features = self.vfe.get_output_feature_dim()
        if cfg.get("BACKBONE_3D", None) is not None:
            self.backbone_3d = B.build_backbone_3d(
                cfg.BACKBONE_3D, num_point_features, dataset)
            num_point_features = self.backbone_3d.num_point_features
            backbone_channels = getattr(self.backbone_3d,
                                        "backbone_channels", None)
        if cfg.get("MAP_TO_BEV", None) is not None:
            self.map_to_bev_module = B.build_map_to_bev(cfg.MAP_TO_BEV,
                                                        dataset)
            num_bev_features = self.map_to_bev_module.num_bev_features
        bev_map_features = num_bev_features
        if cfg.get("BACKBONE_2D", None) is not None:
            self.backbone_2d = B.build_backbone_2d(
                cfg.BACKBONE_2D, num_bev_features, backbone_channels)
            num_bev_features = self.backbone_2d.num_bev_features
        if cfg.get("PFE", None) is not None:
            self.pfe = B.build_pfe(cfg.PFE, dataset, bev_map_features,
                                   backbone_channels)
            num_point_features = self.pfe.num_point_features
        if cfg.get("DENSE_HEAD", None) is not None:
            # decoded boxes in training only for a second stage (reference
            # :88, :92); a fully sparse detector (VoxelNeXt) feeds its head
            # straight from the 3D backbone (reference builder.py:119-123)
            head_in = num_point_features \
                if cfg.DENSE_HEAD.NAME == "VoxelNeXtHead" else num_bev_features
            self.dense_head = B.build_dense_head(
                cfg.DENSE_HEAD, head_in, dataset, num_class,
                predict_boxes_when_training=cfg.get("ROI_HEAD") is not None)
        if cfg.get("POINT_HEAD", None) is not None:
            self.point_head = B.build_point_head(cfg.POINT_HEAD,
                                                 num_point_features,
                                                 num_class, dataset)
        if cfg.get("ROI_HEAD", None) is not None:
            self.roi_head = B.build_roi_head(
                cfg.ROI_HEAD, num_point_features, dataset, backbone_channels,
                num_bev_features, getattr(getattr(self, "point_head", None),
                                          "PART_CHANNELS", 0))
        # the NMS kernel's route in post_processing and proposal_layer
        # (set_kernel_impl)
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

    def roi_nms_config(self):
        """The proposal layer's NMS: ROI_HEAD.NMS_CONFIG.TRAIN in training,
        TEST else."""
        return self.model_cfg.ROI_HEAD.NMS_CONFIG[
            "TRAIN" if self.training else "TEST"]

    @torch.no_grad()
    def proposal_layer(self, batch_dict, nms_config):
        """The first stage's proposals: the sigmoid of the dense head's
        scores, each anchor's best class, and one class-agnostic NMS over
        the frames (one launch of kernel 2, B candidate sets of
        NMS_PRE_MAXSIZE) -> fixed-size (B, R) ``rois``, ``roi_scores``,
        ``roi_labels`` (1-based) and ``roi_valid`` (reference :99-125).
        Without gradient, as OpenPCDet computes its proposals: the
        reference lets the ROI head's losses flow back through the rois
        into the anchor head's box branch (``ROADMAP.md`` §3)."""
        cls_preds = batch_dict["batch_cls_preds"]          # (B, Na, C)
        box_preds = batch_dict["batch_box_preds"]
        if not batch_dict.get("cls_preds_normalized", False):
            cls_preds = torch.sigmoid(cls_preds)
        max_scores = cls_preds.amax(dim=-1)
        labels = cls_preds.argmax(dim=-1) + 1
        idx, valid = model_nms_utils.class_agnostic_nms(
            max_scores, box_preds[..., :7], nms_config, impl=self.kernel_impl)
        batch_dict["rois"] = box_preds[..., :7].gather(
            1, idx[..., None].expand(-1, -1, 7))
        batch_dict["roi_scores"] = max_scores.gather(1, idx)
        batch_dict["roi_labels"] = labels.gather(1, idx)
        batch_dict["roi_valid"] = valid
        return batch_dict

    def post_processing(self, batch_dict):
        """Sigmoid, then NMS over the frames in one call (reference
        :127-164) -> fixed-size final_boxes/scores/labels/valid (B, P).
        Class-agnostic: the best class per box, each frame one candidate
        set of kernel 2.  ``MULTI_CLASSES_NMS``: an NMS per class over the
        class's column (B x C sets), then per frame the C x P results,
        invalid ones scored -1, of which the best NMS_POST_MAXSIZE are
        kept, ties in index order as ``lax.top_k`` keeps them; labels are
        the classes, 1..C."""
        post_cfg = self.model_cfg.POST_PROCESSING
        nms_cfg = post_cfg.NMS_CONFIG
        cls_preds = batch_dict["batch_cls_preds"]           # (B, Na, C)
        box_preds = batch_dict["batch_box_preds"]           # (B, Na, 7+)
        if not batch_dict.get("cls_preds_normalized", False):
            cls_preds = torch.sigmoid(cls_preds)
        if nms_cfg.get("MULTI_CLASSES_NMS", False):
            idx, valid, scores = model_nms_utils.multi_classes_nms(
                cls_preds, box_preds, nms_cfg, post_cfg.SCORE_THRESH,
                impl=self.kernel_impl)
            b, c, p = idx.shape
            labels = torch.arange(1, c + 1, device=idx.device)[:, None] \
                .expand(c, p).reshape(-1)
            top_s, top_i = model_nms_utils.stable_top(
                torch.where(valid, scores, scores.new_tensor(-1.0))
                .reshape(b, c * p), int(nms_cfg.NMS_POST_MAXSIZE))
            sel = idx.reshape(b, c * p).gather(1, top_i)
            batch_dict["final_boxes"] = box_preds.gather(
                1, sel[..., None].expand(-1, -1, box_preds.shape[-1]))
            batch_dict["final_scores"] = top_s
            batch_dict["final_labels"] = labels[top_i]
            batch_dict["final_valid"] = top_s > 0
            return batch_dict
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
