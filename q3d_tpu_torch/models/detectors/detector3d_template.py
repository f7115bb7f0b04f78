"""Detector3DTemplate — cfg-driven module slots (port of
``q3d_tpu/models/detectors/detector3d_template.py``, the slots the
CenterPoint path uses: vfe, backbone_3d, map_to_bev_module, backbone_2d,
dense_head)."""

import dataclasses
from typing import Tuple

from torch import nn


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
            self.map_to_bev_module = B.build_map_to_bev(cfg.MAP_TO_BEV)
            num_bev_features = self.map_to_bev_module.num_bev_features
        if cfg.get("BACKBONE_2D", None) is not None:
            self.backbone_2d = B.build_backbone_2d(cfg.BACKBONE_2D,
                                                   num_bev_features)
            num_bev_features = self.backbone_2d.num_bev_features
        if cfg.get("DENSE_HEAD", None) is not None:
            self.dense_head = B.build_dense_head(
                cfg.DENSE_HEAD, num_bev_features, dataset, num_class)

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
