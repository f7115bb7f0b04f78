"""Model builder + batch transfer (port of ``q3d_tpu/models/builder.py``).

The registries hold only what the port has; PillarVFE and
PointPillarScatter take the dataset's geometry, as the reference's
builders give it (:69-76, :99).  ``build_network`` and
``load_data_to_device`` default to the CUDA device and raise when there is
none; pass ``device="cpu"`` explicitly to run on the CPU.
"""

import numpy as np
import torch

from ..utils.common_utils import resolve_device
from .backbones_2d.base_bev_backbone import BaseBEVBackbone
from .backbones_2d.map_to_bev.height_compression import HeightCompression
from .backbones_2d.map_to_bev.pointpillar_scatter import PointPillarScatter
from .backbones_3d.spconv_backbone import VoxelBackBone8x, VoxelResBackBone8x
from .backbones_3d.vfe.mean_vfe import MeanVFE
from .backbones_3d.vfe.pillar_vfe import PillarVFE
from .dense_heads.anchor_head_single import AnchorHeadSingle
from .dense_heads.center_head import CenterHead
from .detectors.centerpoint import CenterPoint
from .detectors.detector3d_template import DatasetInfo
from .detectors.pointpillar import PointPillar
from .detectors.second_net import SECONDNet

_VFE = {"MeanVFE": MeanVFE, "PillarVFE": PillarVFE}
_BACKBONE_3D = {"VoxelBackBone8x": VoxelBackBone8x,
                "VoxelResBackBone8x": VoxelResBackBone8x}
_MAP_TO_BEV = {"HeightCompression": HeightCompression,
               "PointPillarScatter": PointPillarScatter}
_BACKBONE_2D = {"BaseBEVBackbone": BaseBEVBackbone}
_DENSE_HEAD = {"AnchorHeadSingle": AnchorHeadSingle, "CenterHead": CenterHead}
_DETECTORS = {"CenterPoint": CenterPoint, "PointPillar": PointPillar,
              "SECONDNet": SECONDNet}

INIT_SEED = 0


def build_vfe(cfg, dataset):
    if cfg.NAME == "PillarVFE":
        return PillarVFE(cfg, dataset.num_point_features, dataset.voxel_size,
                         dataset.point_cloud_range)
    return _VFE[cfg.NAME](cfg, dataset.num_point_features)


def build_backbone_3d(cfg, input_channels, dataset):
    return _BACKBONE_3D[cfg.NAME](cfg, input_channels, dataset.grid_size)


def build_map_to_bev(cfg, dataset):
    if cfg.NAME == "PointPillarScatter":
        return PointPillarScatter(cfg, dataset.grid_size)
    return _MAP_TO_BEV[cfg.NAME](cfg)


def build_backbone_2d(cfg, num_bev_features):
    return _BACKBONE_2D[cfg.NAME](cfg, num_bev_features)


def build_dense_head(cfg, input_channels, dataset, num_class,
                     predict_boxes_when_training=False):
    args = (cfg, input_channels, num_class if not cfg.CLASS_AGNOSTIC else 1,
            dataset.class_names, dataset.grid_size, dataset.point_cloud_range)
    if cfg.NAME == "CenterHead":
        args += (dataset.voxel_size,)
    else:
        args += (predict_boxes_when_training,)
    return _DENSE_HEAD[cfg.NAME](*args)


def dataset_info(dataset):
    """A dataset object (or DatasetInfo) -> DatasetInfo."""
    if isinstance(dataset, DatasetInfo):
        return dataset
    return DatasetInfo(
        class_names=tuple(dataset.class_names),
        num_point_features=int(dataset.point_feature_encoder.num_point_features),
        grid_size=tuple(int(g) for g in dataset.grid_size),
        point_cloud_range=tuple(float(v) for v in dataset.point_cloud_range),
        voxel_size=tuple(float(v) for v in dataset.voxel_size))


def build_network(model_cfg, num_class, dataset, device=None):
    """Build the detector in eval mode on ``device`` (None = CUDA, raising
    when absent) with random weights drawn from a ``torch.Generator``
    seeded with ``INIT_SEED``."""
    device = resolve_device(device)
    model = _DETECTORS[model_cfg.NAME](model_cfg, num_class,
                                       dataset_info(dataset))
    model.init_weights(torch.Generator().manual_seed(INIT_SEED))
    return model.to(device).eval()


_DEVICE_KEYS = ("voxels", "voxel_coords", "voxel_num_points", "gt_boxes")


def load_data_to_device(batch_dict, device=None, compute_dtype=None):
    """numpy batch -> tensors on ``device`` (None = CUDA, raising when
    absent).  compute_dtype (e.g. torch.bfloat16) casts the floating-point
    inputs, so the network runs in that precision."""
    device = resolve_device(device)
    out = {}
    for k, v in batch_dict.items():
        if k in _DEVICE_KEYS and isinstance(v, np.ndarray):
            t = torch.from_numpy(v).to(device)
            if compute_dtype is not None and t.is_floating_point():
                t = t.to(compute_dtype)
            out[k] = t
        else:
            out[k] = v
    return out
