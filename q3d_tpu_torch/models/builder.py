"""Model builder + batch transfer (port of ``q3d_tpu/models/builder.py``).

The registries hold only what the port has; PillarVFE, the dynamic VFEs
and PointPillarScatter take the dataset's geometry, as the reference's
builders give it (:65-86, :99), and VoxelNeXtHead and TransFusionHead
their voxel size, as CenterHead does.  ``build_network`` and
``load_data_to_device`` default to the CUDA device and raise when there is
none; pass ``device="cpu"`` explicitly to run on the CPU.
"""

import numpy as np
import torch

from ..utils.common_utils import resolve_device
from .backbones_2d.base_bev_backbone import (BaseBEVBackbone,
                                             BaseBEVBackboneV1,
                                             BaseBEVResBackbone)
from .backbones_2d.map_to_bev.height_compression import HeightCompression
from .backbones_2d.map_to_bev.pointpillar_scatter import PointPillarScatter
from .backbones_3d.spconv_backbone import VoxelBackBone8x, VoxelResBackBone8x
from .backbones_3d.spconv_backbone_2d import (PillarBackBone8x,
                                              PillarRes18BackBone8x)
from .backbones_3d.spconv_backbone_voxelnext import (
    VoxelResBackBone8xVoxelNeXt)
from .backbones_3d.vfe.dynamic_mean_vfe import DynamicMeanVFE
from .backbones_3d.vfe.dynamic_pillar_vfe import DynamicPillarVFE
from .backbones_3d.vfe.dynamic_voxel_vfe import DynamicVoxelVFE
from .backbones_3d.vfe.mean_vfe import MeanVFE
from .backbones_3d.vfe.pillar_vfe import PillarVFE
from .dense_heads.anchor_head_multi import AnchorHeadMulti
from .dense_heads.anchor_head_single import AnchorHeadSingle
from .dense_heads.center_head import CenterHead
from .dense_heads.transfusion_head import TransFusionHead
from .dense_heads.voxelnext_head import VoxelNeXtHead
from .detectors.centerpoint import CenterPoint
from .detectors.detector3d_template import DatasetInfo
from .detectors.pillarnet import PillarNet
from .detectors.pointpillar import PointPillar
from .detectors.second_net import SECONDNet
from .detectors.transfusion import TransFusion
from .detectors.voxelnext import VoxelNeXt

_VFE = {"MeanVFE": MeanVFE, "PillarVFE": PillarVFE,
        "DynamicMeanVFE": DynamicMeanVFE,
        "DynamicPillarVFE": DynamicPillarVFE,
        "DynamicVoxelVFE": DynamicVoxelVFE}
_BACKBONE_3D = {"PillarBackBone8x": PillarBackBone8x,
                "PillarRes18BackBone8x": PillarRes18BackBone8x,
                "VoxelBackBone8x": VoxelBackBone8x,
                "VoxelResBackBone8x": VoxelResBackBone8x,
                "VoxelResBackBone8xVoxelNeXt": VoxelResBackBone8xVoxelNeXt}
_MAP_TO_BEV = {"HeightCompression": HeightCompression,
               "PointPillarScatter": PointPillarScatter}
_BACKBONE_2D = {"BaseBEVBackbone": BaseBEVBackbone,
                "BaseBEVBackboneV1": BaseBEVBackboneV1,
                "BaseBEVResBackbone": BaseBEVResBackbone}
_DENSE_HEAD = {"AnchorHeadMulti": AnchorHeadMulti,
               "AnchorHeadSingle": AnchorHeadSingle, "CenterHead": CenterHead,
               "TransFusionHead": TransFusionHead,
               "VoxelNeXtHead": VoxelNeXtHead}
_DETECTORS = {"CenterPoint": CenterPoint, "PillarNet": PillarNet,
              "PointPillar": PointPillar,
              "SECONDNet": SECONDNet, "TransFusion": TransFusion,
              "VoxelNeXt": VoxelNeXt}

INIT_SEED = 0


def build_vfe(cfg, dataset):
    """The VFE with the dataset's geometry where it bins points itself
    (reference :65-86): a dynamic pillar VFE's capacity is MAX_PILLARS
    (else 30,000), a dynamic voxel or mean VFE's MAX_VOXELS, else the data
    processor's MAX_NUMBER_OF_VOXELS, else 60,000."""
    geometry = (dataset.num_point_features, dataset.voxel_size,
                dataset.point_cloud_range)
    if cfg.NAME == "PillarVFE":
        return PillarVFE(cfg, *geometry)
    if cfg.NAME == "DynamicPillarVFE":
        return DynamicPillarVFE(cfg, *geometry, dataset.grid_size,
                                int(cfg.get("MAX_PILLARS", None) or 30000))
    if cfg.NAME in ("DynamicMeanVFE", "DynamicVoxelVFE"):
        cap = int(cfg.get("MAX_VOXELS", dataset.max_voxels or 60000))
        return _VFE[cfg.NAME](cfg, *geometry, dataset.grid_size, cap)
    return _VFE[cfg.NAME](cfg, dataset.num_point_features)


def build_backbone_3d(cfg, input_channels, dataset):
    return _BACKBONE_3D[cfg.NAME](cfg, input_channels, dataset.grid_size)


def build_map_to_bev(cfg, dataset):
    if cfg.NAME == "PointPillarScatter":
        return PointPillarScatter(cfg, dataset.grid_size)
    return _MAP_TO_BEV[cfg.NAME](cfg)


def build_backbone_2d(cfg, num_bev_features, backbone_channels=None):
    """BaseBEVBackboneV1 takes the 3D backbone's x_conv4 and x_conv5
    (``backbone_channels``), the others the BEV map."""
    if cfg.NAME == "BaseBEVBackboneV1":
        return BaseBEVBackboneV1(cfg, (backbone_channels["x_conv4"],
                                       backbone_channels["x_conv5"]))
    return _BACKBONE_2D[cfg.NAME](cfg, num_bev_features)


def build_dense_head(cfg, input_channels, dataset, num_class,
                     predict_boxes_when_training=False):
    args = (cfg, input_channels, num_class if not cfg.CLASS_AGNOSTIC else 1,
            dataset.class_names, dataset.grid_size, dataset.point_cloud_range)
    if cfg.NAME in ("CenterHead", "TransFusionHead", "VoxelNeXtHead"):
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
        voxel_size=tuple(float(v) for v in dataset.voxel_size),
        max_voxels=getattr(getattr(dataset, "data_processor", None),
                           "max_voxels", None))


def build_network(model_cfg, num_class, dataset, device=None):
    """Build the detector in eval mode on ``device`` (None = CUDA, raising
    when absent) with random weights drawn from a ``torch.Generator``
    seeded with ``INIT_SEED``."""
    device = resolve_device(device)
    model = _DETECTORS[model_cfg.NAME](model_cfg, num_class,
                                       dataset_info(dataset))
    model.init_weights(torch.Generator().manual_seed(INIT_SEED))
    return model.to(device).eval()


_DEVICE_KEYS = ("voxels", "voxel_coords", "voxel_num_points", "gt_boxes",
                "points", "points_mask")


def load_data_to_device(batch_dict, device=None, compute_dtype=None):
    """numpy batch -> tensors on ``device`` (None = CUDA, raising when
    absent).  compute_dtype (e.g. torch.bfloat16) casts the floating-point
    inputs, so the network runs in that precision, but the raw ``points``:
    the dynamic VFEs bin them at 0.075 m, and in bf16 a point 54 m out is
    0.25 m from its neighbours, so they stay f32 and the batch carries
    ``compute_dtype`` for the VFE's output (the reference casts them too)."""
    device = resolve_device(device)
    out = {}
    for k, v in batch_dict.items():
        if k in _DEVICE_KEYS and isinstance(v, np.ndarray):
            t = torch.from_numpy(v).to(device)
            if compute_dtype is not None and t.is_floating_point() \
                    and k != "points":
                t = t.to(compute_dtype)
            out[k] = t
        else:
            out[k] = v
    if compute_dtype is not None and "points" in out:
        out["compute_dtype"] = compute_dtype
    return out
