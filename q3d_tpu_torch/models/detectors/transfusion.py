"""TransFusion-LiDAR detector (port of
``q3d_tpu/models/detectors/transfusion.py``): MeanVFE -> VoxelResBackBone8x
-> HeightCompression -> BaseBEVBackbone -> TransFusionHead, CenterPoint's
stages with the query-based head, whose outputs are final: no template
post-processing runs."""

from .centerpoint import CenterPoint


class TransFusion(CenterPoint):
    pass
