"""CenterPoint detector (port of ``q3d_tpu/models/detectors/centerpoint.py``):
MeanVFE -> VoxelResBackBone8x -> HeightCompression -> BaseBEVBackbone ->
CenterHead; the head emits the final boxes directly."""

from .detector3d_template import Detector3DTemplate


class CenterPoint(Detector3DTemplate):

    def forward(self, batch_dict):
        batch_dict = self.vfe(batch_dict)
        batch_dict = self.backbone_3d(batch_dict)
        batch_dict = self.map_to_bev_module(batch_dict)
        batch_dict = self.backbone_2d(batch_dict)
        return self.dense_head(batch_dict)
