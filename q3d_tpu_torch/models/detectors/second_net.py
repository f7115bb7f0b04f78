"""SECOND detector (port of ``q3d_tpu/models/detectors/second_net.py``):
MeanVFE -> VoxelBackBone8x -> HeightCompression -> BaseBEVBackbone ->
AnchorHeadSingle -> post_processing."""

from .detector3d_template import Detector3DTemplate


class SECONDNet(Detector3DTemplate):

    def forward(self, batch_dict):
        batch_dict = self.vfe(batch_dict)
        batch_dict = self.backbone_3d(batch_dict)
        batch_dict = self.map_to_bev_module(batch_dict)
        batch_dict = self.backbone_2d(batch_dict)
        batch_dict = self.dense_head(batch_dict)
        return self.post_processing(batch_dict)
