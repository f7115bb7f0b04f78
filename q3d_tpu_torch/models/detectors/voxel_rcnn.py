"""Voxel R-CNN (port of ``q3d_tpu/models/detectors/voxel_rcnn.py``):
MeanVFE -> VoxelBackBone8x -> HeightCompression -> BaseBEVBackbone ->
AnchorHeadSingle -> the proposal layer (kernel 2) -> VoxelRCNNHead over
the sparse stages' voxels.  Inference only: two-stage training waits for
the proposal target layer."""

from .detector3d_template import Detector3DTemplate


class VoxelRCNN(Detector3DTemplate):

    def forward(self, batch_dict):
        if self.training:
            raise NotImplementedError("VoxelRCNN: training is not ported")
        batch_dict = self.vfe(batch_dict)
        batch_dict = self.backbone_3d(batch_dict)
        batch_dict = self.map_to_bev_module(batch_dict)
        batch_dict = self.backbone_2d(batch_dict)
        batch_dict = self.dense_head(batch_dict)
        batch_dict = self.proposal_layer(
            batch_dict, self.model_cfg.ROI_HEAD.NMS_CONFIG.TEST)
        return self.roi_head(batch_dict)
