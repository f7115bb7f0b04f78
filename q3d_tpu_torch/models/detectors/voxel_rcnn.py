"""Voxel R-CNN (port of ``q3d_tpu/models/detectors/voxel_rcnn.py``):
MeanVFE -> VoxelBackBone8x -> HeightCompression -> BaseBEVBackbone ->
AnchorHeadSingle -> the proposal layer (kernel 2) -> VoxelRCNNHead over
the sparse stages' voxels.  In training the proposal layer takes
ROI_HEAD.NMS_CONFIG.TRAIN and ``loss`` is the anchor head's and the ROI
head's losses summed (reference :18-28)."""

from .detector3d_template import Detector3DTemplate


class VoxelRCNN(Detector3DTemplate):

    def forward(self, batch_dict):
        batch_dict = self.vfe(batch_dict)
        batch_dict = self.backbone_3d(batch_dict)
        batch_dict = self.map_to_bev_module(batch_dict)
        batch_dict = self.backbone_2d(batch_dict)
        batch_dict = self.dense_head(batch_dict)
        batch_dict = self.proposal_layer(batch_dict, self.roi_nms_config())
        return self.roi_head(batch_dict)
