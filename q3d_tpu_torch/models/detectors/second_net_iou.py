"""SECONDNetIoU (port of ``q3d_tpu/models/detectors/second_net_iou.py``):
SECOND's first stage (MeanVFE -> VoxelBackBone8x -> HeightCompression ->
BaseBEVBackbone -> AnchorHeadSingle) -> the proposal layer (kernel 2) ->
SECONDHead, whose IoU estimate rectifies the proposals' scores.  In
training ``loss`` is the anchor head's and the IoU head's losses summed."""

from .detector3d_template import Detector3DTemplate


class SECONDNetIoU(Detector3DTemplate):

    def forward(self, batch_dict):
        batch_dict = self.vfe(batch_dict)
        batch_dict = self.backbone_3d(batch_dict)
        batch_dict = self.map_to_bev_module(batch_dict)
        batch_dict = self.backbone_2d(batch_dict)
        batch_dict = self.dense_head(batch_dict)
        batch_dict = self.proposal_layer(batch_dict, self.roi_nms_config())
        return self.roi_head(batch_dict)
