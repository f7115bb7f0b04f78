"""PartA2 (port of ``q3d_tpu/models/detectors/parta2_net.py``): MeanVFE ->
UNetV2 (the sparse encoder / decoder) -> HeightCompression ->
BaseBEVBackbone -> AnchorHeadSingle -> PointIntraPartOffsetHead (the
voxels' segmentation and part offsets) -> the proposal layer (kernel 2)
-> PartA2FCHead.  In training the proposal layer takes
ROI_HEAD.NMS_CONFIG.TRAIN and ``loss`` is the anchor head's, the point
head's and the ROI head's losses summed in that order."""

from .detector3d_template import Detector3DTemplate


class PartA2Net(Detector3DTemplate):

    def forward(self, batch_dict):
        batch_dict = self.vfe(batch_dict)
        batch_dict = self.backbone_3d(batch_dict)
        batch_dict = self.map_to_bev_module(batch_dict)
        batch_dict = self.backbone_2d(batch_dict)
        batch_dict = self.dense_head(batch_dict)
        if getattr(self, "point_head", None) is not None:
            batch_dict = self.point_head(batch_dict)
        batch_dict = self.proposal_layer(batch_dict, self.roi_nms_config())
        return self.roi_head(batch_dict)
