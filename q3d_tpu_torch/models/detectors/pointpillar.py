"""PointPillars detector (port of ``q3d_tpu/models/detectors/pointpillar.py``):
PillarVFE -> PointPillarScatter -> BaseBEVBackbone -> AnchorHeadSingle ->
post_processing in eval mode; in training the head's losses."""

from .detector3d_template import Detector3DTemplate


class PointPillar(Detector3DTemplate):

    def forward(self, batch_dict):
        batch_dict = self.vfe(batch_dict)
        batch_dict = self.map_to_bev_module(batch_dict)
        batch_dict = self.backbone_2d(batch_dict)
        batch_dict = self.dense_head(batch_dict)
        if self.training:
            return batch_dict
        return self.post_processing(batch_dict)
