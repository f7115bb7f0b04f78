"""PillarNet detector (port of ``q3d_tpu/models/detectors/pillarnet.py``):
DynamicPillarVFE -> PillarBackBone8x / PillarRes18BackBone8x (sparse 2D,
then dense conv5) -> BaseBEVBackboneV1 -> CenterHead; no BEV map module,
the head emits the final boxes directly."""

from .detector3d_template import Detector3DTemplate


class PillarNet(Detector3DTemplate):

    def forward(self, batch_dict):
        batch_dict = self.vfe(batch_dict)
        batch_dict = self.backbone_3d(batch_dict)
        batch_dict = self.backbone_2d(batch_dict)
        return self.dense_head(batch_dict)
