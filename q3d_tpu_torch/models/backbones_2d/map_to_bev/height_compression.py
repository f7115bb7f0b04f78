"""HeightCompression — densify the sparse 3D tensor and fold z into channels
(port of ``q3d_tpu/models/backbones_2d/map_to_bev/height_compression.py``).
The channel index is c*D + d, which is torch's (N, C, D, H, W).view(N, C*D,
H, W), as pcdet does."""

from torch import nn


class HeightCompression(nn.Module):
    def __init__(self, model_cfg):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_bev_features = model_cfg.NUM_BEV_FEATURES

    def forward(self, batch_dict):
        dense = batch_dict["encoded_spconv_tensor"].dense()   # (B, C, D, H, W)
        b, c, d, h, w = dense.shape
        batch_dict["spatial_features"] = dense.view(b, c * d, h, w)
        batch_dict["spatial_features_stride"] = batch_dict.get(
            "encoded_spconv_tensor_stride", 8)
        return batch_dict
