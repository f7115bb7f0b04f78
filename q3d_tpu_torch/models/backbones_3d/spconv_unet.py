"""UNetV2 — PartA2's sparse encoder / decoder (port of
``q3d_tpu/models/backbones_3d/spconv_unet.py``).

The encoder is VoxelBackBone8x's blocks with one SubM conv a stage after
its strided conv (conv_input, conv1_0, conv2_0/2_1, conv3_0/3_1,
conv4_0/4_1, then the (3, 1, 1) conv_out at stride 8); the decoder walks
back up through three ``_UpBlock``s (conv_m -> BN/ReLU, + the lateral
stage, conv_t -> BN/ReLU, the ``SparseInverseConv3d`` onto the stage below
-> BN/ReLU) and conv5 at stride 1.  19 sparse convs a forward, all on
kernel 1: 12 SubM, 4 strided and 3 inverse, each inverse conv over the
transpose of its strided conv's book.  Module names are the reference's
(the encoder's as VoxelBackBone8x's: ``conv2.0``, ``conv2.1`` ...).

Outputs: ``point_features`` (B * V, 16) and ``point_coords`` (B * V, 4)
[b, z, y, x] at stride 1 (the input's rows), ``encoded_spconv_tensor`` at
stride 8, ``multi_scale_3d_features`` (x_conv1-4).  The encoder's int8
residency is not carried into the decoder (nor is it in the reference's):
a residency rule on the UNet raises.
"""

import torch
from torch import nn

from ...ops.spconv import SparseBatchNorm, SparseInverseConv3d, SubMConv3d
from ...ops.spconv.modules import dequantize_tensor
from .spconv_backbone import (MIN_INPUT_LANES, _SparseConvBNReLU,
                              _make_input_tensor)


def _bn_relu(norm, st):
    st = norm(st)
    return st.replace(features=torch.relu(st.features))


class _UpBlock(nn.Module):
    """A decoder stage (the reference's ``_UpBlock``): the bottom tensor
    through conv_m to the lateral's width, + the lateral, conv_t, then the
    inverse conv onto ``target``'s coordinates, each followed by BN and
    ReLU."""

    def __init__(self, bottom_channels, lateral_channels, out_channels,
                 indice_key, padding):
        super().__init__()
        self.conv_m = SubMConv3d(bottom_channels, lateral_channels, 3, 1, 1,
                                 indice_key=indice_key + "_m")
        self.norm_m = SparseBatchNorm(lateral_channels)
        self.conv_t = SubMConv3d(lateral_channels, lateral_channels, 3, 1, 1,
                                 indice_key=indice_key + "_t")
        self.norm_t = SparseBatchNorm(lateral_channels)
        self.inv_conv = SparseInverseConv3d(lateral_channels, out_channels, 3,
                                            2, padding)
        self.norm_up = SparseBatchNorm(out_channels)

    def forward(self, bottom, lateral, target, cache):
        m = _bn_relu(self.norm_m, self.conv_m(bottom, cache))
        fused = m.replace(features=m.features + lateral.features)
        t = _bn_relu(self.norm_t, self.conv_t(fused, cache))
        return _bn_relu(self.norm_up, self.inv_conv(t, target, cache))


class UNetV2(nn.Module):
    num_point_features = 16
    backbone_channels = {"x_conv1": 16, "x_conv2": 32, "x_conv3": 64,
                         "x_conv4": 64}

    def __init__(self, model_cfg, input_channels, grid_size):
        super().__init__()
        self.model_cfg = model_cfg
        nx, ny, nz = grid_size
        self.sparse_shape = (int(nz) + 1, int(ny), int(nx))
        cin = max(int(input_channels), MIN_INPUT_LANES)
        self.conv_input = _SparseConvBNReLU(cin, 16, 3, 1, 1, "subm", "subm1")
        self.conv1 = nn.ModuleList([
            _SparseConvBNReLU(16, 16, 3, 1, 1, "subm", "subm1")])

        def stage(c_in, c_out, padding, n):
            return nn.ModuleList([
                _SparseConvBNReLU(c_in, c_out, 3, 2, padding, "spconv",
                                  f"spconv{n}"),
                _SparseConvBNReLU(c_out, c_out, 3, 1, 1, "subm", f"subm{n}")])
        self.conv2 = stage(16, 32, 1, 2)
        self.conv3 = stage(32, 64, 1, 3)
        self.conv4 = stage(64, 64, (0, 1, 1), 4)
        self.conv_out = _SparseConvBNReLU(
            64, 128, (3, 1, 1), (2, 1, 1), model_cfg.get("last_pad", 0),
            "spconv", "spconv_down2")
        self.up4 = _UpBlock(64, 64, 64, "up4", (0, 1, 1))
        self.up3 = _UpBlock(64, 64, 32, "up3", 1)
        self.up2 = _UpBlock(32, 32, 16, "up2", 1)
        self.conv5 = SubMConv3d(16, 16, 3, 1, 1, indice_key="subm1")
        self.norm5 = SparseBatchNorm(16)

    def forward(self, batch_dict):
        if any(getattr(m, "residency", False) for m in self.modules()):
            raise NotImplementedError("int8 residency in UNetV2")
        cache = {}
        st = _make_input_tensor(batch_dict, self.sparse_shape)
        x1 = self.conv1[0](self.conv_input(st, cache), cache)
        stages = [x1]
        for name in ("conv2", "conv3", "conv4"):
            x = stages[-1]
            for blk in getattr(self, name):
                x = blk(x, cache)
            stages.append(x)
        x1, x2, x3, x4 = stages
        out = self.conv_out(x4, cache)
        u3 = self.up4(x4, x4, x3, cache)
        u2 = self.up3(u3, x3, x2, cache)
        u1 = self.up2(u2, x2, x1, cache)
        u0 = _bn_relu(self.norm5, self.conv5(u1, cache))
        batch_dict["encoded_spconv_tensor"] = dequantize_tensor(out)
        batch_dict["encoded_spconv_tensor_stride"] = 8
        batch_dict["point_features"] = u0.features
        batch_dict["point_coords"] = u0.indices
        batch_dict["multi_scale_3d_features"] = {
            "x_conv1": x1, "x_conv2": x2, "x_conv3": x3, "x_conv4": x4}
        batch_dict["multi_scale_3d_strides"] = {
            "x_conv1": 1, "x_conv2": 2, "x_conv3": 4, "x_conv4": 8}
        return batch_dict
