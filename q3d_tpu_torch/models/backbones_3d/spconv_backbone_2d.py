"""The sparse 2D pillar backbones of PillarNet (port of
``q3d_tpu/models/backbones_3d/spconv_backbone_2d.py``).

The dynamic pillar VFE's rows become a 2D sparse tensor over the (ny, nx)
pillar grid (``_make_pillar_tensor``: [b, y, x] coordinates, rows sorted by
key, the VFE's empty rows, -1, last).  Four sparse stages follow at strides
1, 2, 4 and 8, 32 -> 64 -> 128 -> 256 channels, every conv a 3x3
``SubMConv2d`` or strided ``SparseConv2d`` on kernel 1 (K = 9; the 256-wide
stage on its 256-channel instances):

  * ``PillarBackBone8x``: post-act blocks (conv, BN, ReLU), 11 sparse convs;
  * ``PillarRes18BackBone8x``: ``SparseBasicBlock`` pairs of biased SubM
    convs after each stage's strided conv, 19 sparse convs;

then conv4 is made dense (B, 256, ny/8, nx/8) and conv5, three dense 3x3
conv + BN + ReLU (the first at stride 2), runs on it.  No stage sets an
output capacity: each strided conv keeps its input's rows, as the
reference's fixed shapes do.  ``multi_scale_2d_features`` holds x_conv1-3
(sparse), x_conv4 (dense) and x_conv5, ``multi_scale_2d_strides`` their
strides, for ``BaseBEVBackboneV1``.  Module names follow OpenPCDet's:
``conv<s>.<i>`` (a block: ``.0`` conv, ``.1`` BN; a residual block:
``conv1 / bn1 / conv2 / bn2``), ``conv5.<i>.0 / .1``.
"""

import torch
from torch import nn

from ...ops.spconv import SparseConvTensor
from ...ops.spconv.modules import dequantize_tensor
from ..layers import BatchNorm, Conv2d
from .spconv_backbone import SparseBasicBlock, _SparseConvBNReLU


def _make_pillar_tensor(batch_dict, sparse_shape):
    return SparseConvTensor(
        features=batch_dict["pillar_features"].contiguous(),
        indices=batch_dict["pillar_coords"].to(torch.int32).contiguous(),
        spatial_shape=tuple(int(s) for s in sparse_shape),
        batch_size=int(batch_dict["pillar_batch_size"])).sort_rows()


def _dense_block(in_channels, out_channels, stride):
    """post_act_block_dense: 3x3 conv (slot 0), BN (slot 1), ReLU."""
    return nn.Sequential(Conv2d(in_channels, out_channels, 3, stride, 1,
                                bias=False),
                         BatchNorm(out_channels), nn.ReLU())


class PillarBackBone8x(nn.Module):
    num_point_features = 256
    backbone_channels = {"x_conv1": 32, "x_conv2": 64, "x_conv3": 128,
                         "x_conv4": 256, "x_conv5": 256}
    RESIDUAL = False

    def __init__(self, model_cfg, input_channels, grid_size):
        super().__init__()
        self.model_cfg = model_cfg
        nx, ny, _ = grid_size
        self.sparse_shape = (int(ny), int(nx))

        def block(c_in, c_out, key, stride=1):
            kind = "subm" if stride == 1 else "spconv"
            return _SparseConvBNReLU(c_in, c_out, 3, stride, 1, kind, key,
                                     nd=2)

        def res(c, key):
            return SparseBasicBlock(c, key, use_bias=True, nd=2)

        c_in = int(input_channels)
        if self.RESIDUAL:
            self.conv1 = nn.ModuleList([res(32, "res1"), res(32, "res1")])
        else:
            self.conv1 = nn.ModuleList([block(c_in, 32, "subm1"),
                                        block(32, 32, "subm1")])
        for s, (c0, c1) in enumerate(((32, 64), (64, 128), (128, 256)), 2):
            down = block(c0, c1, f"spconv{s}", stride=2)
            rest = [res(c1, f"res{s}"), res(c1, f"res{s}")] if self.RESIDUAL \
                else [block(c1, c1, f"subm{s}"), block(c1, c1, f"subm{s}")]
            setattr(self, f"conv{s}", nn.ModuleList([down, *rest]))
        self.conv5 = nn.Sequential(_dense_block(256, 256, 2),
                                   _dense_block(256, 256, 1),
                                   _dense_block(256, 256, 1))

    def forward(self, batch_dict):
        cache = {}
        x = _make_pillar_tensor(batch_dict, self.sparse_shape)
        outs = {}
        for s in range(1, 5):
            for blk in getattr(self, f"conv{s}"):
                x = blk(x, cache)
            outs[f"x_conv{s}"] = x
        x4d = dequantize_tensor(x).dense()              # (B, 256, H/8, W/8)
        outs["x_conv4"] = x4d
        outs["x_conv5"] = self.conv5(x4d)
        batch_dict["multi_scale_2d_features"] = outs
        batch_dict["multi_scale_2d_strides"] = {
            "x_conv1": 1, "x_conv2": 2, "x_conv3": 4, "x_conv4": 8,
            "x_conv5": 16}
        return batch_dict


class PillarRes18BackBone8x(PillarBackBone8x):
    """The residual variant (reference :136): conv1 two residual blocks,
    each later stage a strided conv and two residual blocks."""
    RESIDUAL = True
