"""The sparse 3D voxel backbones: VoxelBackBone8x (SECOND) and
VoxelResBackBone8x (CenterPoint).

Port of ``q3d_tpu/models/backbones_3d/spconv_backbone.py``: conv_input,
four stages (a strided downsample, then SubM convs: plain post_act_blocks
in VoxelBackBone8x, SparseBasicBlock pairs in VoxelResBackBone8x) and the
(3,1,1) z-compressing conv_out.  Module names follow pcdet's, so a
pcdet-named state dict loads strictly.  sparse_shape = [nz+1, ny, nx] like
the reference's ``grid_size[::-1]+[1,0,0]``.

Under an int8 deploy rule without residency (``quant.api``) each conv is
int8 and hands its f32 output to the block's float BN and ReLU.  Under an
int8-residency rule a block folds its BN into its conv's epilogue and the
features stay int8 from conv to conv, each tensor carrying its
``feat_scale``; the output is dequantized (to bf16, as the reference does)
before the BEV map.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.spconv import (SparseConvTensor, SubMConv2d, SubMConv3d,
                           SparseConv2d, SparseConv3d, SparseBatchNorm)
from ...ops.spconv.modules import Requant, _SparseConv, dequantize_tensor

# narrow VFE outputs (4-5 channels) are zero-padded to this many lanes, so
# the conv_input weights the reference exports (I = 16) load unchanged; the
# pad lanes are zero and change nothing numerically
MIN_INPUT_LANES = 16


def _capacity_schedule(model_cfg, input_capacity):
    """Per-stage output voxel capacities from
    ``BACKBONE_3D.OUT_CAPACITY_FACTORS: {x_conv2, x_conv3, x_conv4, out}``
    (fractions of the input voxel capacity, rounded up to a multiple of 8);
    None = inherit the input capacity (exact spconv semantics)."""
    fac = model_cfg.get("OUT_CAPACITY_FACTORS", None)

    def cap(key):
        if fac is None or key not in fac:
            return None
        f = float(fac[key])
        return max(8, int(-(-input_capacity * f // 8)) * 8)
    return {k: cap(k) for k in ("x_conv2", "x_conv3", "x_conv4", "out")}


# the SubM and strided sparse convs of a 3D (nd 3) or 2D (nd 2) backbone
_CONVS = {3: (SubMConv3d, SparseConv3d), 2: (SubMConv2d, SparseConv2d)}


class _SparseConvBNReLU(nn.Sequential):
    """post_act_block: conv (slot 0) -> BN (slot 1) -> ReLU; ``nd`` 2 for
    the pillar backbones' 2D convs."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 padding=0, conv_type="subm", indice_key="", nd=3):
        subm, strided = _CONVS[nd]
        if conv_type == "subm":
            conv = subm(in_channels, out_channels, kernel_size, 1, padding,
                        indice_key=indice_key)
        elif conv_type == "spconv":
            conv = strided(in_channels, out_channels, kernel_size, stride,
                           padding, indice_key=indice_key)
        else:
            raise ValueError(conv_type)
        super().__init__(conv, SparseBatchNorm(out_channels))

    def forward(self, st, cache, out_capacity=None):
        conv, norm = self[0], self[1]
        requant = Requant(*norm.fold(), conv.rule.act) \
            if conv.residency else None
        if isinstance(conv, _SparseConv):
            st = conv(st, cache, out_capacity, requant=requant)
        else:
            st = conv(st, cache, requant=requant)
        if requant is not None:
            return st
        st = norm(st)
        return st.replace(features=torch.relu(st.features))


class SparseBasicBlock(nn.Module):
    """Residual pair of SubM convs (reference spconv_backbone.py:20-66;
    with ``nd`` 2 and a bias, ``spconv_backbone_2d.py``'s
    Sparse2DBasicBlock).  A bias feeds its BN, so in train mode its
    gradient is 0 (``train_utils.biases_before_bn``)."""

    # child pairs (conv, its BN), for ``train_utils.biases_before_bn``
    CONV_BN = (("conv1", "bn1"), ("conv2", "bn2"))

    def __init__(self, channels, indice_key="", use_bias=False, nd=3):
        super().__init__()
        subm = _CONVS[nd][0]
        self.conv1 = subm(channels, channels, 3, 1, 1, bias=use_bias,
                          indice_key=indice_key)
        self.bn1 = SparseBatchNorm(channels)
        self.conv2 = subm(channels, channels, 3, 1, 1, bias=use_bias,
                          indice_key=indice_key)
        self.bn2 = SparseBatchNorm(channels)

    def forward(self, st, cache):
        if self.conv1.residency:
            spec = self.conv1.rule.act
            x = self.conv1(st, cache,
                           requant=Requant(*self.bn1.fold(), spec))
            return self.conv2(x, cache,
                              requant=Requant(*self.bn2.fold(), spec, st))
        identity = st.features
        st = self.bn1(self.conv1(st, cache))
        st = st.replace(features=torch.relu(st.features))
        st = self.bn2(self.conv2(st, cache))
        return st.replace(features=torch.relu(st.features + identity))


def _make_input_tensor(batch_dict, sparse_shape):
    feats = batch_dict["voxel_features"]          # (B, V, C)
    coords = batch_dict["voxel_coords"]           # (B, V, 3) [z, y, x]
    b, v, c = feats.shape
    b_col = torch.arange(b, dtype=torch.int32, device=feats.device)
    b_col = b_col[:, None, None].expand(b, v, 1)
    b_col = torch.where(coords[..., :1] >= 0, b_col, torch.full_like(b_col, -1))
    indices = torch.cat([b_col, coords.to(torch.int32)], dim=-1).reshape(b * v, 4)
    flat = feats.reshape(b * v, c)
    if c < MIN_INPUT_LANES:
        flat = F.pad(flat, (0, MIN_INPUT_LANES - c))
    return SparseConvTensor(features=flat.contiguous(),
                            indices=indices.contiguous(),
                            spatial_shape=tuple(int(s) for s in sparse_shape),
                            batch_size=b).sort_rows()


class _BackBone8x(nn.Module):
    """The forward both backbones share: conv_input, conv1's blocks, then
    per stage its strided downsample (with the stage's output capacity) and
    its SubM blocks, then conv_out."""

    num_point_features = 128

    def __init__(self, model_cfg, grid_size):
        super().__init__()
        self.model_cfg = model_cfg
        nx, ny, nz = grid_size
        self.sparse_shape = (int(nz) + 1, int(ny), int(nx))

    def forward(self, batch_dict):
        cache = {}
        st = _make_input_tensor(batch_dict, self.sparse_shape)
        caps = _capacity_schedule(self.model_cfg, st.capacity)
        x = self.conv_input(st, cache)
        for blk in self.conv1:
            x = blk(x, cache)
        stages = {"x_conv1": x}
        for name, cap_key in (("conv2", "x_conv2"), ("conv3", "x_conv3"),
                              ("conv4", "x_conv4")):
            down, *blocks = getattr(self, name)
            x = down(x, cache, caps[cap_key])
            for blk in blocks:
                x = blk(x, cache)
            stages[cap_key] = x
        out = self.conv_out(x, cache, caps["out"])
        batch_dict["encoded_spconv_tensor"] = dequantize_tensor(out)
        batch_dict["encoded_spconv_tensor_stride"] = 8
        # the stages as they come out (int8 under residency: a reader
        # dequantizes what it takes, as the reference's exports do)
        batch_dict["multi_scale_3d_features"] = stages
        batch_dict["multi_scale_3d_strides"] = {
            "x_conv1": 1, "x_conv2": 2, "x_conv3": 4, "x_conv4": 8}
        return batch_dict


class VoxelBackBone8x(_BackBone8x):
    """SECOND's backbone (reference :134-197): 12 convs, 16 -> 32 -> 64 ->
    64 channels, conv4's downsample padded (0, 1, 1), conv_out to 128."""

    backbone_channels = {"x_conv1": 16, "x_conv2": 32, "x_conv3": 64,
                         "x_conv4": 64}

    def __init__(self, model_cfg, input_channels, grid_size):
        super().__init__(model_cfg, grid_size)
        cin = max(int(input_channels), MIN_INPUT_LANES)
        self.conv_input = _SparseConvBNReLU(cin, 16, 3, 1, 1, "subm", "subm1")

        def stage(c_in, c_out, padding, down_key, subm_key):
            return nn.ModuleList([
                _SparseConvBNReLU(c_in, c_out, 3, 2, padding, "spconv", down_key),
                _SparseConvBNReLU(c_out, c_out, 3, 1, 1, "subm", subm_key),
                _SparseConvBNReLU(c_out, c_out, 3, 1, 1, "subm", subm_key)])

        self.conv1 = nn.ModuleList([
            _SparseConvBNReLU(16, 16, 3, 1, 1, "subm", "subm1")])
        self.conv2 = stage(16, 32, 1, "spconv2", "subm2")
        self.conv3 = stage(32, 64, 1, "spconv3", "subm3")
        self.conv4 = stage(64, 64, (0, 1, 1), "spconv4", "subm4")
        self.conv_out = _SparseConvBNReLU(
            64, 128, (3, 1, 1), (2, 1, 1), model_cfg.get("last_pad", 0),
            "spconv", "spconv_down2")


class VoxelResBackBone8x(_BackBone8x):
    """Residual variant — the CenterPoint-nuScenes backbone."""

    def __init__(self, model_cfg, input_channels, grid_size):
        super().__init__(model_cfg, grid_size)
        use_bias = bool(model_cfg.get("USE_BIAS", False))
        cin = max(int(input_channels), MIN_INPUT_LANES)
        self.conv_input = _SparseConvBNReLU(cin, 16, 3, 1, 1, "subm", "subm1")

        def stage(c_in, c_out, padding, down_key, res_key):
            return nn.ModuleList([
                _SparseConvBNReLU(c_in, c_out, 3, 2, padding, "spconv", down_key),
                SparseBasicBlock(c_out, res_key, use_bias),
                SparseBasicBlock(c_out, res_key, use_bias)])

        self.conv1 = nn.ModuleList([SparseBasicBlock(16, "res1", use_bias),
                                    SparseBasicBlock(16, "res1", use_bias)])
        self.conv2 = stage(16, 32, 1, "spconv2", "res2")
        self.conv3 = stage(32, 64, 1, "spconv3", "res3")
        self.conv4 = stage(64, 128, (0, 1, 1), "spconv4", "res4")
        self.conv_out = _SparseConvBNReLU(
            128, 128, (3, 1, 1), (2, 1, 1), model_cfg.get("last_pad", 0),
            "spconv", "spconv_down2")
