"""VoxelNeXt's fully sparse backbone (port of
``q3d_tpu/models/backbones_3d/spconv_backbone_voxelnext.py``).

``VoxelResBackBone8xVoxelNeXt``: CenterPoint's residual stages to stride 8
(``_SparseConvBNReLU`` and ``SparseBasicBlock`` of ``spconv_backbone.py``)
plus two more downsampling stages, conv5 and conv6, whose voxels are
scaled x2 and x4 into conv4's coordinates (z too) and row-concatenated
with conv4's; ``bev_sum_pool`` then drops z by summing the rows that share
a (b, y, x) cell, and a 2D ``SparseConv2d`` (conv_out, stride 1: its
outputs are the dilation of its inputs) and a biased ``SubMConv2d``
(shared_conv) follow.  No stage sets an output capacity, so every tensor
keeps the reference's fixed shapes: each strided conv the input's B x V
rows, the merged tensor and everything after it 3 x B x V.

Under int8 residency the 3D blocks emit int8 features, each stage with its
own ``feat_scale``, as CenterPoint's do.  The reference concatenates those
raw int8 codes, without a scale, and sums them in int8, where they wrap
(``ROADMAP.md`` §3); the port dequantizes x4, x5 and x6 (f32) before the
merge, so ``bev_sum_pool`` sums real values and conv_out quantizes them
under its own int8 rule.  The 2D convs take no residency, as in the
reference.
"""

import torch
from torch import nn

from ...ops.spconv import (SparseConvTensor, SubMConv2d, SparseConv2d,
                           SparseBatchNorm)
from ...ops.spconv.modules import dequantize_tensor
from ...ops.spconv.sparse_tensor import BIG_KEY
from .spconv_backbone import (MIN_INPUT_LANES, SparseBasicBlock,
                              _SparseConvBNReLU, _make_input_tensor)


def segment_sum(values, seg, n):
    """Sum the rows of ``values`` (sorted so that each segment's rows are
    adjacent) by segment id ``seg`` (ascending; ``n`` = dropped) -> (n, C)
    in the values' dtype, each segment's rows added in order.

    Pass j adds the j-th row of every segment with one ``index_add_``
    whose destinations are distinct, so no two additions meet in one
    place: the sums do not depend on the device's scheduling (one
    ``index_add_`` of all rows adds with atomics on the card, in no fixed
    order), and there are as many passes as the longest segment has rows
    (at most 11 in VoxelNeXt's merge, 4 in the double-flip merge)."""
    rows = torch.arange(seg.numel(), device=seg.device)
    real = seg < n
    start = torch.full((n + 1,), seg.numel(), dtype=torch.long,
                       device=seg.device)
    start.scatter_reduce_(0, seg, rows, "amin")
    pos = torch.where(real, rows - start[seg], -1)
    out = values.new_zeros((n, values.shape[1]))
    for j in range(int(pos.max()) + 1 if pos.numel() else 0):
        at = torch.nonzero(pos == j).squeeze(1)
        out.index_add_(0, seg[at], values[at])
    return out


def sort_segments(key, valid):
    """Group rows by ``key`` (the ``valid`` ones; keys below ``BIG_KEY``):
    one stable sort -> (order, the sorted rows' segment ids (n = the row
    count for the invalid rows, which sort last), the (n,) unique keys in
    ascending order, ``BIG_KEY`` past the last)."""
    n = key.shape[0]
    key = torch.where(valid, key, torch.full_like(key, BIG_KEY))
    key_s, order = torch.sort(key, stable=True)
    real = key_s != BIG_KEY
    first = torch.ones_like(real)
    first[1:] = key_s[1:] != key_s[:-1]
    first &= real
    seg = torch.cumsum(first.long(), 0) - 1
    seg = torch.where(real, seg, torch.full_like(seg, n))
    keys = torch.full((n + 1,), BIG_KEY, dtype=key.dtype, device=key.device)
    keys[torch.where(first, seg, n)] = key_s
    return order, seg, keys[:n]


def bev_sum_pool(st: SparseConvTensor):
    """Collapse z: sum the features that share a (b, y, x) cell -> a 2D
    sparse tensor of the input's row capacity, in key order, pads last
    (reference ``bev_sum_pool``, :24-51: one stable sort by the (b, y, x)
    key and a segment sum)."""
    _, h, w = (int(s) for s in st.spatial_shape)
    idx = st.indices.long()
    order, seg, out_keys = sort_segments(
        (idx[:, 0] * h + idx[:, 2]) * w + idx[:, 3], st.valid)
    feats = segment_sum(st.features[order], seg, st.capacity)
    pad = out_keys == BIG_KEY
    indices = torch.stack([out_keys // (h * w), (out_keys // w) % h,
                           out_keys % w], dim=1)
    indices = torch.where(pad[:, None], torch.full_like(indices, -1), indices)
    return SparseConvTensor(features=feats, indices=indices.to(torch.int32),
                            spatial_shape=(h, w), batch_size=st.batch_size,
                            sorted_rows=True)


class _Sparse2dConvBNReLU(nn.Sequential):
    """A 2D sparse conv (slot 0), BN (slot 1) and ReLU (reference :54-72):
    conv_out, shared_conv and the hidden convs of VoxelNeXt's head; never
    under int8 residency."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 padding=1, conv_type="spconv", bias=False):
        if conv_type == "subm":
            conv = SubMConv2d(in_channels, out_channels, kernel_size, 1,
                              padding, bias=bias)
        else:
            conv = SparseConv2d(in_channels, out_channels, kernel_size,
                                stride, padding, bias=bias)
        super().__init__(conv, SparseBatchNorm(out_channels))

    def forward(self, st, cache):
        st = self[1](self[0](st, cache))
        return st.replace(features=torch.relu(st.features))


def _upscale(st, f):
    """Coordinates of ``st`` scaled by ``f`` in z, y and x (pads stay -1)."""
    idx = st.indices
    scaled = torch.cat([idx[:, :1], idx[:, 1:] * f], dim=1)
    return torch.where(idx[:, :1] >= 0, scaled, torch.full_like(scaled, -1))


class VoxelResBackBone8xVoxelNeXt(nn.Module):
    """Module names follow pcdet's (``conv1`` ... ``conv6`` as
    ``nn.ModuleList``s, ``conv_out`` and ``shared_conv`` as (conv, BN)), so
    a pcdet-named state dict loads strictly."""

    def __init__(self, model_cfg, input_channels, grid_size):
        super().__init__()
        self.model_cfg = model_cfg
        nx, ny, nz = grid_size
        self.sparse_shape = (int(nz) + 1, int(ny), int(nx))
        ks = list(model_cfg.get("SPCONV_KERNEL_SIZES", [3, 3, 3, 3]))
        ch = list(model_cfg.get("CHANNELS", [16, 32, 64, 128, 128]))
        out_ch = int(model_cfg.get("OUT_CHANNEL", 128))
        self.num_point_features = out_ch
        cin = max(int(input_channels), MIN_INPUT_LANES)
        self.conv_input = _SparseConvBNReLU(cin, ch[0], 3, 1, 1, "subm",
                                            "subm1")

        def stage(c_in, c_out, k, down_key, res_key):
            return nn.ModuleList([
                _SparseConvBNReLU(c_in, c_out, k, 2, k // 2, "spconv",
                                  down_key),
                SparseBasicBlock(c_out, res_key),
                SparseBasicBlock(c_out, res_key)])

        self.conv1 = nn.ModuleList([SparseBasicBlock(ch[0], "res1"),
                                    SparseBasicBlock(ch[0], "res1")])
        self.conv2 = stage(ch[0], ch[1], ks[0], "spconv2", "res2")
        self.conv3 = stage(ch[1], ch[2], ks[1], "spconv3", "res3")
        self.conv4 = stage(ch[2], ch[3], ks[2], "spconv4", "res4")
        self.conv5 = stage(ch[3], ch[4], ks[3], "spconv5", "res5")
        self.conv6 = stage(ch[4], ch[4], ks[3], "spconv6", "res6")
        self.conv_out = _Sparse2dConvBNReLU(ch[3], out_ch, 3, 1, 1, "spconv")
        self.shared_conv = _Sparse2dConvBNReLU(out_ch, out_ch, 3, 1, 1,
                                               "subm", bias=True)

    def forward(self, batch_dict):
        cache = {}
        st = _make_input_tensor(batch_dict, self.sparse_shape)
        x = self.conv_input(st, cache)
        stages = {}
        for name in ("conv1", "conv2", "conv3", "conv4", "conv5", "conv6"):
            blocks = list(getattr(self, name))
            if name != "conv1":
                x = blocks.pop(0)(x, cache)
            for blk in blocks:
                x = blk(x, cache)
            stages[name] = x
        # int8 residency: real values before the merge (f32), each stage
        # with its own scale
        x4, x5, x6 = (dequantize_tensor(stages[n], torch.float32)
                      for n in ("conv4", "conv5", "conv6"))
        merged = SparseConvTensor(
            features=torch.cat([x4.features, x5.features, x6.features]),
            indices=torch.cat([x4.indices, _upscale(x5, 2), _upscale(x6, 4)]),
            spatial_shape=x4.spatial_shape, batch_size=x4.batch_size)
        out = bev_sum_pool(merged)
        out = self.conv_out(out, cache)
        out = self.shared_conv(out, cache)
        batch_dict["encoded_spconv_tensor"] = out
        batch_dict["encoded_spconv_tensor_stride"] = 8
        batch_dict["multi_scale_3d_features"] = {
            f"x_conv{i}": dequantize_tensor(stages[f"conv{i}"])
            for i in range(1, 5)}
        batch_dict["multi_scale_3d_strides"] = {
            "x_conv1": 1, "x_conv2": 2, "x_conv3": 4, "x_conv4": 8}
        return batch_dict
