"""Dense BEV conv pyramid + transposed-conv upsample concat (port of
``q3d_tpu/models/backbones_2d/base_bev_backbone.py``: ``BaseBEVBackbone``,
``BaseBEVBackboneV1`` (PillarNet's: block 0 on the pillar backbone's
x_conv4, block 1 on its x_conv5, not chained) and ``BaseBEVResBackbone``).
NCHW; module slots follow pcdet's ``blocks`` / ``deblocks`` Sequentials.
Under an int8 deploy rule without residency (SmoothQuant or not) each conv
is int8 and returns its input's dtype to the float BN and ReLU after it.
Under an int8-residency rule a block folds each BN into its conv's requant
epilogue and passes int8 ``QTensor``s on, also to the next block; each
block's output is dequantized (to the input map's dtype) for the
deblocks."""

import torch
from torch import nn

from ..layers import (Conv2d, ConvTranspose2d, BatchNorm, dequantize,
                      requant_epilogue)


class _Block(nn.Sequential):
    """[pad slot] conv0(stride) BN ReLU, then (conv BN ReLU) x layer_num.

    Slot 0 is pcdet's ZeroPad2d; the padding is folded into conv0 here, so
    conv k sits at slot 1 + 3k and its BN at 2 + 3k, as in pcdet."""

    def __init__(self, in_channels, features, stride, layer_num):
        layers = [nn.Identity(),
                  Conv2d(in_channels, features, 3, stride, 1, bias=False),
                  BatchNorm(features), nn.ReLU()]
        for _ in range(layer_num):
            layers += [Conv2d(features, features, 3, 1, 1, bias=False),
                       BatchNorm(features), nn.ReLU()]
        super().__init__(*layers)

    def forward(self, x):
        conv0 = self[1]
        if not conv0.residency:
            return super().forward(dequantize(x))
        spec = conv0.rule.act
        for j in range(1, len(self), 3):
            conv, norm = self[j], self[j + 1]
            x = requant_epilogue(conv, conv(x), *norm.fold(), spec)
        return x                                    # QTensor


class _Deblock(nn.Sequential):
    """Upsample lateral head: ConvTranspose2d(k=s, stride=s) BN ReLU; at
    stride 1 with ``use_conv`` (USE_CONV_FOR_NO_STRIDE) a 1x1 Conv2d in
    the transposed conv's place, as the reference's (:59-77)."""

    def __init__(self, in_channels, features, stride, use_conv=False):
        if stride < 1:
            raise NotImplementedError(
                "strided-conv deblocks (UPSAMPLE_STRIDES < 1) are not ported")
        s = int(stride)
        conv = Conv2d(in_channels, features, 1, 1, 0, bias=False) \
            if s == 1 and use_conv else \
            ConvTranspose2d(in_channels, features, s, s, 0, bias=False)
        super().__init__(conv, BatchNorm(features), nn.ReLU())


class BaseBEVBackbone(nn.Module):
    def __init__(self, model_cfg, input_channels):
        super().__init__()
        cfg = model_cfg
        layer_nums = list(cfg.get("LAYER_NUMS", []) or [])
        layer_strides = list(cfg.get("LAYER_STRIDES", []) or [])
        num_filters = list(cfg.get("NUM_FILTERS", []) or [])
        upsample_strides = list(cfg.get("UPSAMPLE_STRIDES", []) or [])
        num_up_filters = list(cfg.get("NUM_UPSAMPLE_FILTERS", []) or [])
        if len(upsample_strides) > len(layer_nums):
            raise NotImplementedError("a trailing extra deblock is not ported")
        c_in = [input_channels, *num_filters[:-1]]
        self.blocks = nn.ModuleList(
            _Block(c_in[i], num_filters[i], layer_strides[i], layer_nums[i])
            for i in range(len(layer_nums)))
        use_conv = cfg.get("USE_CONV_FOR_NO_STRIDE", False)
        self.deblocks = nn.ModuleList(
            _Deblock(num_filters[i], num_up_filters[i], upsample_strides[i],
                     use_conv)
            for i in range(len(upsample_strides)))
        self.num_bev_features = (sum(num_up_filters) if upsample_strides
                                 else num_filters[-1])

    def forward(self, batch_dict):
        spatial = batch_dict["spatial_features"]
        x = spatial
        ups = []
        for i, block in enumerate(self.blocks):
            x = block(x)
            # x may be a QTensor: the next block takes it as it is
            xr = dequantize(x, spatial.dtype)
            batch_dict[f"spatial_features_{spatial.shape[2] // xr.shape[2]}x"] = xr
            ups.append(self.deblocks[i](xr) if len(self.deblocks) else xr)
        batch_dict["spatial_features_2d"] = torch.cat(ups, dim=1) \
            if len(ups) > 1 else ups[0]
        return batch_dict


class BaseBEVBackboneV1(nn.Module):
    """The 2D backbone over the sparse pillar backbone's dense outputs
    (reference :127-156): block i (stride 1) on x_conv4 / x_conv5, its
    output dequantized to its input's dtype, then deblock i; the deblocks'
    maps concatenated.  ``input_channels``: the two maps' channels."""

    def __init__(self, model_cfg, input_channels):
        super().__init__()
        cfg = model_cfg
        layer_nums = list(cfg.LAYER_NUMS)
        num_filters = list(cfg.NUM_FILTERS)
        num_up_filters = list(cfg.NUM_UPSAMPLE_FILTERS)
        self.blocks = nn.ModuleList(
            _Block(input_channels[i], num_filters[i], 1, layer_nums[i])
            for i in range(len(layer_nums)))
        self.deblocks = nn.ModuleList(
            _Deblock(num_filters[i], num_up_filters[i], s)
            for i, s in enumerate(cfg.UPSAMPLE_STRIDES))
        self.num_bev_features = sum(num_up_filters)

    def forward(self, batch_dict):
        ms = batch_dict["multi_scale_2d_features"]
        ups = []
        for block, deblock, x in zip(self.blocks, self.deblocks,
                                     (ms["x_conv4"], ms["x_conv5"])):
            ups.append(deblock(dequantize(block(x), x.dtype)))
        batch_dict["spatial_features_2d"] = torch.cat(ups, dim=1)
        return batch_dict


class _ResBlock(nn.Module):
    """conv0 (stride) BN ReLU, then ``layer_num`` residual pairs (conv BN
    ReLU conv BN, + the pair's input, ReLU) (reference :159-176; its module
    names, which OpenPCDet's BasicBlock tree does not share)."""

    def __init__(self, in_channels, features, stride, layer_num):
        super().__init__()
        self.layer_num = layer_num
        self.conv0 = Conv2d(in_channels, features, 3, stride, 1, bias=False)
        self.norm0 = BatchNorm(features)
        for k in range(1, layer_num + 1):
            for s in "ab":
                setattr(self, f"conv{k}{s}",
                        Conv2d(features, features, 3, 1, 1, bias=False))
                setattr(self, f"norm{k}{s}", BatchNorm(features))

    def forward(self, x):
        x = torch.relu(self.norm0(self.conv0(dequantize(x))))
        for k in range(1, self.layer_num + 1):
            y = torch.relu(getattr(self, f"norm{k}a")(
                getattr(self, f"conv{k}a")(x)))
            y = getattr(self, f"norm{k}b")(getattr(self, f"conv{k}b")(y))
            x = torch.relu(y + x)
        return x


class BaseBEVResBackbone(nn.Module):
    """The residual BEV backbone (reference :179-211): chained ``_ResBlock``
    stages, each deblocked (when UPSAMPLE_STRIDES is set), concatenated."""

    def __init__(self, model_cfg, input_channels):
        super().__init__()
        cfg = model_cfg
        layer_nums = list(cfg.LAYER_NUMS)
        num_filters = list(cfg.NUM_FILTERS)
        upsample_strides = list(cfg.get("UPSAMPLE_STRIDES", []) or [])
        num_up_filters = list(cfg.get("NUM_UPSAMPLE_FILTERS", []) or [])
        c_in = [input_channels, *num_filters[:-1]]
        self.blocks = nn.ModuleList(
            _ResBlock(c_in[i], num_filters[i], cfg.LAYER_STRIDES[i],
                      layer_nums[i]) for i in range(len(layer_nums)))
        self.deblocks = nn.ModuleList(
            _Deblock(num_filters[i], num_up_filters[i], upsample_strides[i])
            for i in range(len(upsample_strides)))
        self.num_bev_features = (sum(num_up_filters) if upsample_strides
                                 else num_filters[-1])

    def forward(self, batch_dict):
        x = batch_dict["spatial_features"]
        ups = []
        for i, block in enumerate(self.blocks):
            x = block(x)
            ups.append(self.deblocks[i](x) if len(self.deblocks) else x)
        batch_dict["spatial_features_2d"] = torch.cat(ups, dim=1) \
            if len(ups) > 1 else ups[0]
        return batch_dict
