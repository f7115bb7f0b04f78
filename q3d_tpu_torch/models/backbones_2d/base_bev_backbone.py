"""Dense BEV conv pyramid + transposed-conv upsample concat (port of
``q3d_tpu/models/backbones_2d/base_bev_backbone.py::BaseBEVBackbone``).
NCHW; module slots follow pcdet's ``blocks`` / ``deblocks`` Sequentials.
Under an int8-residency deploy rule a block folds each BN into its conv's
requant epilogue and passes int8 ``QTensor``s on, also to the next block;
each block's output is dequantized (to the input map's dtype) for the
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
    """Upsample lateral head: ConvTranspose2d(k=s, stride=s) BN ReLU."""

    def __init__(self, in_channels, features, stride):
        if stride < 1:
            raise NotImplementedError(
                "strided-conv deblocks (UPSAMPLE_STRIDES < 1) are not ported")
        s = int(stride)
        super().__init__(ConvTranspose2d(in_channels, features, s, s, 0,
                                         bias=False),
                         BatchNorm(features), nn.ReLU())


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
        self.deblocks = nn.ModuleList(
            _Deblock(num_filters[i], num_up_filters[i], upsample_strides[i])
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
