"""Box encoder/decoder of the anchor heads (port of
``q3d_tpu/utils/box_coder_utils.py::ResidualCoder``): anchor deltas
normalised by the anchor's BEV diagonal, log-size residuals, the heading
as a residual or (``encode_angle_by_sincos``) as its cos/sin differences.
Every operation in the reference's order, on torch tensors.
``PointResidualCoder`` waits for the point heads.
"""

import torch


class ResidualCoder:
    def __init__(self, code_size=7, encode_angle_by_sincos=False, **kwargs):
        self.code_size = code_size + (1 if encode_angle_by_sincos else 0)
        self.encode_angle_by_sincos = encode_angle_by_sincos

    def encode(self, boxes, anchors):
        """boxes/anchors: (..., 7 + C) -> (..., code_size) residuals."""
        anchors = torch.cat([anchors[..., 0:3],
                             anchors[..., 3:6].clamp(min=1e-5),
                             anchors[..., 6:]], dim=-1)
        boxes = torch.cat([boxes[..., 0:3], boxes[..., 3:6].clamp(min=1e-5),
                           boxes[..., 6:]], dim=-1)
        xa, ya, za, dxa, dya, dza, ra = anchors[..., :7].unbind(-1)
        xg, yg, zg, dxg, dyg, dzg, rg = boxes[..., :7].unbind(-1)
        diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
        xt = (xg - xa) / diagonal
        yt = (yg - ya) / diagonal
        zt = (zg - za) / dza
        dxt = torch.log(dxg / dxa)
        dyt = torch.log(dyg / dya)
        dzt = torch.log(dzg / dza)
        if self.encode_angle_by_sincos:
            rts = [torch.cos(rg) - torch.cos(ra), torch.sin(rg) - torch.sin(ra)]
        else:
            rts = [rg - ra]
        cts = [boxes[..., 7 + i] - anchors[..., 7 + i]
               for i in range(boxes.shape[-1] - 7)]
        return torch.stack([xt, yt, zt, dxt, dyt, dzt, *rts, *cts], dim=-1)

    def decode(self, box_encodings, anchors):
        """box_encodings: (..., code_size); anchors: (..., 7 + C) ->
        (..., 7 + C)."""
        xa, ya, za, dxa, dya, dza, ra = anchors[..., :7].unbind(-1)
        xt, yt, zt, dxt, dyt, dzt = box_encodings[..., :6].unbind(-1)
        diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
        xg = xt * diagonal + xa
        yg = yt * diagonal + ya
        zg = zt * dza + za
        dxg = torch.exp(dxt) * dxa
        dyg = torch.exp(dyt) * dya
        dzg = torch.exp(dzt) * dza
        if self.encode_angle_by_sincos:
            rg = torch.atan2(box_encodings[..., 7] + torch.sin(ra),
                             box_encodings[..., 6] + torch.cos(ra))
            extra0 = 8
        else:
            rg = box_encodings[..., 6] + ra
            extra0 = 7
        cgs = [box_encodings[..., extra0 + i] + anchors[..., 7 + i]
               for i in range(box_encodings.shape[-1] - extra0)]
        return torch.stack([xg, yg, zg, dxg, dyg, dzg, rg, *cgs], dim=-1)
