"""Box encoder/decoder of the anchor heads (port of
``q3d_tpu/utils/box_coder_utils.py::ResidualCoder``): anchor deltas
normalised by the anchor's BEV diagonal, log-size residuals, the heading
as a residual or (``encode_angle_by_sincos``) as its cos/sin differences.
Every operation in the reference's order, on torch tensors.
``PointResidualCoder``'s encode (the point heads' box targets, :69): the
residuals of a gt box from a point, by the class's mean size.
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


class PointResidualCoder:
    """Residuals of gt boxes from points (reference :69): centre offsets
    over the class mean size's BEV diagonal (z over its height), log sizes
    over it, and the heading's cos / sin.  Only ``use_mean_size`` is
    ported: no config of the repo sets it false."""

    def __init__(self, code_size=8, use_mean_size=True, **kwargs):
        if not use_mean_size:
            raise NotImplementedError(
                "PointResidualCoder: use_mean_size=False is not ported")
        self.code_size = code_size
        self.mean_size = torch.tensor(kwargs["mean_size"],
                                      dtype=torch.float32)
        if float(self.mean_size.min()) <= 0:
            raise ValueError(f"mean_size must be positive: "
                             f"{kwargs['mean_size']}")

    def encode(self, gt_boxes, points, gt_classes):
        """gt_boxes (..., 7 + C), points (..., 3), gt_classes 1-based ->
        (..., 8 + C)."""
        sizes = gt_boxes[..., 3:6].clamp(min=1e-5)
        xg, yg, zg = gt_boxes[..., 0:3].unbind(-1)
        dxg, dyg, dzg = sizes.unbind(-1)
        rg = gt_boxes[..., 6]
        xa, ya, za = points[..., 0:3].unbind(-1)
        mean = self.mean_size.to(gt_boxes.device)[gt_classes - 1]
        dxa, dya, dza = mean.unbind(-1)
        diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
        xt, yt = (xg - xa) / diagonal, (yg - ya) / diagonal
        zt = (zg - za) / dza
        dxt, dyt, dzt = (torch.log(dxg / dxa), torch.log(dyg / dya),
                         torch.log(dzg / dza))
        extras = [gt_boxes[..., 7 + i] for i in range(gt_boxes.shape[-1] - 7)]
        return torch.stack([xt, yt, zt, dxt, dyt, dzt, torch.cos(rg),
                            torch.sin(rg), *extras], dim=-1)
