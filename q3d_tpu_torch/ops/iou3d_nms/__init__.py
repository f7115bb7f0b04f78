from .iou3d_nms_utils import (boxes_iou3d, boxes_iou_bev,  # noqa: F401
                              candidate_iou, nms_bev)
