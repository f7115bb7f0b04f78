from .iou3d_nms_utils import (aligned_iou_bev, boxes_iou3d,  # noqa: F401
                              boxes_iou_bev, candidate_iou, nms_bev,
                              nms_normal_bev, top_candidates)
