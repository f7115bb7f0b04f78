from .iou3d_nms_utils import boxes_iou_bev, candidate_iou, nms_bev  # noqa: F401
