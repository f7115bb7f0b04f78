"""NMS dispatch (port of ``q3d_tpu/models/model_utils/model_nms_utils.py::
class_agnostic_nms``), batched over candidate sets, fixed-size outputs."""

import torch

from ...ops.iou3d_nms import nms_bev

_NMS_FNS = {"nms_gpu": nms_bev, "nms_bev": nms_bev}


def class_agnostic_nms(box_scores, box_preds, nms_config, score_thresh=None,
                       box_valid=None, presorted=False, impl=None):
    """box_scores (S, N); box_preds (S, N, 7+) -> (idx, valid) (S, P).

    presorted=True: rows are already in descending score order (they come
    straight out of the top-K decode)."""
    valid = torch.ones_like(box_scores, dtype=torch.bool) if box_valid is None \
        else box_valid
    if score_thresh is not None:
        valid = valid & (box_scores >= score_thresh)
    nms_fn = _NMS_FNS[nms_config.NMS_TYPE]
    return nms_fn(box_preds, box_scores, thresh=float(nms_config.NMS_THRESH),
                  pre_maxsize=int(nms_config.NMS_PRE_MAXSIZE),
                  post_maxsize=int(nms_config.NMS_POST_MAXSIZE),
                  score_valid=valid, presorted=presorted, impl=impl)
