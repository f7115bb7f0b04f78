"""Evaluation loop: forward, recall stats, metrics (port of
``q3d_tpu/eval_utils.py``: ``statistics_info`` and ``eval_one_epoch``).

The model carries its quantization rules (``quant.api.quantize_model``
attached them), so the loop runs whatever it was made into: float,
fake-quant / SmoothQuant, or int8 deploy.  Each batch goes to the device,
through one forward, is synchronised and trimmed to the host; the recall
stats use the 3D IoU of the port's ``boxes_iou3d``; the latency meter skips
the first tenth of the batches (at least one), as the reference does; the
dataset's ``evaluation`` gives the metrics (rotated overlaps on the same
device).  With ``result_dir`` the detections of every frame go to
``result_dir/result.pkl``, and with ``save_to_file`` the dataset writes its
result files there too (KITTI: ``final_result/data/<frame>.txt``), as the
reference's ``eval_one_epoch`` does.  The reference's logging has no
caller here and is not ported.
"""

import pickle
import time
from pathlib import Path

import numpy as np
import torch

from .models import load_data_to_device
from .utils.common_utils import AverageMeter, resolve_device

FINAL_KEYS = ("final_boxes", "final_scores", "final_labels", "final_valid")


def statistics_info(ret_arrays, gt_boxes_np, recall_thresh_list, metric):
    """Recall bookkeeping on the host (reference ``statistics_info``):
    ground-truth count and, per threshold, the ground truths whose best 3D
    IoU with a valid detection exceeds it."""
    from .ops.iou3d_nms import boxes_iou3d

    for b in range(ret_arrays["final_boxes"].shape[0]):
        gts = gt_boxes_np[b]
        gts = gts[gts[:, -1] > 0][:, :7]
        metric["gt_num"] += len(gts)
        if len(gts) == 0:
            continue
        valid = ret_arrays["final_valid"][b].astype(bool)
        boxes = ret_arrays["final_boxes"][b][valid][:, :7]
        if len(boxes) == 0:
            continue
        iou = boxes_iou3d(torch.from_numpy(np.asarray(gts, np.float32)),
                          torch.from_numpy(np.asarray(boxes, np.float32))
                          ).numpy()
        best = iou.max(axis=1)
        for th in recall_thresh_list:
            metric[f"recall_rcnn_{th}"] += int((best > th).sum())
    return metric


def to_host(out):
    """The final arrays of a forward -> numpy (floats and labels as f32,
    the valid mask as bool, as the reference trims them)."""
    return {k: out[k].cpu().numpy() if out[k].dtype == torch.bool
            else out[k].float().cpu().numpy() for k in FINAL_KEYS}


def eval_one_epoch(model, dataloader, dataset, class_names, cfg,
                   device=None, per_frame=None, compute_dtype=None,
                   result_dir=None, save_to_file=False):
    """Evaluate ``model`` over ``dataloader`` -> metrics dict (recall,
    the dataset's metrics, ``infer_time_ms``).  Runs on the card unless
    ``device="cpu"``; ``infer_time_ms`` is the host clock around a forward
    that ends in ``torch.cuda.synchronize()`` on the card.  ``per_frame``
    (a list) receives each batch's host arrays, in order;
    ``compute_dtype`` (e.g. bf16) casts the float inputs; ``result_dir``
    receives ``result.pkl`` (the annos of every frame) and, with
    ``save_to_file``, the dataset's result files."""
    device = resolve_device(device)
    metric = {"gt_num": 0}
    thresh_list = list(cfg.MODEL.POST_PROCESSING.get("RECALL_THRESH_LIST",
                                                     [0.3, 0.5, 0.7]))
    for th in thresh_list:
        metric[f"recall_rcnn_{th}"] = 0

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    det_annos = []
    time_meter = AverageMeter()
    n_batches = len(dataloader)
    for i, raw in enumerate(dataloader):
        batch = load_data_to_device(raw, device=device,
                                    compute_dtype=compute_dtype)
        sync()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = model(batch)
        sync()
        dt = time.perf_counter() - t0
        if i >= max(1, int(n_batches * 0.1)):   # warm-up skip
            time_meter.update(dt * 1000)
        host = to_host(out)
        if per_frame is not None:
            per_frame.append(host)
        if "gt_boxes" in raw:
            statistics_info(host, raw["gt_boxes"], thresh_list, metric)
        det_annos += dataset.generate_prediction_dicts(
            raw, host, class_names,
            output_path=result_dir if save_to_file else None)

    ret_dict = {}
    gt_num = max(metric["gt_num"], 1)
    for th in thresh_list:
        ret_dict[f"recall/rcnn_{th}"] = metric[f"recall_rcnn_{th}"] / gt_num
    if result_dir is not None:
        result_dir = Path(result_dir)
        result_dir.mkdir(parents=True, exist_ok=True)
        with open(result_dir / "result.pkl", "wb") as f:
            pickle.dump(det_annos, f)
    _, result_dict = dataset.evaluation(
        det_annos, class_names,
        eval_metric=cfg.MODEL.POST_PROCESSING.get("EVAL_METRIC", "default"),
        device=device)
    ret_dict.update(result_dict)
    ret_dict["infer_time_ms"] = time_meter.avg
    return ret_dict
