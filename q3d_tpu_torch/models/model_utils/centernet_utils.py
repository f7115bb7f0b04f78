"""CenterNet top-K heatmap decode (port of
``q3d_tpu/models/model_utils/centernet_utils.py::decode_bbox_from_heatmap``),
batched over frames, NCHW."""

import torch


def topk_stable(scores, k):
    """Top-k along dim 1 by a stable descending sort: ties keep the lower
    index first, as ``lax.top_k`` does (``torch.topk`` promises no order
    among ties, and empty BEV cells tie exactly)."""
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def decode_bbox_from_heatmap(heatmap_logits, rot_cos, rot_sin, center,
                             center_z, log_dim, point_cloud_range, voxel_size,
                             feature_map_stride, vel=None, K=100,
                             score_thresh=None, post_center_limit_range=None):
    """Maps are (B, c, H, W) NCHW; heatmap and log_dim are RAW (pre-sigmoid,
    pre-exp): sigmoid is monotonic, so top-K on logits picks the same cells.

    Cells are ranked in the reference's NHWC flat order, idx = (y*W + x)*C
    + c, so ties resolve to the same cells.  Returns (boxes (B, K, 7 or 9),
    scores (B, K), labels (B, K) head-local class ids, valid (B, K))."""
    b, c, h, w = heatmap_logits.shape
    flat = heatmap_logits.float().permute(0, 2, 3, 1).reshape(b, -1)
    score_logits, idx = topk_stable(flat, K)
    scores = torch.sigmoid(score_logits)
    cls = idx % c
    spatial = idx // c
    xs = (spatial % w).float()
    ys = (spatial // w).float()

    def g(t):                                     # (B, c', H, W) -> (B, K, c')
        t = t.float().flatten(2)
        return t.gather(2, spatial[:, None, :].expand(-1, t.shape[1], -1)) \
            .transpose(1, 2)

    cen = g(center)
    xs = (xs + cen[..., 0]) * feature_map_stride * voxel_size[0] + point_cloud_range[0]
    ys = (ys + cen[..., 1]) * feature_map_stride * voxel_size[1] + point_cloud_range[1]
    zs = g(center_z)[..., 0]
    dims = torch.exp(g(log_dim))
    rot = torch.atan2(g(rot_sin)[..., 0], g(rot_cos)[..., 0])
    parts = [xs[..., None], ys[..., None], zs[..., None], dims, rot[..., None]]
    if vel is not None:
        parts.append(g(vel))
    boxes = torch.cat(parts, dim=-1)

    valid = torch.ones_like(scores, dtype=torch.bool)
    if score_thresh is not None:
        valid &= scores > score_thresh
    if post_center_limit_range is not None:
        lim = torch.as_tensor(post_center_limit_range, dtype=boxes.dtype,
                              device=boxes.device)
        valid &= (boxes[..., :3] >= lim[:3]).all(-1) \
            & (boxes[..., :3] <= lim[3:6]).all(-1)
    return boxes, scores, cls, valid
