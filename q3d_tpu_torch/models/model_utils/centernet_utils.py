"""CenterNet heatmap utilities (port of
``q3d_tpu/models/model_utils/centernet_utils.py``): the gaussian targets
(``gaussian_radius``, ``splat_gaussians``; ``extra_targets``, the
velocity columns of the heads' regression targets) and the top-K decode
(``decode_bbox_from_heatmap``), batched over frames, NCHW."""

import numpy as np
import torch


def gaussian_radius(dx, dy, min_overlap=0.5):
    """CornerNet's bound on the gaussian radius (reference :15-33); dx, dy
    in feature cells."""
    a1 = 1
    b1 = dy + dx
    c1 = dx * dy * (1 - min_overlap) / (1 + min_overlap)
    sq1 = torch.sqrt(torch.clamp_min(b1 ** 2 - 4 * a1 * c1, 0))
    r1 = (b1 + sq1) / 2

    a2 = 4
    b2 = 2 * (dy + dx)
    c2 = (1 - min_overlap) * dx * dy
    sq2 = torch.sqrt(torch.clamp_min(b2 ** 2 - 4 * a2 * c2, 0))
    r2 = (b2 + sq2) / 2

    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (dy + dx)
    c3 = (min_overlap - 1) * dx * dy
    sq3 = torch.sqrt(torch.clamp_min(b3 ** 2 - 4 * a3 * c3, 0))
    r3 = (b3 + sq3) / 2
    return torch.minimum(torch.minimum(r1, r2), r3)


def extra_targets(gt_boxes, n_extra):
    """The regression target's channels past [box, rot] (velocity): the gt
    box's columns past its class id, cut or padded with 0 to ``n_extra``.
    A box without them (the synthetic scenes are single static sweeps)
    trains a ``vel`` branch on velocity 0; the reference's targets have no
    such columns there (``ROADMAP.md`` §3)."""
    extra = gt_boxes[..., 7:-1]
    if extra.shape[-1] >= n_extra:
        return extra[..., :n_extra]
    return torch.cat([extra, extra.new_zeros(
        (*extra.shape[:-1], n_extra - extra.shape[-1]))], dim=-1)


def splat_gaussians(centers, radii, class_ids, obj_valid, num_classes, H, W):
    """The heatmap targets of a batch of frames (reference :36-66, vmapped
    there): centers (B, M, 2) float [x, y] in feature cells, radii (B, M)
    int, class_ids (B, M) in [0, num_classes), obj_valid (B, M) bool ->
    (B, num_classes, H, W), each cell the max over its class's objects.
    Each object's gaussian is cut to its (2r+1)^2 window and its sub-eps
    tail (relative to its own peak) is zeroed, as torch's gaussian2D does."""
    dev = centers.device
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    cx_int = torch.floor(centers[..., 0]).to(torch.int32)
    cy_int = torch.floor(centers[..., 1]).to(torch.int32)
    dx = xs - cx_int[..., None, None].float()                  # (B, M, H, W)
    dy = ys - cy_int[..., None, None].float()
    r = radii.float()[..., None, None]
    sigma = (2 * r + 1) / 6.0
    g = torch.exp(-(dx ** 2 + dy ** 2) / torch.clamp_min(2 * sigma ** 2, 1e-6))
    inside = (dx.abs() <= r) & (dy.abs() <= r)
    g = torch.where(inside & obj_valid[..., None, None], g, 0.0)
    gmax = g.amax(dim=(-2, -1), keepdim=True)
    g = torch.where(g > np.finfo(np.float32).eps * gmax, g, 0.0)
    # scatter-max over objects into their class planes (invalid -> a spare
    # plane that is dropped)
    cls = torch.where(obj_valid, class_ids.long(), num_classes)
    b, m = cls.shape
    heat = g.new_zeros((b, num_classes + 1, H, W))
    heat.scatter_reduce_(1, cls[..., None, None].expand(b, m, H, W), g,
                         reduce="amax")
    return heat[:, :num_classes]


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
