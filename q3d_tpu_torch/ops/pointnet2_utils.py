"""PointNet++ primitives of the two-stage detectors (port of
``q3d_tpu/ops/pointnet2_utils.py``: ``farthest_point_sample`` :25,
``ball_query`` :51, ``index_points`` :68, ``group_points`` :73), batched
over frames of a padded (B, N, ...) layout with a validity mask.

The reference builds the whole (B, M, N) distance matrix and sorts it
along N.  ``ball_query`` computes the same indices without the sort and
without the whole matrix: the centres go in chunks, the columns stop at
the last valid row of any frame (the rows past it never count), and a
centre's first ``nsample`` hits are the ``nsample`` smallest of the key
"column index where inside, else N".  Squared distances are summed x, y,
z in that order, as the reference's reduction adds them, so a point at
d^2 = r^2 within an ulp falls on the same side in both packages.

``three_nn``, ``three_interpolate`` and ``QueryAndGroup`` are off the
ported path and wait.
"""

import torch

_INF = 1e10
# elements of one chunk's (frames, centres, columns) distance block
_CHUNK_ELEMENTS = 1 << 25


def _columns_used(valid, n):
    """The number of leading columns that hold every valid row (at least
    1); the host waits for it once."""
    if valid is None:
        return n
    last = torch.where(valid.any(0), torch.arange(n, device=valid.device), -1)
    return max(int(last.max()) + 1, 1)


def _sqdist(centres, points):
    """(B, M, 3), (B, N, 3) -> (B, M, N) squared distances, (c - p)^2
    summed over x, y, z in order."""
    d2 = (centres[:, :, None, 0] - points[:, None, :, 0]).square_()
    d2.add_((centres[:, :, None, 1] - points[:, None, :, 1]).square_())
    return d2.add_((centres[:, :, None, 2] - points[:, None, :, 2]).square_())


def farthest_point_sample(xyz, npoint, valid=None):
    """(B, N, 3) -> (B, npoint) int64 indices, iterative FPS: the first
    pick is each frame's first valid point, each next one the point
    farthest from those picked (the first of equal distances); invalid
    points are never picked while a valid one is left.  ``npoint``
    dependent steps on the tensors' device, no host sync between them."""
    b, n, _ = xyz.shape
    if valid is None:
        valid = torch.ones((b, n), dtype=torch.bool, device=xyz.device)
    n_used = _columns_used(valid, n)
    pts, valid = xyz[:, :n_used].float(), valid[:, :n_used]
    dists = torch.where(valid, _INF, -_INF).to(torch.float32)
    farthest = torch.argmax(valid.to(torch.int32), dim=1)
    idxs = torch.empty((b, npoint), dtype=torch.int64, device=xyz.device)
    rows = torch.arange(b, device=xyz.device)
    for i in range(npoint):
        idxs[:, i] = farthest
        # an invalid point's distance stays -inf: min(-inf, d) = -inf
        d = _sqdist(pts[rows, farthest][:, None], pts)[:, 0]
        dists = torch.minimum(dists, d)
        farthest = torch.argmax(dists, dim=1)
    return idxs


def ball_query(radius, nsample, xyz, new_xyz, valid=None):
    """(B, N, 3) points, (B, M, 3) centres -> (idx (B, M, nsample) int64,
    mask (B, M, nsample) bool): the first ``nsample`` points (by index)
    with d^2 < radius^2, empty slots repeating the first hit.  A centre
    with no hit gets index N - 1 everywhere (the reference clips its
    "none" index N to N - 1) and an all-false mask."""
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    n_used = _columns_used(valid, n)
    pts = xyz[:, :n_used].float()
    # filled on the device (a host copy would wait for the queue)
    r2 = torch.full((), radius ** 2, dtype=torch.float32, device=xyz.device)
    cols = torch.arange(n_used, dtype=torch.int32, device=xyz.device)
    none = torch.full((), n, dtype=torch.int32, device=xyz.device)
    width = max(n_used, nsample)
    idx = torch.empty((b, m, nsample), dtype=torch.int64, device=xyz.device)
    mask = torch.empty((b, m, nsample), dtype=torch.bool, device=xyz.device)
    step = max(1, _CHUNK_ELEMENTS // (b * width))
    for c0 in range(0, m, step):
        c1 = min(m, c0 + step)
        inside = _sqdist(new_xyz[:, c0:c1].float(), pts) < r2
        if valid is not None:
            inside &= valid[:, None, :n_used]
        key = torch.where(inside, cols, none)
        if width > n_used:
            key = torch.nn.functional.pad(key, (0, width - n_used), value=n)
        first = torch.topk(key, nsample, dim=-1, largest=False,
                           sorted=True).values
        hit = first < n
        idx[:, c0:c1] = torch.where(hit, first, first[..., :1]) \
            .clamp(max=n - 1)
        mask[:, c0:c1] = hit
    return idx, mask


def index_points(points, idx):
    """(B, N, C), (B, ...) int -> (B, ..., C): each frame's rows by index."""
    rows = torch.arange(points.shape[0], device=points.device)
    return points[rows.view(-1, *([1] * (idx.dim() - 1))), idx]


def group_points(points, idx):
    """(B, N, C), (B, M, K) -> (B, M, K, C)."""
    return index_points(points, idx)
