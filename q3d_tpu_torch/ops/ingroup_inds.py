"""Each element's rank within its group, in appearance order (port of
``q3d_tpu/ops/ingroup_inds.py``): a stable sort by group id, then the
position within each run of equal ids."""

import torch

# the sort key of an invalid element: above every group id
_INVALID_KEY = 2 ** 62


def ingroup_inds(group_ids, valid=None):
    """group_ids (N,) int; entries with ``valid`` False (default: id < 0)
    get -1.  -> (N,) int32: the 0-based position of each element among the
    earlier elements of its group."""
    n = group_ids.shape[0]
    if valid is None:
        valid = group_ids >= 0
    ids = torch.where(valid, group_ids.long(),
                      torch.full_like(group_ids, _INVALID_KEY, dtype=torch.long))
    order = torch.argsort(ids, stable=True)
    ids_s = ids[order]
    new_seg = torch.ones(n, dtype=torch.bool, device=ids.device)
    new_seg[1:] = ids_s[1:] != ids_s[:-1]
    pos = torch.arange(n, device=ids.device)
    seg_start = torch.cummax(torch.where(new_seg, pos, 0), dim=0).values
    out = torch.empty(n, dtype=torch.int32, device=ids.device)
    out[order] = (pos - seg_start).to(torch.int32)
    return torch.where(valid, out, -1)
