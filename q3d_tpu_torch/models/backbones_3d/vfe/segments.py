"""Sort and segment: the layout the dynamic VFEs share (port of the
sort + segment steps of ``q3d_tpu/models/backbones_3d/vfe/dynamic_*_vfe.py``).

Each point gets an int64 key (its pillar or voxel, with the frame where the
frame is part of the key); out-of-range and padded points get ``BIG``.  A
stable sort of the keys (``torch.sort(stable=True)``, as ``jnp.argsort``)
makes each cell's points one run; cell ids count the runs in key order and
stop at a capacity ``cap``, so the cells past it, with the highest keys,
share the overflow id ``cap`` with the dropped points.  Sums and maxima
over the runs come from that layout:

  * ``segment_sum``: each cell's points added in order, in the values'
    dtype (``spconv_backbone_voxelnext.segment_sum``: one ``index_add_``
    of distinct cells per point position), as the reference's scatter-add
    adds them on the CPU.  It does not depend on how the device schedules
    the additions: one ``index_add_`` of all points adds with atomics on
    the card, in no fixed order, and an f64 running sum (``torch.cumsum``,
    a CUB scan on the card) is not reproducible from run to run either;
    either moves PillarNet's training step between two runs by more than
    the 1e-4 that ``chip_smoke.py`` holds its kernels against the plain
    versions to (2.6e-3 on the PFN's weight gradient, measured on an
    H100).  The overflow id's sum is left 0: its points are masked out;
  * ``segment_max``: ``scatter_reduce_`` "amax" into rows that start at
    -inf, the rows no point reaches set to 0, as the reference's
    ``.at[].max`` and ``isfinite`` do.  Its gradient is shared evenly
    among a row's tied maxima, as the reference's scatter-max JVP shares
    it.
"""

import torch

from ..spconv_backbone_voxelnext import segment_sum as ordered_segment_sum

BIG = 2 ** 30          # above every real key (< B * grid cells < 2^30)


def segment_layout(key, cap):
    """(N,) int64 keys -> (order, first, sid): the stable ascending order of
    the keys; for each sorted point whether it starts a cell (a real key
    unlike the one before it); and its cell id, the count of cells up to
    it minus one, at most ``cap`` (``BIG`` keys: ``cap``).  ``sid`` is
    nondecreasing."""
    key_s, order = torch.sort(key, stable=True)
    real = key_s != BIG
    first = torch.ones_like(real)
    first[1:] = key_s[1:] != key_s[:-1]
    first &= real
    sid = torch.clamp_max(torch.cumsum(first.long(), 0) - 1, cap)
    return order, first, torch.where(real, sid, cap)


def segment_sum(values, sid, n):
    """Rows of ``values`` (N, C) summed by their nondecreasing ids ``sid``
    (0 .. n) -> ((n + 1, C) sums in the values' dtype, the overflow id
    n's left 0, (n + 1,) int64 counts); see the module docstring."""
    sums = ordered_segment_sum(values, sid, n)
    ids = torch.arange(n + 1, device=sid.device)
    counts = torch.searchsorted(sid, ids, right=True) \
        - torch.searchsorted(sid, ids)
    return torch.cat([sums, sums.new_zeros((1, values.shape[1]))]), counts


def device_constant(values, like):
    """The (len(values),) tensor of Python numbers ``values`` in ``like``'s
    dtype and on its device, each filled in by a kernel: copying from the
    host would wait for the work already queued on the card."""
    out = like.new_empty(len(values))
    for i, v in enumerate(values):
        out[i] = v
    return out


def segment_max(x, sid, n):
    """Rows of ``x`` (N, C) maxed by their ids ``sid`` (0 .. n, any order)
    -> (n + 1, C); a row no point reaches is 0."""
    out = x.new_full((n + 1, x.shape[1]), float("-inf"))
    out = out.scatter_reduce(0, sid[:, None].expand_as(x), x, "amax",
                             include_self=True)
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))
