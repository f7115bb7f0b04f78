"""SparseConvTensor — fixed-capacity sparse voxel tensor.

Port of ``q3d_tpu/ops/spconv/sparse_tensor.py``: an (N, C) feature matrix
plus (N, 1+nd) int32 coordinates [b, z, y, x] whose free slots are -1.
Coordinate lookup is a binary search (``torch.searchsorted``) in the sorted
linearized keys: at the reference envelope (B x 41 x 1440 x 1440 cells) a
dense key->row table would be ~680 MB, and the search returns the same row
ids.
"""

import dataclasses
from typing import Optional, Tuple

import torch

# sentinel for padding keys; real keys are < batch * prod(spatial) < 2^30
BIG_KEY = 2 ** 30


def linearize(indices, spatial_shape):
    """(N, 1+nd) int [b, z, y, x] -> (N,) int64 key; padding rows -> BIG_KEY."""
    key = indices[:, 0].long()
    for d, s in enumerate(spatial_shape):
        key = key * int(s) + indices[:, 1 + d].long()
    return torch.where(indices[:, 0] >= 0, key, torch.full_like(key, BIG_KEY))


@dataclasses.dataclass
class SparseConvTensor:
    features: torch.Tensor                # (N, C)
    indices: torch.Tensor                 # (N, 1+nd) int32 [b, z, y, x]; -1 pad
    spatial_shape: Tuple[int, ...]
    batch_size: int
    # rows are stored in ascending linearized-key order (pads last)
    sorted_rows: bool = False
    # int8 residency: the per-tensor dequantization scale of int8 features
    # (features * feat_scale is the real value); None for float features
    feat_scale: Optional[torch.Tensor] = None
    # (sorted keys, row ids) for lookup, built once per coordinate set
    _hash: Optional[Tuple[torch.Tensor, torch.Tensor]] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def capacity(self):
        return self.features.shape[0]

    @property
    def num_channels(self):
        return self.features.shape[1]

    @property
    def valid(self):
        return self.indices[:, 0] >= 0

    def keys(self):
        return linearize(self.indices, self.spatial_shape)

    def replace(self, **changes):
        """New tensor with ``changes``; the lookup table stays valid as long
        as the coordinates are unchanged."""
        if "indices" in changes:
            changes.setdefault("_hash", None)
        return dataclasses.replace(self, **changes)

    def sort_rows(self):
        """Permute rows into ascending linearized-key order (pads last), with
        the stable sort the reference uses, so integer rulebooks built on the
        result reference the same row ids as the reference's."""
        if self.sorted_rows:
            return self
        perm = torch.argsort(self.keys(), stable=True)
        return SparseConvTensor(
            features=self.features[perm], indices=self.indices[perm],
            spatial_shape=self.spatial_shape, batch_size=self.batch_size,
            sorted_rows=True, feat_scale=self.feat_scale)

    def lookup(self, query_keys):
        """query_keys: (...,) int64 -> int32 row index in [0, N] (N = miss)."""
        if self._hash is None:
            keys, perm = torch.sort(self.keys(), stable=True)
            self._hash = (keys, perm)
        sort_keys, sort_perm = self._hash
        n = self.capacity
        pos = torch.searchsorted(sort_keys, query_keys).clamp_(max=n - 1)
        hit = (sort_keys[pos] == query_keys) & (query_keys != BIG_KEY)
        return torch.where(hit, sort_perm[pos], n).to(torch.int32)

    def dense(self):
        """-> (B, C, *spatial) dense tensor (spconv ``.dense()``, channels
        first); padding rows are dropped."""
        flat = 1
        for s in self.spatial_shape:
            flat *= int(s)
        valid = self.valid
        out = self.features.new_zeros((self.batch_size * flat, self.num_channels))
        out[self.keys()[valid]] = self.features[valid]
        out = out.view(self.batch_size, *[int(s) for s in self.spatial_shape],
                       self.num_channels)
        return out.movedim(-1, 1).contiguous()
