"""VoxelNeXt detector (port of ``q3d_tpu/models/detectors/voxelnext.py``):
MeanVFE -> VoxelResBackBone8xVoxelNeXt -> VoxelNeXtHead, fully sparse (no
BEV map); the head emits the final boxes directly.

Double-flip TTA (``DENSE_HEAD.DOUBLE_FLIP``, eval only): the batch of B
frames becomes 4B, each frame followed by its y-, x- and xy-mirrored
copies (the reference's order, frame * 4 + variant), mirrored analytically
on the voxels (point x / y negated, grid x / y reflected), as re-voxelizing
mirrored points on the symmetric grid would give; the head un-flips and
averages the copies before its decode."""

import torch

from .detector3d_template import Detector3DTemplate


class VoxelNeXt(Detector3DTemplate):

    def _expand_double_flip(self, batch_dict):
        """(B, ...) -> (4B, ...) with the variants [orig, y, x, xy] of each
        frame in turn (reference :26-55)."""
        nx, ny, _ = (int(g) for g in self.dataset.grid_size)
        vox = batch_dict["voxels"]                   # (B, V, P, C) x, y, z...
        coords = batch_dict["voxel_coords"]          # (B, V, 3) [z, y, x]
        pad = coords[..., 0] < 0

        def variant(fx, fy):
            v, c = vox.clone(), coords.clone()
            if fx:
                v[..., 0] = -v[..., 0]
                c[..., 2] = torch.where(pad, -1, nx - 1 - c[..., 2])
            if fy:
                v[..., 1] = -v[..., 1]
                c[..., 1] = torch.where(pad, -1, ny - 1 - c[..., 1])
            return v, c

        vs, cs = zip(*[variant(fx, fy) for fx, fy in
                       ((False, False), (False, True), (True, False),
                        (True, True))])
        b, v = coords.shape[:2]
        out = dict(batch_dict)
        out["voxels"] = torch.stack(vs, 1).reshape(4 * b, v, *vox.shape[2:])
        out["voxel_coords"] = torch.stack(cs, 1).reshape(4 * b, v, 3)
        out["voxel_num_points"] = torch.repeat_interleave(
            batch_dict["voxel_num_points"], 4, dim=0)
        out["batch_size"] = 4 * b
        return out

    def forward(self, batch_dict):
        if not self.training and self.dense_head.double_flip:
            batch_dict = self._expand_double_flip(batch_dict)
        batch_dict = self.vfe(batch_dict)
        batch_dict = self.backbone_3d(batch_dict)
        return self.dense_head(batch_dict)
