"""Anchor grid generation (host numpy, once per model build).

A copy of ``q3d_tpu/models/dense_heads/target_assigner/anchor_generator.py``
(numpy only), itself at parity with pcdet's ``anchor_generator.py``:
per-class anchor sets over the feature-map grid, sizes × rotations ×
bottom-heights, z shifted to box centers, laid out (z, y, x, Nsize, Nrot, 7)
and concatenated over classes along the size axis — the exact flattening
order the head's conv channels assume.
"""

import numpy as np


class AnchorGenerator:
    def __init__(self, anchor_range, anchor_generator_config):
        self.anchor_generator_cfg = anchor_generator_config
        self.anchor_range = np.asarray(anchor_range, np.float64)
        self.anchor_sizes = [c["anchor_sizes"] for c in anchor_generator_config]
        self.anchor_rotations = [c["anchor_rotations"] for c in anchor_generator_config]
        self.anchor_heights = [c["anchor_bottom_heights"] for c in anchor_generator_config]
        self.align_center = [c.get("align_center", False) for c in anchor_generator_config]

    def generate_anchors(self, grid_sizes):
        """grid_sizes: per-class [nx, ny] feature-map sizes.

        Returns (list of (nz, ny, nx, Ns, Nr, 7) float32, list of ints).
        """
        all_anchors, num_per_loc = [], []
        rng = self.anchor_range
        for grid_size, sizes, rotations, heights, align in zip(
                grid_sizes, self.anchor_sizes, self.anchor_rotations,
                self.anchor_heights, self.align_center):
            num_per_loc.append(len(rotations) * len(sizes) * len(heights))
            if align:
                x_stride = (rng[3] - rng[0]) / grid_size[0]
                y_stride = (rng[4] - rng[1]) / grid_size[1]
                x_off, y_off = x_stride / 2, y_stride / 2
            else:
                x_stride = (rng[3] - rng[0]) / (grid_size[0] - 1)
                y_stride = (rng[4] - rng[1]) / (grid_size[1] - 1)
                x_off, y_off = 0.0, 0.0
            x_shifts = np.arange(rng[0] + x_off, rng[3] + 1e-5, x_stride)
            y_shifts = np.arange(rng[1] + y_off, rng[4] + 1e-5, y_stride)
            z_shifts = np.asarray(heights, np.float64)
            sizes_a = np.asarray(sizes, np.float64)        # (Ns, 3)
            rots_a = np.asarray(rotations, np.float64)      # (Nr,)
            nx, ny, nz = len(x_shifts), len(y_shifts), len(z_shifts)
            ns, nr = len(sizes_a), len(rots_a)

            gx, gy, gz = np.meshgrid(x_shifts, y_shifts, z_shifts, indexing="ij")
            centers = np.stack([gx, gy, gz], axis=-1)       # (nx, ny, nz, 3)
            anchors = np.broadcast_to(
                centers[:, :, :, None, None, :], (nx, ny, nz, ns, nr, 3)).copy()
            size_b = np.broadcast_to(
                sizes_a[None, None, None, :, None, :], (nx, ny, nz, ns, nr, 3))
            rot_b = np.broadcast_to(
                rots_a[None, None, None, None, :, None], (nx, ny, nz, ns, nr, 1))
            anchors = np.concatenate([anchors, size_b, rot_b], axis=-1)
            anchors = anchors.transpose(2, 1, 0, 3, 4, 5)   # -> (nz, ny, nx, ...)
            anchors[..., 2] += anchors[..., 5] / 2          # bottom -> center z
            all_anchors.append(anchors.astype(np.float32))
        return all_anchors, num_per_loc


def generate_anchors_from_cfg(anchor_generator_cfg, grid_size, point_cloud_range,
                              anchor_ndim=7):
    """Reference AnchorHeadTemplate.generate_anchors semantics: feature-map
    size = grid // feature_map_stride per class; pad anchors to anchor_ndim."""
    gen = AnchorGenerator(point_cloud_range, anchor_generator_cfg)
    feature_map_size = [np.asarray(grid_size[:2]) // cfg["feature_map_stride"]
                        for cfg in anchor_generator_cfg]
    anchors_list, num_per_loc = gen.generate_anchors(feature_map_size)
    if anchor_ndim != 7:
        anchors_list = [np.concatenate(
            [a, np.zeros((*a.shape[:-1], anchor_ndim - 7), np.float32)], axis=-1)
            for a in anchors_list]
    return anchors_list, num_per_loc
