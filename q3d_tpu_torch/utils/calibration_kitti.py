"""KITTI calibration: the calib file's matrices and the frame transforms.

The port's numpy copy of ``q3d_tpu/utils/calibration_kitti.py`` (that
package imports JAX on import): ``get_calib_from_file`` reads P2, R0_rect
and Tr_velo_to_cam; ``Calibration`` maps lidar <-> rectified camera
coordinates and projects rect points into the image.  Host-side numpy,
float64, the same arithmetic as the reference.
"""

import numpy as np


def get_calib_from_file(calib_file):
    """A KITTI ``calib/<id>.txt`` -> {P2, P3, R0, Tr_velo2cam} (float64;
    P3 is P2 where the file has none)."""
    with open(calib_file) as f:
        lines = f.readlines()
    vals = {}
    for line in lines:
        if ":" not in line:
            continue
        key, data = line.split(":", 1)
        vals[key.strip()] = np.array([float(x) for x in data.split()],
                                     np.float64)
    return {
        "P2": vals["P2"].reshape(3, 4),
        "P3": vals.get("P3", vals["P2"]).reshape(3, 4),
        "R0": vals["R0_rect"].reshape(3, 3),
        "Tr_velo2cam": vals["Tr_velo_to_cam"].reshape(3, 4),
    }


class Calibration:
    """One frame's calibration, from its file's path or from the dict
    ``get_calib_from_file`` returns."""

    def __init__(self, calib_file):
        calib = get_calib_from_file(calib_file) if isinstance(calib_file, str) \
            else calib_file
        self.P2 = calib["P2"]                 # (3, 4)
        self.R0 = calib["R0"]                 # (3, 3)
        self.V2C = calib["Tr_velo2cam"]       # (3, 4)

        self.cu = self.P2[0, 2]
        self.cv = self.P2[1, 2]
        self.fu = self.P2[0, 0]
        self.fv = self.P2[1, 1]
        self.tx = self.P2[0, 3] / (-self.fu)
        self.ty = self.P2[1, 3] / (-self.fv)

    @staticmethod
    def _hom(pts):
        return np.hstack([pts, np.ones((pts.shape[0], 1), pts.dtype)])

    def lidar_to_rect(self, pts_lidar):
        """(N, 3) lidar -> (N, 3) rectified camera coordinates."""
        pts = self._hom(pts_lidar) @ self.V2C.T
        return pts @ self.R0.T

    def rect_to_lidar(self, pts_rect):
        """(N, 3) rectified camera -> (N, 3) lidar coordinates."""
        R0_ext = np.eye(4)
        R0_ext[:3, :3] = self.R0
        V2C_ext = np.eye(4)
        V2C_ext[:3, :4] = self.V2C
        inv = np.linalg.inv(R0_ext @ V2C_ext)
        return (self._hom(pts_rect) @ inv.T)[:, :3]

    def rect_to_img(self, pts_rect):
        """(N, 3) rect -> ((N, 2) image u, v; (N,) depth in rect)."""
        pts_2d = self._hom(pts_rect) @ self.P2.T
        depth = pts_2d[:, 2]
        uv = pts_2d[:, :2] / np.clip(depth[:, None], 1e-6, None)
        return uv, depth - self.P2.T[3, 2]

    def lidar_to_img(self, pts_lidar):
        return self.rect_to_img(self.lidar_to_rect(pts_lidar))

    def img_to_rect(self, u, v, depth_rect):
        """Image u, v (N,) at rect depth (N,) -> (N, 3) rect points."""
        x = ((u - self.cu) * depth_rect) / self.fu + self.tx
        y = ((v - self.cv) * depth_rect) / self.fv + self.ty
        return np.stack([x, y, depth_rect], axis=1)
