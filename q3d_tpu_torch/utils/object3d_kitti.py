"""KITTI label files: one ``Object3d`` a line.

The port's copy of ``q3d_tpu/utils/object3d_kitti.py``: the class, the
truncation and occlusion, alpha, the 2D box, h / w / l, the camera-frame
location of the box's bottom centre, ry, an optional score, and the
official difficulty level (0 easy, 1 moderate, 2 hard, -1 unknown).
"""

import numpy as np


def get_objects_from_label(label_file):
    """A ``label_2/<id>.txt`` -> [Object3d], one per non-empty line."""
    with open(label_file) as f:
        lines = f.readlines()
    return [Object3d(line) for line in lines if line.strip()]


def cls_type_to_id(cls_type):
    types = {"Car": 1, "Pedestrian": 2, "Cyclist": 3, "Van": 4}
    return types.get(cls_type, -1)


class Object3d:
    def __init__(self, line):
        label = line.strip().split(" ")
        self.src = line
        self.cls_type = label[0]
        self.cls_id = cls_type_to_id(self.cls_type)
        self.truncation = float(label[1])
        self.occlusion = float(label[2])
        self.alpha = float(label[3])
        self.box2d = np.array([float(x) for x in label[4:8]], np.float32)
        self.h = float(label[8])
        self.w = float(label[9])
        self.l = float(label[10])
        self.loc = np.array([float(x) for x in label[11:14]], np.float32)
        self.dis_to_cam = np.linalg.norm(self.loc)
        self.ry = float(label[14])
        self.score = float(label[15]) if len(label) == 16 else -1.0
        self.level_str = None
        self.level = self.get_kitti_obj_level()

    def get_kitti_obj_level(self):
        """The official difficulty from the 2D box's height, the truncation
        and the occlusion (sets ``level_str``)."""
        height = float(self.box2d[3]) - float(self.box2d[1])
        if height >= 40 and self.truncation <= 0.15 and self.occlusion <= 0:
            self.level_str = "Easy"
            return 0
        if height >= 25 and self.truncation <= 0.3 and self.occlusion <= 1:
            self.level_str = "Moderate"
            return 1
        if height >= 25 and self.truncation <= 0.5 and self.occlusion <= 2:
            self.level_str = "Hard"
            return 2
        self.level_str = "UnKnown"
        return -1

    def to_str(self):
        return (f"{self.cls_type} {self.truncation:.2f} {int(self.occlusion)} "
                f"{self.alpha:.2f} box2d={self.box2d} hwl=({self.h:.2f},"
                f"{self.w:.2f},{self.l:.2f}) pos={self.loc} ry={self.ry:.2f}")
