"""Shared set-up of the port's dataset tests: small KITTI and nuScenes
trees written by the port's writers, the reference's KITTI reader with
OpenPCDet's FOV crop (patched in the tests only), and exact comparison of
nested info structures."""

from pathlib import Path

import numpy as np

from q3d_tpu.config import EDict as JaxEDict
from q3d_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml

from q3d_tpu_torch.config import EDict, cfg_from_yaml_file
from q3d_tpu_torch.datasets import build_dataloader
from q3d_tpu_torch.datasets.kitti_synthetic import kitti_config, \
    write_kitti_tree
from q3d_tpu_torch.datasets.nuscenes_synthetic import write_nuscenes_tree

ROOT = Path(__file__).resolve().parent.parent
CFGS = ROOT / "tools" / "cfgs"
KITTI_DATA = CFGS / "dataset_configs" / "kitti_dataset.yaml"
NUSCENES_DATA = CFGS / "dataset_configs" / "nuscenes_dataset.yaml"
SECOND = CFGS / "kitti_models" / "second.yaml"
# a small KITTI scan: 4,000 ground points and 20 objects of 100 points
KITTI_SMALL = {"NUM_BG_POINTS": 4000, "NUM_OBJECTS": 20,
               "POINTS_PER_OBJECT": 100}
# a small nuScenes frame: 3 sweeps of 1,500 background points and 12
# objects of 30 points, one without points
NUSCENES_SMALL = {"bg_points": 1500, "num_objects": 12,
                  "points_per_object": 30, "occluded": 1}
NUSCENES_SWEEPS = 3
# the small trees' info pickles, for the nuScenes dataset config
NUSCENES_SETS = {"MAX_SWEEPS": NUSCENES_SWEEPS,
                 "INFO_PATH.train": [f"nuscenes_infos_{NUSCENES_SWEEPS}"
                                     "sweeps_train.pkl"],
                 "INFO_PATH.test": [f"nuscenes_infos_{NUSCENES_SWEEPS}"
                                    "sweeps_val.pkl"]}


def synthetic_kitti(frames, seed):
    """A SyntheticDataset at SECOND's KITTI geometry, small scans."""
    cfg = kitti_config("second", frames, seed)
    cfg.DATA_CONFIG.update(KITTI_SMALL)
    ds, _, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                batch_size=1, training=False)
    return ds


def write_small_kitti(root, val=2, train=2):
    """``val`` frames of seed 0 as the val split, ``train`` of seed 5 as
    the train split -> the val frames' SyntheticDataset."""
    ds = synthetic_kitti(val, 0)
    write_kitti_tree(ds, root, {"val": [f"{j:06d}" for j in range(val)]})
    write_kitti_tree(synthetic_kitti(train, 5), root,
                     {"train": [f"{val + j:06d}" for j in range(train)]})
    return ds


def write_small_nuscenes(root, val=2, train=2):
    write_nuscenes_tree(root, val, 11, split="val", sweeps=NUSCENES_SWEEPS,
                        scene=NUSCENES_SMALL)
    write_nuscenes_tree(root, train, 31, split="train",
                        sweeps=NUSCENES_SWEEPS, scene=NUSCENES_SMALL)


def configs(path, sets=None):
    """The yaml at ``path`` in both packages' config trees, ``sets`` ({dotted
    key: value}) applied to both -> (port cfg, reference cfg)."""
    out = []
    for load, edict in ((cfg_from_yaml_file, EDict),
                        (jax_cfg_from_yaml, JaxEDict)):
        cfg = load(str(path), edict())
        for key, val in (sets or {}).items():
            node = cfg
            *parents, last = key.split(".")
            for p in parents:
                node = node[p]
            node[last] = val
        out.append(cfg)
    return out


def fov_get_lidar(ds_cls):
    """The reference KittiDataset's ``get_lidar`` with OpenPCDet's
    ``get_fov_flag`` crop, from the reference's own Calibration, for
    ``monkeypatch.setattr(ds_cls, "get_lidar", ...)``."""
    whole = ds_cls.get_lidar

    def get_lidar(self, idx):
        points = whole(self, idx)
        calib = self.get_calib(idx)
        img_shape = self.get_image_shape(idx)
        pts_img, depth = calib.rect_to_img(calib.lidar_to_rect(points[:, :3]))
        keep = (pts_img[:, 0] >= 0) & (pts_img[:, 0] < img_shape[1]) \
            & (pts_img[:, 1] >= 0) & (pts_img[:, 1] < img_shape[0]) \
            & (depth >= 0)
        return points[keep]
    return get_lidar


def assert_same(mine, ref, where="root"):
    """Nested dicts / lists / arrays equal exactly, key for key (arrays
    by dtype kind, shape and value)."""
    if isinstance(ref, dict):
        assert isinstance(mine, dict) and set(mine) == set(ref), \
            (where, sorted(mine), sorted(ref))
        for k in ref:
            assert_same(mine[k], ref[k], f"{where}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(mine) == len(ref), where
        for i, (a, b) in enumerate(zip(mine, ref)):
            assert_same(a, b, f"{where}[{i}]")
    elif isinstance(ref, np.ndarray):
        mine = np.asarray(mine)
        assert mine.shape == ref.shape and mine.dtype.kind == ref.dtype.kind, \
            (where, mine.shape, ref.shape, mine.dtype, ref.dtype)
        assert np.array_equal(mine, ref), where
    else:
        assert type(mine) is type(ref) and mine == ref, (where, mine, ref)
