"""PyTorch port vs the JAX package: the nuScenes dataset's host side.

On small nuScenes trees that ``nuscenes_synthetic.write_nuscenes_tree``
writes under ``tmp_path`` (3 sweeps a frame), both packages' quaternion
and transform helpers, ``fill_trainval_infos`` (on an in-memory stand-in
for the devkit with its tables and ``get`` / ``get_sample_data`` /
``get_sample_data_path``), the sweep loader, CBGS, the frames, the gt
database, the prediction dicts and the evaluation are run on the same
inputs and held equal.  The reference draws from numpy's global generator
(seeded with ``np.random.seed(s)``), the port from a
``np.random.RandomState(s)`` it is handed.
"""

import pickle
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import q3d_tpu.datasets.nuscenes.nuscenes_dataset as jax_nd
import q3d_tpu.datasets.nuscenes.nuscenes_infos as jax_ni

from q3d_tpu_torch.datasets.nuscenes import nuscenes_dataset as nd
from q3d_tpu_torch.datasets.nuscenes import nuscenes_infos as ni
from q3d_tpu_torch.datasets.nuscenes_synthetic import CLASSES
from q3d_tpu_torch.tools import create_infos
from torch_port_dataset_common import (NUSCENES_DATA, NUSCENES_SETS,
                                       NUSCENES_SWEEPS, assert_same, configs,
                                       write_small_nuscenes)
from torch_port_jax_cache import jax_compile_cache  # noqa: F401

torch.set_num_threads(2)

NAMES = list(CLASSES)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("nuscenes")
    write_small_nuscenes(root)
    return root


def _datasets(root, training, seed):
    """Both packages' NuScenesDataset on ``root``: the reference's built
    under ``np.random.seed(seed)``, the port's on ``RandomState(seed)``."""
    cfg, jcfg = configs(NUSCENES_DATA, NUSCENES_SETS)
    np.random.seed(seed)
    jds = jax_nd.NuScenesDataset(dataset_cfg=jcfg, class_names=NAMES,
                                 training=training, root_path=str(root))
    ds = nd.NuScenesDataset(cfg, NAMES, training=training, root_path=root,
                            rng=np.random.RandomState(seed))
    return ds, jds


def test_geometry_helpers_equal_reference():
    rng = np.random.RandomState(0)
    assert ni.MAP_NAME_TO_DETECTION == jax_ni.MAP_NAME_TO_DETECTION
    for _ in range(20):
        q = rng.normal(size=4)
        t = rng.normal(size=3) * 10
        assert np.array_equal(ni.quat_to_rotmat(q), jax_ni.quat_to_rotmat(q))
        assert ni.quaternion_yaw(q) == jax_ni.quaternion_yaw(q)
        for inverse in (False, True):
            assert np.array_equal(ni.transform_matrix(t, q, inverse),
                                  jax_ni.transform_matrix(t, q, inverse))
    boxes = rng.normal(size=(30, 9))
    boxes[:10, 7:9] = 0.0
    names = np.asarray(NAMES * 3)
    assert np.array_equal(nd.default_attributes(boxes, names),
                          jax_nd.default_attributes(boxes, names))


class DevkitStandIn:
    """The devkit's tables in memory: 2 scenes of 3 key frames, each key
    frame 2 sweeps after the previous one, the first with no earlier
    sweep; ego poses and sensor calibrations with random rotations; 0-4
    annotations a frame, some without points."""

    def __init__(self, root, seed=0):
        rng = np.random.RandomState(seed)
        self.root = root
        self.scene, self.sample, self.sample_data = [], [], []
        self.calibrated_sensor, self.ego_pose = [], []
        self.sample_annotation, self._boxes = [], {}
        (root / "samples" / "LIDAR_TOP").mkdir(parents=True, exist_ok=True)
        (root / "sweeps" / "LIDAR_TOP").mkdir(parents=True, exist_ok=True)
        labels = list(ni.MAP_NAME_TO_DETECTION)
        for s in range(2):
            prev_sd, first = "", None
            for k in range(3):
                for sweep in range(3 if k else 1):
                    key = sweep == (2 if k else 0)
                    tok = f"sd_{s}_{k}_{sweep}"
                    folder = "samples" if key else "sweeps"
                    path = root / folder / "LIDAR_TOP" / f"{tok}.pcd.bin"
                    path.write_bytes(b"")
                    self.calibrated_sensor.append({
                        "token": f"cs_{tok}", "translation": rng.normal(
                            size=3).tolist(), "rotation": rng.normal(
                            size=4).tolist()})
                    self.ego_pose.append({
                        "token": f"ep_{tok}", "translation": rng.normal(
                            size=3).tolist(), "rotation": rng.normal(
                            size=4).tolist()})
                    self.sample_data.append({
                        "token": tok, "prev": prev_sd, "path": path,
                        "timestamp": 1_000_000 * s + 50_000 * (3 * k + sweep),
                        "calibrated_sensor_token": f"cs_{tok}",
                        "ego_pose_token": f"ep_{tok}"})
                    prev_sd = tok
                sample_tok = f"sample_{s}_{k}"
                first = first or sample_tok
                anns = []
                for a in range(rng.randint(0, 5)):
                    atok = f"ann_{s}_{k}_{a}"
                    anns.append(atok)
                    self.sample_annotation.append({
                        "token": atok, "num_lidar_pts": int(rng.randint(0, 3)),
                        "num_radar_pts": int(rng.randint(0, 2))})
                    self._boxes.setdefault(prev_sd, []).append(
                        SimpleNamespace(
                            center=rng.normal(size=3) * 10,
                            wlh=rng.uniform(0.5, 5, 3),
                            orientation=tuple(rng.normal(size=4)),
                            velocity=rng.normal(size=3),
                            name=labels[rng.randint(len(labels))],
                            token=atok))
                self.sample.append({"token": sample_tok, "anns": anns,
                                    "scene_token": f"scene_{s}",
                                    "data": {"LIDAR_TOP": prev_sd}})
            self.scene.append({"token": f"scene_{s}", "name": f"scene-{s}",
                               "first_sample_token": first})
        self._tables = {t: {r["token"]: r for r in getattr(self, t)}
                        for t in ("scene", "sample", "sample_data",
                                  "calibrated_sensor", "ego_pose",
                                  "sample_annotation")}

    def get(self, table, token):
        return self._tables[table][token]

    def get_sample_data_path(self, token):
        return str(self._tables["sample_data"][token]["path"])

    def get_sample_data(self, token):
        return self.get_sample_data_path(token), \
            self._boxes.get(token, []), None


def test_fill_trainval_infos_equals_reference(tmp_path):
    nusc = DevkitStandIn(tmp_path)
    scenes = ni.get_available_scenes(nusc)
    assert [s["token"] for s in scenes] == \
        [s["token"] for s in jax_ni.get_available_scenes(nusc)] and \
        len(scenes) == 2
    for max_sweeps, test in ((10, False), (3, True)):
        mine = ni.fill_trainval_infos(tmp_path, nusc, {"scene_0"},
                                      {"scene_1"}, test=test,
                                      max_sweeps=max_sweeps)
        theirs = jax_ni.fill_trainval_infos(tmp_path, nusc, {"scene_0"},
                                            {"scene_1"}, test=test,
                                            max_sweeps=max_sweeps)
        assert_same(mine, theirs)
        assert len(mine[0]) == len(mine[1]) == 3
        assert all(len(i["sweeps"]) == max_sweeps - 1 for i in mine[0])
        assert all(("gt_boxes" in i) != test for i in mine[0] + mine[1])
        if not test:
            assert sum(len(i["gt_boxes"]) for i in mine[0] + mine[1]) > 0
    with pytest.raises(ImportError, match="devkit"):
        ni.create_nuscenes_info("v1.0-mini", tmp_path, tmp_path)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        create_infos.main(["waymo", "--cfg_file", str(NUSCENES_DATA),
                           "--data_path", str(tmp_path)])


def test_sweeps_and_test_frames_equal_reference(tree):
    ds, jds = _datasets(tree, training=False, seed=3)
    assert len(ds) == len(jds) == 2
    info = ds.infos[0]
    for sweep in info["sweeps"]:
        for a, b in zip(ds.get_sweep(sweep), jds.get_sweep(sweep)):
            assert np.array_equal(a, b)
    for j in range(2):
        frame = ds[j]
        ref = jds[j]
        for key in ("voxels", "voxel_coords", "voxel_num_points", "gt_boxes",
                    "frame_id"):
            assert np.array_equal(frame[key], ref[key]), key
        assert frame["metadata"] == ref["metadata"]
        assert frame["points"].shape[1] == 5
    # the time-lag column: 0 on the key sweep, the sweeps' lags after
    pts = ds.get_lidar_with_sweeps(0, max_sweeps=NUSCENES_SWEEPS)
    lags = {round(float(t), 6) for t in pts[:, 4]}
    assert lags == {0.0} | {round(s["time_lag"], 6) for s in info["sweeps"]}
    # FILTER_MIN_POINTS_IN_GT drops the object without points
    assert (info["num_lidar_pts"] == 0).sum() >= 1
    assert (ds[0]["gt_boxes"][:, -1] > 0).sum() == \
        (info["num_lidar_pts"] > 0).sum() < len(info["gt_boxes"])


def test_cbgs_resampling_equals_reference(tree):
    ds, jds = _datasets(tree, training=True, seed=7)
    assert len(ds.infos) == len(jds.infos) > 2
    assert [i["token"] for i in ds.infos] == [i["token"] for i in jds.infos]


def test_gt_database_equals_reference(tree, tmp_path):
    port, ref = tmp_path / "port", tmp_path / "ref"
    shutil.copytree(tree, port)
    shutil.copytree(tree, ref)
    ds, _ = _datasets(port, training=True, seed=5)
    _, jds = _datasets(ref, training=True, seed=5)
    ds.include_nuscenes_data("train")
    jds.include_nuscenes_data("train")
    ds.rng = np.random.RandomState(9)
    np.random.seed(9)
    out = ni.create_groundtruth_database(ds, max_sweeps=NUSCENES_SWEEPS)
    jout = jax_ni.create_groundtruth_database(jds, max_sweeps=NUSCENES_SWEEPS)
    with open(out, "rb") as f:
        mine = pickle.load(f)
    with open(jout, "rb") as f:
        theirs = pickle.load(f)
    assert_same(mine, theirs)
    assert sum(len(v) for v in mine.values()) > 0
    db = f"gt_database_{NUSCENES_SWEEPS}sweeps_withvelo"
    files = sorted(p.name for p in (port / db).iterdir())
    assert files == sorted(p.name for p in (ref / db).iterdir())
    for name in files:
        assert (port / db / name).read_bytes() == \
            (ref / db / name).read_bytes(), name


def test_predictions_and_evaluation_equal_reference(tree):
    ds, jds = _datasets(tree, training=False, seed=0)
    rng = np.random.RandomState(1)
    k = 16
    boxes = np.concatenate([ds.infos[0]["gt_boxes"][:k // 2],
                            rng.normal(size=(k // 2, 9)) * 10], 0)[None]
    boxes = np.concatenate([boxes, boxes[:, ::-1]], 0).astype(np.float32)
    preds = {"final_boxes": boxes,
             "final_scores": rng.uniform(0.1, 1, (2, k)).astype(np.float32),
             "final_labels": rng.randint(1, 11, (2, k)).astype(np.float32),
             "final_valid": rng.rand(2, k) > 0.2}
    batch = {"frame_id": np.array([ds[0]["frame_id"], ds[1]["frame_id"]])}
    mine = ds.generate_prediction_dicts(batch, preds, NAMES)
    assert_same(mine, jds.generate_prediction_dicts(batch, preds, NAMES))
    res, jres = ds.evaluation(mine, NAMES)[1], jds.evaluation(mine, NAMES)[1]
    assert sorted(res) == sorted(jres)
    for key in res:
        assert abs(res[key] - jres[key]) <= 1e-6, key
    # the gt boxes as detections score mAP 1
    gts = []
    for j in range(2):
        gt, names = ds.infos[j]["gt_boxes"], ds.infos[j]["gt_names"]
        gts.append({"frame_id": batch["frame_id"][j], "boxes": gt,
                    "scores": np.ones(len(gt)), "names": names,
                    "attributes": nd.default_attributes(gt, names)})
    res = ds.evaluation(gts, NAMES)[1]
    assert abs(res["mAP"] - 1.0) <= 1e-9, res


def test_reference_sampler_misreads_the_nuscenes_database(tree, tmp_path):
    """Pinned: the nuScenes gt database's infos carry no num_features, and
    the reference's sampler reshapes their 5-column points into 4; the
    port's reads the config's NUM_POINT_FEATURES (5)."""
    from q3d_tpu.datasets.augmentor.database_sampler import \
        DataBaseSampler as JaxSampler
    from q3d_tpu_torch.datasets.augmentor.database_sampler import \
        DataBaseSampler
    root = tmp_path / "db"
    shutil.copytree(tree, root)
    ds, _ = _datasets(root, training=True, seed=5)
    ds.include_nuscenes_data("train")
    out = ni.create_groundtruth_database(ds, max_sweeps=NUSCENES_SWEEPS)
    cfg, jcfg = configs(NUSCENES_DATA, NUSCENES_SETS)
    for c in (cfg, jcfg):
        c.DATA_AUGMENTOR.AUG_CONFIG_LIST[0].DB_INFO_PATH = [out.name]
    sampler = DataBaseSampler(root, cfg.DATA_AUGMENTOR.AUG_CONFIG_LIST[0],
                              NAMES)
    jsampler = JaxSampler(root, jcfg.DATA_AUGMENTOR.AUG_CONFIG_LIST[0],
                          NAMES)
    infos = [i for v in sampler.db_infos.values() for i in v]
    assert infos and "num_features" not in infos[0]
    for info in infos:
        points = sampler._load_points(info)
        assert points.shape == (info["num_points_in_gt"], 5)
        if not len(points):
            continue
        try:
            theirs = jsampler._load_points(info)
        except ValueError:                 # 5 N not a multiple of 4
            continue
        assert theirs.shape[1] == 4 and theirs.shape[0] != len(points)
