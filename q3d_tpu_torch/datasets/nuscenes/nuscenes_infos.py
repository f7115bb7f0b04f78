"""nuScenes info pickles and the gt database.

Port of ``q3d_tpu/datasets/nuscenes/nuscenes_infos.py``: the train / val
info pickles (each key frame's lidar file, its earlier sweeps with their
sweep -> key transform chains and time lags, the lidar-frame gt boxes with
velocity) from the devkit's tables, and the class-grouped gt database the
augmentor's gt sampling reads.  ``create_nuscenes_info`` needs the
``nuscenes`` devkit, as the reference does; ``get_available_scenes`` and
``fill_trainval_infos`` take any object with the devkit's tables and its
``get`` / ``get_sample_data`` / ``get_sample_data_path``.  The quaternion
arithmetic is numpy (no pyquaternion).

Info schema ``NuScenesDataset`` reads:
  lidar_path, token, timestamp, sweeps[{lidar_path, transform_matrix,
  time_lag}], gt_boxes (N, 9) [x y z dx dy dz yaw vx vy], gt_names,
  num_lidar_pts.
"""

import pickle
from pathlib import Path

import numpy as np

from ...utils.box_utils import points_in_boxes_cpu

# general -> detection class mapping (nuScenes protocol constants;
# reference nuscenes_utils.py map_name_from_general_to_detection)
MAP_NAME_TO_DETECTION = {
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.wheelchair": "ignore",
    "human.pedestrian.stroller": "ignore",
    "human.pedestrian.personal_mobility": "ignore",
    "human.pedestrian.police_officer": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "animal": "ignore",
    "vehicle.car": "car",
    "vehicle.motorcycle": "motorcycle",
    "vehicle.bicycle": "bicycle",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.truck": "truck",
    "vehicle.construction": "construction_vehicle",
    "vehicle.emergency.ambulance": "ignore",
    "vehicle.emergency.police": "ignore",
    "vehicle.trailer": "trailer",
    "movable_object.barrier": "barrier",
    "movable_object.trafficcone": "traffic_cone",
    "movable_object.pushable_pullable": "ignore",
    "movable_object.debris": "ignore",
    "static_object.bicycle_rack": "ignore",
}


def quat_to_rotmat(q):
    """(w, x, y, z) quaternion -> (3, 3) rotation matrix."""
    w, x, y, z = [float(v) for v in q]
    n = w * w + x * x + y * y + z * z
    s = 0.0 if n < 1e-12 else 2.0 / n
    return np.array([
        [1 - s * (y * y + z * z), s * (x * y - z * w), s * (x * z + y * w)],
        [s * (x * y + z * w), 1 - s * (x * x + z * z), s * (y * z - x * w)],
        [s * (x * z - y * w), s * (y * z + x * w), 1 - s * (x * x + y * y)],
    ])


def quaternion_yaw(q):
    """Yaw of a quaternion: the rotated x-axis' angle in the xy plane
    (reference lyft_utils.quaternion_yaw / devkit convention)."""
    v = quat_to_rotmat(q) @ np.array([1.0, 0.0, 0.0])
    return float(np.arctan2(v[1], v[0]))


def transform_matrix(translation, rotation_q, inverse=False):
    """4x4 homogeneous transform from translation + (w,x,y,z) quaternion
    (devkit geometry_utils.transform_matrix semantics)."""
    tm = np.eye(4)
    R = quat_to_rotmat(rotation_q)
    t = np.asarray(translation, np.float64)
    if inverse:
        tm[:3, :3] = R.T
        tm[:3, 3] = -R.T @ t
    else:
        tm[:3, :3] = R
        tm[:3, 3] = t
    return tm


def get_available_scenes(nusc):
    """Scenes whose first key frame's lidar file exists on disk."""
    available = []
    for scene in nusc.scene:
        sample_rec = nusc.get("sample", scene["first_sample_token"])
        sd_rec = nusc.get("sample_data", sample_rec["data"]["LIDAR_TOP"])
        lidar_path, _, _ = nusc.get_sample_data(sd_rec["token"])
        if Path(lidar_path).exists():
            available.append(scene)
    return available


def fill_trainval_infos(data_path, nusc, train_scenes, val_scenes,
                        test=False, max_sweeps=10):
    """Per sample: its key lidar frame, ``max_sweeps - 1`` earlier sweeps
    with their ref <- sweep transform chains and time lags (the last one
    repeated where the scene has fewer), and, unless ``test``, the
    lidar-frame gt boxes with velocity -> (train infos, val infos)."""
    train_infos, val_infos = [], []
    for sample in nusc.sample:
        ref_sd_token = sample["data"]["LIDAR_TOP"]
        ref_sd_rec = nusc.get("sample_data", ref_sd_token)
        ref_cs_rec = nusc.get("calibrated_sensor",
                              ref_sd_rec["calibrated_sensor_token"])
        ref_pose_rec = nusc.get("ego_pose", ref_sd_rec["ego_pose_token"])
        ref_time = 1e-6 * ref_sd_rec["timestamp"]
        ref_lidar_path, ref_boxes, _ = nusc.get_sample_data(ref_sd_token)

        ref_from_car = transform_matrix(
            ref_cs_rec["translation"], ref_cs_rec["rotation"], inverse=True)
        car_from_global = transform_matrix(
            ref_pose_rec["translation"], ref_pose_rec["rotation"],
            inverse=True)

        info = {
            "lidar_path": str(Path(ref_lidar_path).relative_to(data_path)),
            "token": sample["token"],
            "sweeps": [],
            "ref_from_car": ref_from_car,
            "car_from_global": car_from_global,
            "timestamp": ref_time,
        }

        curr_sd_rec = ref_sd_rec
        sweeps = []
        while len(sweeps) < max_sweeps - 1:
            if curr_sd_rec["prev"] == "":
                if len(sweeps) == 0:
                    sweeps.append({
                        "lidar_path": info["lidar_path"],
                        "sample_data_token": curr_sd_rec["token"],
                        "transform_matrix": None,
                        "time_lag": 0.0,
                    })
                else:
                    sweeps.append(sweeps[-1])
            else:
                curr_sd_rec = nusc.get("sample_data", curr_sd_rec["prev"])
                pose_rec = nusc.get("ego_pose",
                                    curr_sd_rec["ego_pose_token"])
                global_from_car = transform_matrix(
                    pose_rec["translation"], pose_rec["rotation"],
                    inverse=False)
                cs_rec = nusc.get("calibrated_sensor",
                                  curr_sd_rec["calibrated_sensor_token"])
                car_from_current = transform_matrix(
                    cs_rec["translation"], cs_rec["rotation"], inverse=False)
                tm = ref_from_car @ car_from_global @ global_from_car \
                    @ car_from_current
                lidar_path = nusc.get_sample_data_path(curr_sd_rec["token"])
                sweeps.append({
                    "lidar_path": str(Path(lidar_path).relative_to(
                        data_path)),
                    "sample_data_token": curr_sd_rec["token"],
                    "transform_matrix": tm,
                    "time_lag": ref_time - 1e-6 * curr_sd_rec["timestamp"],
                })
        info["sweeps"] = sweeps

        if not test:
            annotations = [nusc.get("sample_annotation", t)
                           for t in sample["anns"]]
            num_lidar_pts = np.array([a["num_lidar_pts"]
                                      for a in annotations])
            num_radar_pts = np.array([a["num_radar_pts"]
                                      for a in annotations])
            mask = (num_lidar_pts + num_radar_pts) > 0
            locs = np.array([b.center for b in ref_boxes]).reshape(-1, 3)
            # wlh -> (dx=l, dy=w, dz=h)
            dims = np.array([b.wlh for b in ref_boxes]).reshape(
                -1, 3)[:, [1, 0, 2]]
            velocity = np.array([b.velocity for b in ref_boxes]).reshape(
                -1, 3)
            rots = np.array([quaternion_yaw(list(b.orientation))
                             for b in ref_boxes]).reshape(-1, 1)
            names = np.array([MAP_NAME_TO_DETECTION.get(b.name, b.name)
                              for b in ref_boxes])
            gt_boxes = np.concatenate(
                [locs, dims, rots, velocity[:, :2]], axis=1)
            info["gt_boxes"] = gt_boxes[mask]
            info["gt_boxes_velocity"] = velocity[mask]
            info["gt_names"] = names[mask]
            info["gt_boxes_token"] = np.array(
                [b.token for b in ref_boxes])[mask]
            info["num_lidar_pts"] = num_lidar_pts[mask]
            info["num_radar_pts"] = num_radar_pts[mask]

        if sample["scene_token"] in train_scenes:
            train_infos.append(info)
        else:
            val_infos.append(info)
    return train_infos, val_infos


def create_nuscenes_info(version, data_path, save_path, max_sweeps=10,
                         logger=None):
    """The devkit's split of ``version`` -> its info pickles under
    ``save_path/version`` -> their paths.  Raises ImportError without the
    ``nuscenes`` devkit (nuscenes-devkit)."""
    try:
        from nuscenes.nuscenes import NuScenes
        from nuscenes.utils import splits
    except ImportError as e:
        raise ImportError(
            "create_nuscenes_info needs the nuScenes devkit (the "
            "'nuscenes' package of nuscenes-devkit), which is not "
            "installed") from e
    data_path = Path(data_path) / version
    save_path = Path(save_path) / version
    save_path.mkdir(parents=True, exist_ok=True)

    if version not in ("v1.0-trainval", "v1.0-test", "v1.0-mini"):
        raise ValueError(f"unknown nuScenes version {version}")
    split_map = {"v1.0-trainval": (splits.train, splits.val),
                 "v1.0-test": (splits.test, []),
                 "v1.0-mini": (splits.mini_train, splits.mini_val)}
    train_names, val_names = split_map[version]

    nusc = NuScenes(version=version, dataroot=str(data_path), verbose=True)
    available = get_available_scenes(nusc)
    names = [s["name"] for s in available]
    train_scenes = {available[names.index(s)]["token"]
                    for s in train_names if s in names}
    val_scenes = {available[names.index(s)]["token"]
                  for s in val_names if s in names}
    if logger:
        logger.info(f"{version}: train scenes {len(train_scenes)}, "
                    f"val scenes {len(val_scenes)}")

    train_infos, val_infos = fill_trainval_infos(
        data_path, nusc, train_scenes, val_scenes,
        test="test" in version, max_sweeps=max_sweeps)

    if version == "v1.0-test":
        out = save_path / f"nuscenes_infos_{max_sweeps}sweeps_test.pkl"
        with open(out, "wb") as f:
            pickle.dump(train_infos, f)
        return [out]
    out_train = save_path / f"nuscenes_infos_{max_sweeps}sweeps_train.pkl"
    out_val = save_path / f"nuscenes_infos_{max_sweeps}sweeps_val.pkl"
    with open(out_train, "wb") as f:
        pickle.dump(train_infos, f)
    with open(out_val, "wb") as f:
        pickle.dump(val_infos, f)
    return [out_train, out_val]


def create_groundtruth_database(dataset, used_classes=None, max_sweeps=10):
    """Each gt object's points (its frame's ``max_sweeps`` sweeps, relative
    to the box centre) as ``gt_database_<n>sweeps_withvelo/<idx>_<name>_<i>
    .bin``, and their infos by class as ``nuscenes_dbinfos_<n>sweeps_withvelo
    .pkl`` -> that file's path.  ``dataset``: a NuScenesDataset over the
    train infos; the sweeps are drawn from its ``rng``."""

    root = Path(dataset.root_path)
    database_save_path = root / f"gt_database_{max_sweeps}sweeps_withvelo"
    db_info_save_path = root / f"nuscenes_dbinfos_{max_sweeps}sweeps_withvelo.pkl"
    database_save_path.mkdir(parents=True, exist_ok=True)
    all_db_infos = {}

    for idx in range(len(dataset.infos)):
        info = dataset.infos[idx]
        points = dataset.get_lidar_with_sweeps(idx, max_sweeps=max_sweeps)
        gt_boxes = np.asarray(info["gt_boxes"])
        gt_names = np.asarray(info["gt_names"])
        if len(gt_boxes) == 0:
            continue
        flags = np.asarray(points_in_boxes_cpu(
            points[:, 0:3].astype(np.float32),
            gt_boxes[:, 0:7].astype(np.float32)))       # (M, N) 0/1
        for i in range(gt_boxes.shape[0]):
            filename = f"{idx}_{gt_names[i]}_{i}.bin"
            filepath = database_save_path / filename
            gt_points = points[flags[i].astype(bool)]
            gt_points[:, :3] -= gt_boxes[i, :3]
            gt_points.astype(np.float32).tofile(str(filepath))
            if used_classes is None or gt_names[i] in used_classes:
                db_info = {"name": gt_names[i],
                           "path": str(filepath.relative_to(root)),
                           "image_idx": idx, "gt_idx": i,
                           "box3d_lidar": gt_boxes[i],
                           "num_points_in_gt": gt_points.shape[0]}
                all_db_infos.setdefault(gt_names[i], []).append(db_info)

    with open(db_info_save_path, "wb") as f:
        pickle.dump(all_db_infos, f)
    return db_info_save_path
