"""Synthetic nuScenes trees: multi-sweep lidar files and info pickles in
the dataset's on-disk format, for the tests and the card's smoke run.

No nuScenes data is in the repository.  ``write_nuscenes_tree`` writes
frames as the devkit's export leaves them for ``NuScenesDataset``: each
frame a key sweep (``samples/LIDAR_TOP/<token>.pcd.bin``) and ``sweeps - 1``
earlier ones (``sweeps/LIDAR_TOP/``), each of 5 float32 columns (x, y, z,
intensity, ring) in its own lidar frame, and
``nuscenes_infos_<sweeps>sweeps_<split>.pkl`` in the schema of
``nuscenes_infos.py``: ``lidar_path``, ``token``, ``timestamp``, ``sweeps``
(``lidar_path``, ``transform_matrix`` sweep -> key lidar frame,
``time_lag``), ``gt_boxes`` (N, 9: x y z dx dy dz yaw vx vy in the key
lidar frame), ``gt_names``, ``num_lidar_pts`` (the key sweep's points in
each box).

A frame: the ego drives ``EGO_SPEED`` m/s along +x, turning slowly, and
the sweeps are ``SWEEP_DT`` s apart (0.5 m); each sweep holds ground rings
about the sensor, a few returns off the ego's own body (within 1 m, which
``get_sweep`` drops), the static walls of the frame (the same surfaces in
every sweep, as buildings re-scanned), and ``points_per_object`` points on
each object's surfaces where the object was at the sweep's time (it moves
at its gt velocity).  The objects cycle through the ten detection classes
at their mean nuScenes sizes; the last ``occluded`` objects of a frame get
no points (``FILTER_MIN_POINTS_IN_GT`` drops them).  At the defaults a
frame's 10 sweeps hold ~259,000 points (23,000 background and 48 objects
x 60 points a sweep), centerpoint_ref.yaml's point count.
"""

import pickle
from pathlib import Path

import numpy as np

from ..utils.box_utils import points_in_boxes_cpu

CLASSES = ("car", "truck", "construction_vehicle", "bus", "trailer",
           "barrier", "motorcycle", "bicycle", "pedestrian", "traffic_cone")
# mean (dx, dy, dz) of each class in nuScenes' train split
SIZES = {"car": (4.63, 1.97, 1.74), "truck": (6.93, 2.51, 2.84),
         "construction_vehicle": (6.37, 2.85, 3.19),
         "bus": (10.50, 2.94, 3.47), "trailer": (12.29, 2.90, 3.87),
         "barrier": (0.50, 2.53, 0.98), "motorcycle": (2.11, 0.77, 1.47),
         "bicycle": (1.70, 0.60, 1.28), "pedestrian": (0.73, 0.67, 1.77),
         "traffic_cone": (0.41, 0.41, 1.07)}
# the most speed of each class in m/s (static classes 0)
MAX_SPEED = {"car": 10.0, "truck": 8.0, "construction_vehicle": 2.0,
             "bus": 8.0, "trailer": 6.0, "barrier": 0.0, "motorcycle": 10.0,
             "bicycle": 5.0, "pedestrian": 1.5, "traffic_cone": 0.0}
EGO_SPEED = 10.0            # m/s along the ego's +x
EGO_YAW_RATE = 0.04         # rad/s
SWEEP_DT = 0.05             # s between sweeps (20 Hz)
SENSOR_HEIGHT = 1.84        # the ground at z = -SENSOR_HEIGHT
SCENE = {"bg_points": 23000, "num_objects": 48, "points_per_object": 60,
         "occluded": 2}
EGO_POINTS = 100            # returns off the ego's body, within 1 m
WALL_SHARE = 0.6            # of the background on the static walls
NUM_WALLS = 20


def _rot_z(yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def sweep_pose(k):
    """Sweep ``k`` (0 the key) -> 4x4 transform from its lidar frame to the
    key frame's: the ego ``k * SWEEP_DT`` s earlier."""
    t = k * SWEEP_DT
    yaw = -EGO_YAW_RATE * t
    tm = np.eye(4)
    tm[:3, :3] = _rot_z(yaw)
    tm[:3, 3] = [-EGO_SPEED * t, 0.0, 0.0]
    return tm


def _objects(rng, num_objects, radius):
    """Boxes (N, 9) in the key lidar frame and their names: centres
    3-``radius`` m out, apart from each other, the classes in turn."""
    boxes, names = [], []
    while len(boxes) < num_objects:
        name = CLASSES[len(boxes) % len(CLASSES)]
        dx, dy, dz = (s * rng.uniform(0.9, 1.1) for s in SIZES[name])
        r, a = rng.uniform(3.0, radius), rng.uniform(-np.pi, np.pi)
        x, y = r * np.cos(a), r * np.sin(a)
        if any(np.hypot(x - b[0], y - b[1]) < (max(dx, dy) + max(b[3], b[4]))
               / 2 + 0.5 for b in boxes):
            continue
        yaw = rng.uniform(-np.pi, np.pi)
        speed = rng.uniform(0.0, MAX_SPEED[name])
        boxes.append([x, y, -SENSOR_HEIGHT + dz / 2, dx, dy, dz, yaw,
                      speed * np.cos(yaw), speed * np.sin(yaw)])
        names.append(name)
    return np.asarray(boxes), np.asarray(names)


def _walls(rng, radius):
    """The frame's static walls: (NUM_WALLS, 6) centre x, y, length,
    height, facing angle, base z."""
    r = rng.uniform(15.0, radius, NUM_WALLS)
    a = rng.uniform(-np.pi, np.pi, NUM_WALLS)
    return np.stack([r * np.cos(a), r * np.sin(a),
                     rng.uniform(6.0, 12.0, NUM_WALLS),
                     rng.uniform(2.0, 4.0, NUM_WALLS),
                     rng.uniform(-np.pi, np.pi, NUM_WALLS),
                     np.full(NUM_WALLS, -SENSOR_HEIGHT)], axis=1)


def _surface_points(rng, box, n):
    """``n`` points on the sides and top of ``box`` (x, y, z, dx, dy, dz,
    yaw), in its frame's coordinates."""
    face = rng.randint(0, 5, n)
    u, v = rng.uniform(-0.5, 0.5, n), rng.uniform(-0.5, 0.5, n)
    fixed = np.where(face % 2 == 0, 0.5, -0.5)
    local = np.stack([np.where(face < 2, fixed, u),
                      np.where(face < 2, u, np.where(face < 4, fixed, v)),
                      np.where(face < 4, v, 0.5)], axis=1) * box[3:6]
    return local @ _rot_z(box[6]).T + box[:3]


def _sweep_points(rng, k, boxes, walls, scene, n_with_points):
    """Sweep ``k``'s points (N, 5) in its own lidar frame."""
    bg = scene["bg_points"] - EGO_POINTS
    n_wall = int(bg * WALL_SHARE)
    n_ring = bg - n_wall
    # ground rings about the sensor (the sweep's frame): 32 beams
    radii = np.geomspace(2.5, 60.0, 32)
    per = n_ring // len(radii)
    ring_r = np.repeat(radii, per) * (1 + rng.normal(0, 0.003, per * 32))
    theta = np.tile(np.linspace(-np.pi, np.pi, per, endpoint=False), 32) \
        + rng.normal(0, 5e-4, per * 32)
    ground = np.stack([ring_r * np.cos(theta), ring_r * np.sin(theta),
                       rng.normal(-SENSOR_HEIGHT, 0.03, ring_r.shape)], 1)
    ground_ring = np.repeat(np.arange(32.0), per)
    # the ego's body: within 1 m of the sensor, below it
    ego = np.stack([rng.uniform(-0.9, 0.9, EGO_POINTS),
                    rng.uniform(-0.9, 0.9, EGO_POINTS),
                    rng.uniform(-1.5, -0.3, EGO_POINTS)], 1)
    # the walls and the objects, placed in the key frame, then moved into
    # the sweep's frame
    w = walls[rng.randint(0, len(walls), n_wall)]
    s = rng.uniform(-0.5, 0.5, n_wall) * w[:, 2]
    wall = np.stack([w[:, 0] - s * np.sin(w[:, 4]),
                     w[:, 1] + s * np.cos(w[:, 4]),
                     w[:, 5] + rng.uniform(0, 1, n_wall) * w[:, 3]], 1)
    t = k * SWEEP_DT
    objs = []
    for box in boxes[:n_with_points]:
        moved = box.copy()
        moved[:2] -= box[7:9] * t
        objs.append(_surface_points(rng, moved, scene["points_per_object"]))
    keyframe = np.concatenate([wall, *objs], axis=0)
    inv = np.linalg.inv(sweep_pose(k))
    in_sweep = keyframe @ inv[:3, :3].T + inv[:3, 3]
    xyz = np.concatenate([ground, ego, in_sweep], axis=0)
    n = len(xyz)
    intensity = rng.uniform(0.0, 100.0, n)
    ring = np.concatenate([ground_ring, rng.randint(0, 32, n - len(ground))])
    return np.concatenate([xyz, intensity[:, None], ring[:, None]],
                          axis=1).astype(np.float32)


def write_nuscenes_tree(root, num_frames, seed, split="val", sweeps=10,
                        scene=None, radius=48.0):
    """Write ``num_frames`` frames of ``sweeps`` sweeps each, drawn from
    ``np.random.RandomState(seed + j)``, under ``root``, and their infos as
    ``nuscenes_infos_<sweeps>sweeps_<split>.pkl`` -> the infos.  ``scene``
    overrides SCENE's point and object counts (the tests' small trees)."""
    root = Path(root)
    scene = {**SCENE, **(scene or {})}
    (root / "samples" / "LIDAR_TOP").mkdir(parents=True, exist_ok=True)
    (root / "sweeps" / "LIDAR_TOP").mkdir(parents=True, exist_ok=True)
    infos = []
    for j in range(num_frames):
        rng = np.random.RandomState(seed + j)
        token = f"{split}_{seed}_{j:04d}"
        boxes, names = _objects(rng, scene["num_objects"] + scene["occluded"],
                                radius)
        walls = _walls(rng, radius + 6.0)
        timestamp = 1.5e9 + 20.0 * (seed + j)
        sweep_infos, key_points = [], None
        for k in range(sweeps):
            pts = _sweep_points(rng, k, boxes, walls, scene,
                                scene["num_objects"])
            if k == 0:
                rel = Path("samples") / "LIDAR_TOP" / f"{token}.pcd.bin"
                key_points = pts
            else:
                rel = Path("sweeps") / "LIDAR_TOP" / f"{token}_{k}.pcd.bin"
                sweep_infos.append({
                    "lidar_path": str(rel), "sample_data_token": f"{token}_{k}",
                    "transform_matrix": sweep_pose(k),
                    "time_lag": k * SWEEP_DT})
            pts.tofile(root / rel)
        num_pts = points_in_boxes_cpu(key_points[:, :3],
                                      boxes[:, :7]).sum(axis=1)
        infos.append({
            "lidar_path": str(Path("samples") / "LIDAR_TOP"
                              / f"{token}.pcd.bin"),
            "token": token, "timestamp": timestamp, "sweeps": sweep_infos,
            "gt_boxes": boxes.astype(np.float64), "gt_names": names,
            "num_lidar_pts": num_pts.astype(np.int64)})
    with open(root / f"nuscenes_infos_{sweeps}sweeps_{split}.pkl", "wb") as f:
        pickle.dump(infos, f)
    return infos
