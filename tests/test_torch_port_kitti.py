"""PyTorch port vs the JAX package: the KITTI dataset's host side.

On a small KITTI tree that ``kitti_synthetic.write_kitti_tree`` writes
under ``tmp_path`` (the port's synthetic KITTI scans, their calibration and
labels), both packages' readers, camera conversions, infos, gt database,
frames, prediction export and official evaluator are run on the same
inputs.  Everything here is host numpy in both packages and is held equal,
but the rotated overlaps of the evaluator (the port's torch IoU against
the reference's XLA one, within 1e-6).

The reference's ``KittiDataset.__getitem__`` never reads
``FOV_POINTS_ONLY``: ``test_reference_ignores_fov_points_only`` pins it,
and the frame parity test patches the reference's ``get_lidar`` with
OpenPCDet's ``get_fov_flag`` in the test only.
"""

import pickle
import shutil
import struct
import zlib

import numpy as np
import pytest
import torch

import q3d_tpu.datasets.kitti.kitti_dataset as jax_kd
import q3d_tpu.datasets.kitti.kitti_eval as jax_eval
from q3d_tpu.utils import box_utils as jax_box
from q3d_tpu.utils import calibration_kitti as jax_calib
from q3d_tpu.utils import object3d_kitti as jax_obj

from q3d_tpu_torch.datasets import build_dataloader
from q3d_tpu_torch.datasets.kitti import kitti_eval
from q3d_tpu_torch.datasets.kitti.kitti_dataset import KittiDataset, png_size
from q3d_tpu_torch.datasets.kitti_synthetic import kitti_scene
from q3d_tpu_torch.tools import create_infos
from q3d_tpu_torch.utils import box_utils, calibration_kitti, object3d_kitti
from torch_port_dataset_common import (KITTI_DATA, SECOND, assert_same,
                                       configs, fov_get_lidar,
                                       write_small_kitti)
from torch_port_jax_cache import jax_compile_cache  # noqa: F401

torch.set_num_threads(2)

CLASSES = ["Car", "Pedestrian", "Cyclist"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A KITTI tree (2 val frames, 2 train) with the port's infos and gt
    database, and a copy with the reference's."""
    root = tmp_path_factory.mktemp("kitti")
    port, ref = root / "port", root / "ref"
    sds = write_small_kitti(port)
    shutil.copytree(port, ref)
    create_infos.main(["kitti", "--cfg_file", str(KITTI_DATA), "--data_path",
                       str(port), "--with_gt_database"])
    _, jcfg = configs(KITTI_DATA)
    jax_kd.create_kitti_infos(jcfg, CLASSES, str(ref), str(ref))
    jds = jax_kd.KittiDataset(dataset_cfg=jcfg, class_names=CLASSES,
                              root_path=str(ref), training=False)
    jds.create_groundtruth_database(ref / "kitti_infos_train.pkl",
                                    used_classes=CLASSES, split="train")
    return port, ref, sds


def test_calibration_labels_and_conversions_equal_reference(tree):
    port, _, _ = tree
    calib_file = str(port / "training" / "calib" / "000000.txt")
    ours, ref = calibration_kitti.Calibration(calib_file), \
        jax_calib.Calibration(calib_file)
    for name in ("P2", "R0", "V2C", "cu", "cv", "fu", "fv", "tx", "ty"):
        assert np.array_equal(getattr(ours, name), getattr(ref, name)), name
    rng = np.random.RandomState(0)
    pts = rng.uniform([-10, -30, -3], [70, 30, 2], (500, 3))
    for fn in ("lidar_to_rect", "rect_to_lidar"):
        assert np.array_equal(getattr(ours, fn)(pts), getattr(ref, fn)(pts))
    for a, b in zip(ours.lidar_to_img(pts), ref.lidar_to_img(pts)):
        assert np.array_equal(a, b)
    assert np.array_equal(ours.img_to_rect(pts[:, 0], pts[:, 1], pts[:, 2]),
                          ref.img_to_rect(pts[:, 0], pts[:, 1], pts[:, 2]))

    label = str(port / "training" / "label_2" / "000000.txt")
    objs, jobjs = object3d_kitti.get_objects_from_label(label), \
        jax_obj.get_objects_from_label(label)
    assert len(objs) == len(jobjs) > 0
    for o, j in zip(objs, jobjs):
        for name in ("cls_type", "cls_id", "truncation", "occlusion", "alpha",
                     "h", "w", "l", "dis_to_cam", "ry", "score", "level",
                     "level_str"):
            assert getattr(o, name) == getattr(j, name), name
        assert np.array_equal(o.box2d, j.box2d) and \
            np.array_equal(o.loc, j.loc)
        assert o.to_str() == j.to_str()
    assert {o.level for o in objs} - {-1, 0, 1, 2} == set()

    boxes = np.concatenate([rng.uniform([0, -20, -2], [60, 20, 0], (40, 3)),
                            rng.uniform(0.5, 5, (40, 3)),
                            rng.uniform(-np.pi, np.pi, (40, 1))], axis=1)
    cam = box_utils.boxes3d_lidar_to_kitti_camera(boxes, ours)
    assert np.array_equal(cam, jax_box.boxes3d_lidar_to_kitti_camera(boxes,
                                                                     ref))
    assert np.array_equal(box_utils.boxes3d_kitti_camera_to_lidar(cam, ours),
                          jax_box.boxes3d_kitti_camera_to_lidar(cam, ref))
    assert np.array_equal(box_utils.camera_boxes_to_corners_3d(cam),
                          jax_box.camera_boxes_to_corners_3d(cam))
    for shape in (None, np.array([375, 1242])):
        assert np.array_equal(
            box_utils.boxes3d_kitti_camera_to_imageboxes(cam, ours, shape),
            jax_box.boxes3d_kitti_camera_to_imageboxes(cam, ref, shape))


def _png(path, width, height):
    """A grey PNG of the given size (stored deflate, no PIL)."""
    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + \
            struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)
    raw = b"".join(b"\x00" + bytes(width) for _ in range(height))
    path.write_bytes(b"\x89PNG\r\n\x1a\n"
                     + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height,
                                                  8, 0, 0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(raw))
                     + chunk(b"IEND", b""))


def test_image_shape_from_the_png_header(tree, tmp_path):
    port, _, _ = tree
    _, jcfg = configs(KITTI_DATA)
    cfg, _ = configs(KITTI_DATA)
    root = tmp_path / "img"
    shutil.copytree(port / "ImageSets", root / "ImageSets")
    (root / "training" / "image_2").mkdir(parents=True)
    _png(root / "training" / "image_2" / "000001.png", 1224, 370)
    ours = KittiDataset(cfg, CLASSES, training=False, root_path=root)
    ref = jax_kd.KittiDataset(dataset_cfg=jcfg, class_names=CLASSES,
                              training=False, root_path=str(root))
    assert png_size(root / "training" / "image_2" / "000001.png") == \
        (1224, 370)
    for idx in ("000000", "000001"):         # no image -> (375, 1242)
        assert np.array_equal(ours.get_image_shape(idx),
                              ref.get_image_shape(idx))
    assert ours.get_image_shape("000001").tolist() == [370, 1224]


def test_create_infos_and_gt_database_equal_reference(tree):
    port, ref, _ = tree
    for name in ("kitti_infos_train.pkl", "kitti_infos_val.pkl",
                 "kitti_dbinfos_train.pkl"):
        with open(port / name, "rb") as f:
            mine = pickle.load(f)
        with open(ref / name, "rb") as f:
            theirs = pickle.load(f)
        assert_same(mine, theirs, name)
    with open(port / "kitti_infos_train.pkl", "rb") as f:
        infos = pickle.load(f)
    assert all(info["annos"]["num_points_in_gt"].sum() > 0 for info in infos)
    files = sorted(p.name for p in (port / "gt_database_train").iterdir())
    assert files == sorted(p.name for p in (ref / "gt_database_train")
                           .iterdir()) and files
    for name in files:
        assert (port / "gt_database_train" / name).read_bytes() == \
            (ref / "gt_database_train" / name).read_bytes(), name


def test_reference_ignores_fov_points_only(tree):
    """Pinned: with FOV_POINTS_ONLY true the reference keeps the whole
    scan, points behind and beside the camera included."""
    port, ref, sds = tree
    cfg, jcfg = configs(KITTI_DATA)
    assert jcfg.FOV_POINTS_ONLY is True
    jds = jax_kd.KittiDataset(dataset_cfg=jcfg, class_names=CLASSES,
                              training=False, root_path=str(ref))
    ds = KittiDataset(cfg, CLASSES, training=False, root_path=port)
    whole = jds.get_lidar("000000")
    calib = jds.get_calib("000000")
    uv, depth = calib.rect_to_img(calib.lidar_to_rect(whole[:, :3]))
    assert (depth < 0).sum() > 0 and (uv[:, 0] < 0).sum() > 0
    ref_vox = (jds[0]["voxel_num_points"] > 0).sum()
    port_vox = (ds[0]["voxel_num_points"] > 0).sum()
    assert ref_vox > 1.5 * port_vox
    # the port keeps exactly what the camera sees: kitti_scene's crop
    points = ds.get_lidar("000000")
    kept = points[kitti_fov_flag(ds, "000000", points)]
    assert np.array_equal(kept, kitti_scene(sds, 0)[0])


def kitti_fov_flag(ds, idx, points):
    from q3d_tpu_torch.datasets.kitti.kitti_dataset import get_fov_flag
    calib = ds.get_calib(idx)
    return get_fov_flag(calib.lidar_to_rect(points[:, :3]),
                        ds.get_image_shape(idx), calib)


def test_frames_equal_reference_with_its_fov_crop(tree, monkeypatch):
    port, ref, _ = tree
    monkeypatch.setattr(jax_kd.KittiDataset, "get_lidar",
                        fov_get_lidar(jax_kd.KittiDataset))
    cfg, jcfg = configs(SECOND)
    _, loader, _ = build_dataloader(cfg.DATA_CONFIG, CLASSES, 2,
                                    root_path=port, training=False)
    from q3d_tpu.datasets import build_dataloader as jax_build_dataloader
    _, jloader, _ = jax_build_dataloader(jcfg.DATA_CONFIG, CLASSES, 2,
                                         root_path=str(ref), training=False)
    batch, jbatch = next(iter(loader)), next(iter(jloader))
    for key in ("voxels", "voxel_coords", "voxel_num_points", "gt_boxes",
                "frame_id", "image_shape"):
        assert np.array_equal(batch[key], jbatch[key]), key
    assert isinstance(batch["calib"], list) and len(batch["calib"]) == 2
    assert np.array_equal(batch["calib"][1].V2C, jbatch["calib"][1].V2C)


def _predictions(seed, frames=2, k=12):
    rng = np.random.RandomState(seed)
    boxes = np.concatenate([rng.uniform([2, -20, -2], [60, 20, 0],
                                        (frames, k, 3)),
                            rng.uniform(0.5, 4, (frames, k, 3)),
                            rng.uniform(-np.pi, np.pi, (frames, k, 1))], -1)
    valid = rng.rand(frames, k) > 0.3
    valid[1] = False                           # a frame without detections
    return {"final_boxes": boxes.astype(np.float32),
            "final_scores": rng.uniform(0.1, 1, (frames, k)).astype(
                np.float32),
            "final_labels": rng.randint(1, 4, (frames, k)).astype(np.float32),
            "final_valid": valid}


def test_prediction_dicts_and_result_files_equal_reference(tree, tmp_path):
    port, ref, _ = tree
    cfg, jcfg = configs(KITTI_DATA)
    ds = KittiDataset(cfg, CLASSES, training=False, root_path=port)
    jds = jax_kd.KittiDataset(dataset_cfg=jcfg, class_names=CLASSES,
                              training=False, root_path=str(ref))
    preds = _predictions(0)
    batch = {"frame_id": np.array(["000000", "000001"]),
             "image_shape": np.array([[375, 1242]] * 2)}
    mine = ds.generate_prediction_dicts(
        {**batch, "calib": [ds.get_calib(i) for i in batch["frame_id"]]},
        preds, CLASSES, output_path=tmp_path / "port")
    theirs = jds.generate_prediction_dicts(
        {**batch, "calib": [jds.get_calib(i) for i in batch["frame_id"]]},
        preds, CLASSES, output_path=tmp_path / "ref")
    assert_same(mine, theirs)
    assert len(mine[0]["name"]) > 0 and len(mine[1]["name"]) == 0
    for fid in batch["frame_id"]:
        rel = f"final_result/data/{fid}.txt"
        assert (tmp_path / "port" / rel).read_text() == \
            (tmp_path / "ref" / rel).read_text()


def _anno(boxes_cam, names, scores=None, height=50):
    """tests/test_evaluators.py's annos."""
    n = len(names)
    anno = {"name": np.asarray(names), "truncated": np.zeros(n),
            "occluded": np.zeros(n), "alpha": np.zeros(n),
            "bbox": np.tile([100.0, 100.0, 200.0, 100.0 + height], (n, 1)),
            "dimensions": boxes_cam[:, 3:6] if n else np.zeros((0, 3)),
            "location": boxes_cam[:, 0:3] if n else np.zeros((0, 3)),
            "rotation_y": boxes_cam[:, 6] if n else np.zeros(0)}
    if scores is not None:
        anno["score"] = np.asarray(scores)
    return anno


def _cam_box(x, z, l=4.0, h=1.5, w=1.8, ry=0.1):
    return [x, 1.0, z, l, h, w, ry]


def _eval_case(name):
    """The cases of tests/test_evaluators.py:32-158 (fewer frames) and a
    seeded random set -> (gt annos, dt annos, classes)."""
    rng = np.random.RandomState(0)
    gts, dts = [], []
    if name in ("perfect", "missed"):
        for f in range(8):
            boxes = np.asarray([_cam_box(f * 0.1, 10),
                                _cam_box(5 + f * 0.1, 20)], np.float32)
            gts.append(_anno(boxes, ["Car", "Car"]))
            keep = 2 if name == "perfect" else 1
            dts.append(_anno(boxes[:keep], ["Car"] * keep,
                             scores=rng.uniform(0.5, 1.0, keep)))
    elif name in ("aos", "aos_flipped", "no_alpha"):
        for f in range(8):
            boxes = np.asarray([_cam_box(f * 0.1, 10)], np.float32)
            g = _anno(boxes, ["Car"])
            d = _anno(boxes, ["Car"], scores=rng.uniform(0.5, 1.0, 1))
            g["alpha"] = np.asarray([0.3])
            d["alpha"] = np.asarray({"aos": [0.3], "aos_flipped":
                                     [0.3 + np.pi], "no_alpha": [-10.0]}[name])
            gts.append(g)
            dts.append(d)
    elif name == "false_positives":
        for _ in range(3):
            gts.append(_anno(np.asarray([_cam_box(0, 10)], np.float32),
                             ["Car"]))
            dts.append(_anno(np.asarray([_cam_box(0, 10), _cam_box(30, 40)],
                                        np.float32), ["Car", "Car"],
                             scores=[0.9, 0.95]))
    elif name == "dontcare":
        gt_boxes = np.asarray([_cam_box(0, 10), _cam_box(0, 10)], np.float32)
        dt_boxes = np.asarray([_cam_box(0, 10), _cam_box(30, 40)], np.float32)
        for _ in range(8):
            g = _anno(gt_boxes, ["Car", "DontCare"])
            g["bbox"] = np.asarray([[100, 100, 200, 150], [300, 300, 400,
                                                           350]], np.float64)
            d = _anno(dt_boxes, ["Car", "Car"],
                      scores=rng.uniform(0.5, 1.0, 2))
            d["bbox"] = g["bbox"].copy()
            gts.append(g)
            dts.append(d)
    else:                                       # seeded random set
        names = np.array(CLASSES + ["Van", "DontCare"])
        for _ in range(4):
            n, m = 6, 9                 # one shape: one set of JAX compiles
            g = _anno(np.concatenate([rng.uniform([-8, 0.5, 5], [8, 2, 40],
                                                  (n, 3)),
                                      rng.uniform([1, 1, 0.5], [5, 2, 2],
                                                  (n, 3)),
                                      rng.uniform(-3, 3, (n, 1))], 1),
                      names[rng.randint(0, 5, n)])
            g["bbox"] = np.sort(rng.uniform(0, 300, (n, 2, 2)), 1) \
                .transpose(0, 2, 1).reshape(n, 4)[:, [0, 2, 1, 3]]
            g["occluded"] = rng.randint(0, 3, n).astype(float)
            g["truncated"] = rng.uniform(0, 0.6, n)
            g["alpha"] = rng.uniform(-3, 3, n)
            # detections: jittered copies of some gts and some strays
            pick = rng.randint(0, n, m)
            d = {k: (v[pick].copy() if isinstance(v, np.ndarray) else v)
                 for k, v in g.items()}
            d["name"] = np.where(rng.rand(m) < 0.8, g["name"][pick],
                                 names[rng.randint(0, 3, m)])
            d["location"] = d["location"] + rng.normal(0, 0.3, (m, 3))
            d["bbox"] = d["bbox"] + rng.normal(0, 3, (m, 4))
            d["score"] = rng.uniform(0.05, 1, m)
            gts.append(g)
            dts.append(d)
        return gts, dts, CLASSES
    return gts, dts, ["Car"]


def _memoized(fn):
    """The reference's overlap function, each (gt, dt) pair computed once:
    it recomputes a frame's overlaps for every class and difficulty, op by
    op in JAX (the values are its own)."""
    memo = {}

    def run(a, b):
        key = (a.tobytes(), a.shape, b.tobytes(), b.shape)
        if key not in memo:
            memo[key] = fn(a, b)
        return memo[key]
    return run


@pytest.mark.parametrize("case", ["perfect", "missed", "aos", "aos_flipped",
                                  "no_alpha", "false_positives", "dontcare",
                                  "random"])
def test_official_eval_equals_reference(case, monkeypatch):
    for name in ("bev_box_overlap", "d3_box_overlap"):
        monkeypatch.setattr(jax_eval, name, _memoized(getattr(jax_eval,
                                                              name)))
    gts, dts, classes = _eval_case(case)
    for metric, fn in ((1, jax_eval.bev_box_overlap),
                       (2, jax_eval.d3_box_overlap)):
        ours = kitti_eval.frame_overlaps(gts, dts, metric, device="cpu")
        for gt, dt, ov in zip(gts, dts, ours):
            theirs = fn(jax_eval._camera_to_lidar_like(gt),
                        jax_eval._camera_to_lidar_like(dt))
            assert ov.shape == theirs.shape
            assert np.abs(ov - theirs).max(initial=0) <= 1e-6
    text, res = kitti_eval.get_official_eval_result(gts, dts, classes,
                                                    device="cpu")
    jtext, jres = jax_eval.get_official_eval_result(gts, dts, classes)
    assert sorted(res) == sorted(jres)
    for k in res:
        assert abs(res[k] - jres[k]) <= 1e-6, (k, res[k], jres[k])
    assert any(v > 0 for v in res.values()) or case == "random"


def test_rotated_iou_of_near_identical_boxes_pinned():
    """Pinned, in both packages: two boxes 1e-7 rad apart in heading (a
    detection that round-trips a label through the lidar frame in f32)
    have BEV and 3D IoU 0, not 1: the clipping drops the near-coincident
    edges from both passes (``ROADMAP.md`` §3); identical boxes give 1."""
    import jax.numpy as jnp
    from q3d_tpu.ops.iou3d_nms import boxes_iou3d as jax_iou3d
    from q3d_tpu.ops.iou3d_nms import boxes_iou_bev as jax_iou_bev
    from q3d_tpu_torch.ops.iou3d_nms import boxes_iou3d, boxes_iou_bev
    a = np.array([[3.8937, 16.7844, -0.66275007, 4.5111, 1.6608, 1.7225,
                   -0.5091]], np.float32)
    b = a.copy()
    b[0, 6] = np.float32(-0.5091001)
    for port_fn, jax_fn in ((boxes_iou_bev, jax_iou_bev),
                            (boxes_iou3d, jax_iou3d)):
        assert float(port_fn(torch.from_numpy(a), torch.from_numpy(b))) == 0
        assert float(jax_fn(jnp.asarray(a), jnp.asarray(b))[0, 0]) == 0
        assert abs(float(port_fn(torch.from_numpy(a),
                                 torch.from_numpy(a))) - 1) < 1e-6
