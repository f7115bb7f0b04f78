"""PyTorch port vs the JAX package: the data augmentor.

The reference draws from numpy's global state; the port from the
``RandomState`` it is given.  Each comparison seeds ``np.random`` for the
reference and hands the port ``RandomState(seed)``, so both draw the same
stream, and the outputs must be equal (the same numpy arithmetic).

* every ``augmentor_utils`` function, with its draw pinned (``force=``,
  ``angle=``, ``scale=``) and with a shared seed, on boxes with velocity
  columns;
* the ``DataAugmentor`` queue (``DISABLE_AUG_LIST``, every world, local,
  frustum and pyramid step) and the late-epoch hook that rebuilds it;
* ``DataBaseSampler`` on a database that ``kitti_synthetic.
  write_gt_database`` writes to ``tmp_path`` (per-object files, and the
  integrated ``.npy`` with its offset check): the same sampled boxes,
  names and points; a missing database samples nothing;
* the training dataset of ``pointpillar_tiny.yaml`` with the KITTI
  dataset yaml's DATA_AUGMENTOR: the same voxels and gt boxes per frame;
* the port's train CLI on ``pointpillar_tiny.yaml`` for one epoch, then
  asked again, resuming with no step left (as ``centerpoint_tiny.yaml``
  in ``test_torch_port_train_step.py``).
"""

import logging
import pickle
import shutil

import numpy as np
import pytest
import torch

from q3d_tpu.config import EDict as JaxEDict
from q3d_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
from q3d_tpu.datasets import build_dataloader as jax_build_dataloader
from q3d_tpu.datasets.augmentor import augmentor_utils as jax_aug
from q3d_tpu.datasets.augmentor.data_augmentor import \
    DataAugmentor as JaxDataAugmentor
from q3d_tpu.datasets.augmentor.database_sampler import \
    DataBaseSampler as JaxDataBaseSampler
from q3d_tpu.train_utils import \
    _disable_augmentation_hook as jax_disable_hook

from q3d_tpu_torch import train_utils
from q3d_tpu_torch.config import EDict, cfg_from_yaml_file
from q3d_tpu_torch.datasets import build_dataloader
from q3d_tpu_torch.datasets.augmentor import augmentor_utils as aug
from q3d_tpu_torch.datasets.augmentor.data_augmentor import DataAugmentor
from q3d_tpu_torch.datasets.augmentor.database_sampler import \
    DataBaseSampler
from q3d_tpu_torch.datasets.kitti_synthetic import (kitti_config,
                                                    kitti_scene,
                                                    write_gt_database)

from test_torch_port_centerpoint import CFG_DIR, ROOT
from torch_port_jax_cache import jax_compile_cache  # noqa: F401

torch.set_num_threads(2)

KITTI_DATASET = ROOT / "tools" / "cfgs" / "dataset_configs" / \
    "kitti_dataset.yaml"


def _scene(seed=0, n_boxes=4, vel=True):
    """Boxes (with vx, vy columns) and points in and around them."""
    rng = np.random.RandomState(seed)
    boxes = np.zeros((n_boxes, 9 if vel else 7), np.float32)
    boxes[:, 0] = rng.uniform(5, 30, n_boxes)
    boxes[:, 1] = rng.uniform(-10, 10, n_boxes)
    boxes[:, 2] = rng.uniform(-1, 0, n_boxes)
    boxes[:, 3:6] = rng.uniform([2.0, 1.0, 1.2], [4.5, 2.0, 1.8],
                                (n_boxes, 3))
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, n_boxes)
    if vel:
        boxes[:, 7:9] = rng.normal(0, 2, (n_boxes, 2))
    pts = [rng.uniform([0, -15, -2, 0], [35, 15, 1, 1], (300, 4))]
    for b in boxes:
        local = rng.uniform(-0.45, 0.45, (80, 3)) * b[3:6]
        c, s = np.cos(b[6]), np.sin(b[6])
        p = np.zeros((80, 4))
        p[:, 0] = local[:, 0] * c - local[:, 1] * s + b[0]
        p[:, 1] = local[:, 0] * s + local[:, 1] * c + b[1]
        p[:, 2] = local[:, 2] + b[2]
        p[:, 3] = rng.uniform(0, 1, 80)
        pts.append(p)
    return boxes, np.concatenate(pts).astype(np.float32)


# name -> (the reference's call, the port's call); each takes (boxes,
# points) and, for the port, the RandomState
FUNCTIONS = {
    "flip_x_forced": (lambda b, p: jax_aug.random_flip_along_x(
        b, p, force=True), lambda b, p, r: aug.random_flip_along_x(
        b, p, r, force=True)),
    "flip_x": (jax_aug.random_flip_along_x, aug.random_flip_along_x),
    "flip_y_forced": (lambda b, p: jax_aug.random_flip_along_y(
        b, p, force=True), lambda b, p, r: aug.random_flip_along_y(
        b, p, r, force=True)),
    "flip_y": (jax_aug.random_flip_along_y, aug.random_flip_along_y),
    "rotation_pinned": (lambda b, p: jax_aug.global_rotation(
        b, p, [-0.8, 0.8], angle=0.3), lambda b, p, r: aug.global_rotation(
        b, p, [-0.8, 0.8], r, angle=0.3)),
    "rotation": (lambda b, p: jax_aug.global_rotation(b, p, [-0.8, 0.8]),
                 lambda b, p, r: aug.global_rotation(b, p, [-0.8, 0.8], r)),
    "scaling_pinned": (lambda b, p: jax_aug.global_scaling(
        b, p, [0.95, 1.05], scale=1.03), lambda b, p, r: aug.global_scaling(
        b, p, [0.95, 1.05], r, scale=1.03)),
    "scaling": (lambda b, p: jax_aug.global_scaling(b, p, [0.95, 1.05]),
                lambda b, p, r: aug.global_scaling(b, p, [0.95, 1.05], r)),
    "translation": (lambda b, p: jax_aug.global_translation(
        b, p, [0.2, 0.3, 0.1]), lambda b, p, r: aug.global_translation(
        b, p, [0.2, 0.3, 0.1], r)),
    **{f"local_translation_{a}": (
        lambda b, p, a=a: getattr(
            jax_aug, f"random_local_translation_along_{a}")(b, p, [-1, 1]),
        lambda b, p, r, a=a: getattr(
            aug, f"random_local_translation_along_{a}")(b, p, [-1, 1], r))
       for a in "xyz"},
    "local_scaling": (lambda b, p: jax_aug.local_scaling(b, p, [0.9, 1.1]),
                      lambda b, p, r: aug.local_scaling(b, p, [0.9, 1.1], r)),
    "local_rotation": (lambda b, p: jax_aug.local_rotation(b, p, [-0.5, 0.5]),
                       lambda b, p, r: aug.local_rotation(b, p, [-0.5, 0.5],
                                                          r)),
    **{f"{kind}_frustum_dropout_{d}": (
        lambda b, p, f=f"{kind}_frustum_dropout_{d}": getattr(jax_aug, f)(
            b, p, [0.1, 0.4]),
        lambda b, p, r, f=f"{kind}_frustum_dropout_{d}": getattr(aug, f)(
            b, p, [0.1, 0.4], r))
       for kind in ("global", "local")
       for d in ("top", "bottom", "left", "right")},
    "pyramid_dropout": (
        lambda b, p: jax_aug.local_pyramid_dropout(b, p, 0.6),
        lambda b, p, r: aug.local_pyramid_dropout(b, p, 0.6, r)),
    "pyramid_sparsify": (
        lambda b, p: jax_aug.local_pyramid_sparsify(b, p, 0.8, 5),
        lambda b, p, r: aug.local_pyramid_sparsify(b, p, 0.8, 5, r)),
    "pyramid_swap": (
        lambda b, p: jax_aug.local_pyramid_swap(b, p, 1.0, 3),
        lambda b, p, r: aug.local_pyramid_swap(b, p, 1.0, 3, r)),
}


def _assert_equal(mine, ref, name):
    assert type(mine) is type(ref) or np.ndim(ref) == 0, name
    if isinstance(ref, tuple):
        assert len(mine) == len(ref), name
        for a, b in zip(mine, ref):
            _assert_equal(a, b, name)
    else:
        np.testing.assert_array_equal(np.asarray(mine), np.asarray(ref),
                                      err_msg=name)


def test_augmentor_functions_match_reference():
    """Each function on the same boxes and points, the reference after
    ``np.random.seed(s)`` and the port with ``RandomState(s)``, for three
    seeds: every output equal; each changes the points.  (One test for all
    the functions: a file with more tests is handed to an xdist worker
    before the tier-1 critical path.)"""
    for name, (ref_fn, port_fn) in sorted(FUNCTIONS.items()):
        changed = False
        for seed in (0, 1, 2):
            boxes, points = _scene(seed)
            np.random.seed(seed)
            ref = ref_fn(boxes.copy(), points.copy())
            mine = port_fn(boxes.copy(), points.copy(),
                           np.random.RandomState(seed))
            _assert_equal(mine, ref, name)
            changed |= not np.array_equal(mine[1], points)
        assert changed, name


def _queue_cfg(edict):
    return edict({
        "DISABLE_AUG_LIST": ["random_world_translation"],
        "AUG_CONFIG_LIST": [
            {"NAME": "random_world_flip", "ALONG_AXIS_LIST": ["x", "y"]},
            {"NAME": "random_world_rotation",
             "WORLD_ROT_ANGLE": [-0.78539816, 0.78539816]},
            {"NAME": "random_world_scaling", "WORLD_SCALE_RANGE": [0.95, 1.05]},
            {"NAME": "random_world_translation",
             "NOISE_TRANSLATE_STD": [0.5, 0.5, 0.5]},
            {"NAME": "random_local_translation",
             "LOCAL_TRANSLATION_RANGE": [-0.2, 0.2],
             "ALONG_AXIS_LIST": ["x", "y"]},
            {"NAME": "random_local_rotation", "LOCAL_ROT_ANGLE": 0.15},
            {"NAME": "random_local_scaling",
             "LOCAL_SCALE_RANGE": [0.95, 1.05]},
            {"NAME": "random_world_frustum_dropout",
             "INTENSITY_RANGE": [0.05, 0.1], "DIRECTION": ["top", "left"]},
            {"NAME": "random_local_frustum_dropout",
             "INTENSITY_RANGE": [0.0, 0.1], "DIRECTION": ["bottom"]},
            {"NAME": "random_local_pyramid_aug", "DROP_PROB": 0.3,
             "SPARSIFY_PROB": 0.3, "SPARSIFY_MAX_NUM": 10,
             "SWAP_PROB": 0.3, "SWAP_MAX_NUM": 10},
        ]})


def test_data_augmentor_queue_and_hook_match_reference():
    """The whole queue on three frames (names with a class outside the
    filter, ``gt_boxes_mask`` applied, headings wrapped): equal boxes,
    names, points and draws; DISABLE_AUG_LIST leaves its step out; then the
    late-epoch hook (NUM_LAST_EPOCHS 2 of 5, its DISABLE_AUG_LIST
    ``random_world_flip``) rebuilds both queues at epoch 3 and not at
    epoch 2, after which the queues again give equal frames."""
    ref = JaxDataAugmentor(None, _queue_cfg(JaxEDict), ["Car", "Cyclist"])
    rng = np.random.RandomState(0)
    mine = DataAugmentor(None, _queue_cfg(EDict), ["Car", "Cyclist"], rng=rng)
    assert len(mine.data_augmentor_queue) == len(ref.data_augmentor_queue) \
        == 9

    def run(seed):
        boxes, points = _scene(seed, n_boxes=5, vel=False)
        names = np.array(["Car", "Pedestrian", "Cyclist", "Car", "Car"])
        frame = {"gt_boxes": boxes, "points": points, "gt_names": names,
                 "gt_boxes_mask": names != "Pedestrian"}
        np.random.seed(seed)
        rng.seed(seed)
        want = ref.forward({k: v.copy() for k, v in frame.items()})
        got = mine.forward({k: v.copy() for k, v in frame.items()})
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), err_msg=k)
        assert len(got["gt_boxes"]) == 4
        return got
    for seed in (3, 4, 5):
        got = run(seed)
        assert np.abs(got["gt_boxes"][:, 6]).max() <= np.pi
    hook = {"HOOK": {"DisableAugmentationHook": {
        "NUM_LAST_EPOCHS": 2, "DISABLE_AUG_LIST": ["random_world_flip"]}}}
    for epoch, steps in ((2, 9), (3, 9)):
        jax_disable_hook(type("D", (), {"data_augmentor": ref})(),
                         JaxEDict(hook), epoch, 5)
        train_utils._disable_augmentation_hook(
            type("D", (), {"data_augmentor": mine})(), EDict(hook), epoch, 5)
        assert len(mine.data_augmentor_queue) == \
            len(ref.data_augmentor_queue) == steps
    names = [f.func.__name__ for f in mine.data_augmentor_queue]
    assert "random_world_flip" not in names \
        and "random_world_translation" in names
    run(6)


def _sampler_cfg(edict, **extra):
    cfg = jax_cfg_from_yaml(str(KITTI_DATASET), JaxEDict()) \
        .DATA_AUGMENTOR.AUG_CONFIG_LIST[0]
    return edict({**cfg, **extra})


def test_database_sampler_matches_reference(tmp_path, caplog):
    """A database of the labelled objects of two KITTI-geometry synthetic
    frames (seed 5) in the reference's format, pasted into another frame
    (seed 0) by both packages' samplers with the KITTI yaml's gt_sampling
    config (min-points and difficulty filters, 15 per class, collision
    removal) for three seeds in turn: equal boxes, names, points and
    ``gt_boxes_mask``, objects placed.  Then the integrated ``.npy`` form
    (``DB_DATA_PATH`` and ``global_data_offset``): equal again; its offset
    check raises on both sides on a truncated file; a missing database
    logs a warning and samples nothing."""
    names = ["Car", "Pedestrian", "Cyclist"]
    written = write_gt_database(build_dataloader(
        kitti_config("pointpillar", 2, 5).DATA_CONFIG, names, 1,
        training=False)[0], tmp_path)
    assert set(written) == set(names) and sum(written.values()) >= 20
    cfg = kitti_config("pointpillar", 1, 0)
    ds, _, _ = build_dataloader(cfg.DATA_CONFIG, names, 1, training=False)
    points, boxes, gt_names, _ = kitti_scene(ds, 0)
    frame = {"points": points, "gt_boxes": boxes, "gt_names": gt_names,
             "gt_boxes_mask": np.ones(len(boxes), bool)}

    def compare(jcfg, pcfg, rounds=3):
        ref = JaxDataBaseSampler(tmp_path, jcfg, names)
        rng = np.random.RandomState(1)
        mine = DataBaseSampler(tmp_path, pcfg, names, rng=rng)
        np.random.seed(1)
        for _ in range(rounds):
            want = ref({k: v.copy() for k, v in frame.items()})
            got = mine({k: v.copy() for k, v in frame.items()})
            for k in frame:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert len(got["gt_boxes"]) > len(boxes) + 5
        return mine

    compare(_sampler_cfg(JaxEDict), _sampler_cfg(EDict))

    # the integrated database: every object's rows in one .npy
    with open(tmp_path / "kitti_dbinfos_train.pkl", "rb") as f:
        infos = pickle.load(f)
    rows, start = [], 0
    for cls_infos in infos.values():
        for info in cls_infos:
            pts = np.fromfile(tmp_path / info["path"], np.float32) \
                .reshape(-1, 4)
            info["global_data_offset"] = (start, start + len(pts))
            start += len(pts)
            rows.append(pts)
    np.save(tmp_path / "global.npy", np.concatenate(rows))
    with open(tmp_path / "global_infos.pkl", "wb") as f:
        pickle.dump(infos, f)
    extra = {"DB_INFO_PATH": ["global_infos.pkl"],
             "DB_DATA_PATH": ["global.npy"]}
    compare(_sampler_cfg(JaxEDict, **extra), _sampler_cfg(EDict, **extra),
            rounds=1)
    np.save(tmp_path / "global.npy", np.concatenate(rows)[:-1])
    for sampler_cls, edict in ((JaxDataBaseSampler, JaxEDict),
                               (DataBaseSampler, EDict)):
        with pytest.raises(RuntimeError, match="out of sync"):
            sampler_cls(tmp_path, _sampler_cfg(edict, **extra), names)(
                {k: v.copy() for k, v in frame.items()})

    logger = logging.getLogger("test_database_sampler")
    with caplog.at_level(logging.WARNING, logger=logger.name):
        empty = DataBaseSampler(tmp_path, _sampler_cfg(
            EDict, DB_INFO_PATH=["missing.pkl"]), names, logger=logger)
    assert "not found" in caplog.text
    out = empty({k: v.copy() for k, v in frame.items()})
    np.testing.assert_array_equal(out["gt_boxes"], boxes)


def test_training_dataset_matches_reference(tmp_path):
    """pointpillar_tiny's training dataset with the KITTI dataset yaml's
    DATA_AUGMENTOR (gt_sampling from a database written to ``tmp_path``,
    the x flip, the rotation, the scaling) on both sides, the global numpy
    state seeded alike before each frame (the augmentor's and the point
    shuffle's draws): equal voxels, coordinates, point counts and gt boxes
    for 3 frames; the sampler placed objects.  Without training the
    augmentor is not built."""
    names = ["Car", "Pedestrian", "Cyclist"]
    write_gt_database(build_dataloader(
        kitti_config("pointpillar", 2, 5).DATA_CONFIG, names, 1,
        training=False)[0], tmp_path)
    path = CFG_DIR / "pointpillar_tiny.yaml"
    jcfg = jax_cfg_from_yaml(str(path), JaxEDict())
    cfg = cfg_from_yaml_file(str(path), EDict())
    for c, edict, reader in ((jcfg, JaxEDict, jax_cfg_from_yaml),
                             (cfg, EDict, cfg_from_yaml_file)):
        c.DATA_CONFIG.DATA_AUGMENTOR = reader(
            str(KITTI_DATASET), edict()).DATA_AUGMENTOR
    jds = jax_build_dataloader(jcfg.DATA_CONFIG, jcfg.CLASS_NAMES, 1,
                               root_path=tmp_path, training=True)[0]
    ds = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 1,
                          root_path=tmp_path, training=True)[0]
    assert ds.data_augmentor is not None and build_dataloader(
        cfg.DATA_CONFIG, cfg.CLASS_NAMES, 1, root_path=tmp_path,
        training=False)[0].data_augmentor is None
    placed = 0
    for j in range(3):
        np.random.seed(10 + j)
        want = jds[j]
        np.random.seed(10 + j)
        got = ds[j]
        for k in ("voxels", "voxel_coords", "voxel_num_points", "gt_boxes"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        placed += len(got["gt_boxes"]) - len(ds.scene(j)[1])
    assert placed > 0


def test_train_cli_pointpillar_one_epoch_then_resume(tmp_path):
    """``python -m q3d_tpu_torch.tools.train`` on pointpillar_tiny.yaml on
    the CPU, 4 frames at batch 2: one epoch writes checkpoint_epoch_1.pth
    (pcdet's names); asked for the same epoch again, the run resumes from
    it and has no step left to take."""
    from q3d_tpu_torch.tools import train as train_cli
    from q3d_tpu_torch.utils.checkpoint import load_pth_file
    tag = f"test_{tmp_path.name}"
    run_dir = ROOT / "output" / "cfgs" / "synthetic_models" / \
        "pointpillar_tiny" / tag
    args = ["--cfg_file", str(CFG_DIR / "pointpillar_tiny.yaml"),
            "--extra_tag", tag, "--device", "cpu", "--fix_random_seed",
            "--epochs", "1", "--set", "DATA_CONFIG.NUM_FRAMES", "4"]
    try:
        ckpt_dir, hist = train_cli.main(args)
        assert ckpt_dir == run_dir / "ckpt"
        assert [h["it"] for h in hist] == [1, 2]
        assert all(np.isfinite(h["loss"]) for h in hist)
        first = ckpt_dir / "checkpoint_epoch_1.pth"
        assert sorted(p.name for p in ckpt_dir.iterdir()) == [first.name]
        state = load_pth_file(first)
        assert "vfe.pfn_layers.0.linear.weight" in state \
            and "dense_head.conv_cls.weight" in state
        _, hist2 = train_cli.main(args)
        assert hist2 == []
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
        for d in run_dir.parents:              # the empty directories above
            if d == ROOT / "output" or not d.is_dir() or any(d.iterdir()):
                break
            d.rmdir()
