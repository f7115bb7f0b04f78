"""PyTorch port vs the JAX package: the KITTI slice through the models and
the CLIs, on a small KITTI tree written under ``tmp_path``.

* ``eval_one_epoch`` of both packages with ``second_iou_tiny``'s SECONDNet
  (as ``tests/test_torch_port_second.py`` builds it, through
  ``torch_port_anchor_common``: seeded weights, BN statistics from the
  first batch, conv_cls's bias 0) and ``kitti_dataset.yaml``'s DATA_CONFIG
  at the tiny model's range and voxel size, on the tree's 2 val frames:
  the detections slot for slot as ``check_detections`` holds them, the
  recall and the official AP dicts within 1e-6.  The reference's
  ``get_lidar`` takes OpenPCDet's FOV crop (patched in the test only; it
  never reads FOV_POINTS_ONLY, ``test_torch_port_kitti.py``).  Its
  ``load_data_to_device`` hands the batch's ``calib`` objects and
  ``frame_id`` strings to the jitted step, which refuses them, so no KITTI
  batch evaluates there (pinned); the test hands its step the device keys
  only (patched in the test only).
* The test CLI on ``kitti_models/second.yaml`` as written (only
  DATA_PATH set), on the CPU, with ``--save_to_file``: one KITTI result
  file a frame, read back equal to ``result.pkl``'s annos to the file's 4
  decimals; the gt boxes as detections, through their result files, find
  every valid gt with no false positive: each AP_R40 at the protocol's
  ceiling (100 from 41 valid gts on; ``ap_ceilings``).  Through the files,
  as the official evaluation reads them, each detection equals its label
  exactly: the unrounded round trip moves a heading by ~1e-7 rad, and the
  rotated IoU of two boxes that close can be 0 (``ROADMAP.md`` §3).
* The train CLI on that config's DATA_CONFIG at the tiny SECOND's width:
  one step on the tree's train split with gt sampling from the
  ``kitti_dbinfos_train.pkl`` that ``create_infos`` wrote.
"""

import shutil
from unittest import mock

import jax
import numpy as np
import pickle
import pytest
import torch
import yaml

import q3d_tpu.datasets.kitti.kitti_dataset as jax_kd
import q3d_tpu.datasets.kitti.kitti_eval as jax_eval
import q3d_tpu.eval_utils as jax_eval_utils
from q3d_tpu.models.builder import _DEVICE_KEYS
from q3d_tpu.datasets import build_dataloader as jax_build_dataloader
from q3d_tpu.eval_utils import eval_one_epoch as jax_eval_one_epoch
from q3d_tpu.models import build_network as jax_build_network
from q3d_tpu.models import load_data_to_device as jax_load_data_to_device

import torch_port_anchor_common as common
from q3d_tpu_torch.config import ROOT_DIR
from q3d_tpu_torch.datasets import build_dataloader
from q3d_tpu_torch.datasets.augmentor import database_sampler
from q3d_tpu_torch.datasets.kitti_synthetic import read_results
from q3d_tpu_torch.eval_utils import eval_one_epoch
from q3d_tpu_torch.models import build_network, load_data_to_device
from q3d_tpu_torch.tools import create_infos
from q3d_tpu_torch.tools import test as test_cli
from q3d_tpu_torch.tools import train as train_cli
from q3d_tpu_torch.utils.bn_calibration import calibrate_bns
from q3d_tpu_torch.utils.weights import state_dict_from_jax
from test_torch_port_data import _plain
from test_torch_port_eval import padded_iou3d
from test_torch_port_kitti import _memoized
from torch_port_dataset_common import (KITTI_DATA, SECOND, configs,
                                       fov_get_lidar, write_small_kitti)
from torch_port_jax_cache import jax_compile_cache  # noqa: F401

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti_slice")
    write_small_kitti(root)
    create_infos.main(["kitti", "--cfg_file", str(KITTI_DATA), "--data_path",
                       str(root), "--with_gt_database"])
    return root


def _tiny_kitti_configs(root):
    """second_iou_tiny as SECONDNet (both packages) on kitti_dataset.yaml's
    DATA_CONFIG at the tiny model's range and voxelization."""
    jcfg, pcfg = common.configs("second_iou_tiny")
    out = []
    for cfg, data in zip((pcfg, jcfg), configs(KITTI_DATA,
                                               {"DATA_PATH": str(root)})):
        data.POINT_CLOUD_RANGE = list(cfg.DATA_CONFIG.POINT_CLOUD_RANGE)
        data.DATA_PROCESSOR = cfg.DATA_CONFIG.DATA_PROCESSOR
        cfg.DATA_CONFIG = data
        cfg.MODEL.POST_PROCESSING.EVAL_METRIC = "kitti"
        out.append(cfg)
    return out


def test_second_eval_one_epoch_matches_reference(tree, monkeypatch):
    monkeypatch.setattr(jax_kd.KittiDataset, "get_lidar",
                        fov_get_lidar(jax_kd.KittiDataset))
    for name in ("bev_box_overlap", "d3_box_overlap"):
        monkeypatch.setattr(jax_eval, name, _memoized(getattr(jax_eval,
                                                              name)))
    pcfg, jcfg = _tiny_kitti_configs(tree)
    names = list(pcfg.CLASS_NAMES)
    jds, jloader, _ = jax_build_dataloader(jcfg.DATA_CONFIG, names, 2,
                                           training=False)
    jmodel = jax_build_network(jcfg.MODEL, num_class=3, dataset=jds)
    raw = next(iter(jloader))
    variables = common._seeded_variables(jax.eval_shape(
        lambda k, b: jmodel.init(k, b, train=False), jax.random.PRNGKey(0),
        jax_load_data_to_device(_device_keys(raw))))
    ds, loader, _ = build_dataloader(pcfg.DATA_CONFIG, names, 2,
                                     training=False)
    model = build_network(pcfg.MODEL, 3, ds, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    calibrate_bns(model, load_data_to_device(next(iter(loader)),
                                             device="cpu"))
    common._set_leaves(variables, model.state_dict())

    frames = []
    res = eval_one_epoch(model, loader, ds, names, pcfg, device="cpu",
                         per_frame=frames)
    jframes, real = [], jds.generate_prediction_dicts

    def keep(raw, host, class_names, output_path=None):
        jframes.append(host)
        return real(raw, host, class_names, output_path)
    jds.generate_prediction_dicts = keep
    # pinned: the reference's step refuses a KITTI batch (its calib objects)
    with pytest.raises(TypeError, match="Calibration"):
        jax_eval_one_epoch(jmodel, variables, jloader, jds, names, jcfg)
    assert not jframes
    real_load = jax_eval_utils.load_data_to_device
    monkeypatch.setattr(jax_eval_utils, "load_data_to_device",
                        lambda raw, **kw: real_load(_device_keys(raw), **kw))
    with padded_iou3d():
        jres = jax_eval_one_epoch(jmodel, variables, jloader, jds, names,
                                  jcfg)
    assert len(frames) == len(jframes) == 1
    common.check_detections(frames[0], jframes[0])
    keys = sorted(k for k in jres if k != "infer_time_ms")
    assert sorted(k for k in res if k != "infer_time_ms") == keys
    assert "Car_3d/moderate_R40" in keys
    for k in keys:
        assert abs(res[k] - jres[k]) <= 1e-6, (k, res[k], jres[k])


def _device_keys(raw):
    """A collated batch without the keys the reference's jitted step
    cannot take (calib objects, frame_id strings)."""
    return {k: v for k, v in raw.items() if k in _DEVICE_KEYS}


def _read_results(path):
    """A KITTI result file -> (names, (N, 15) numbers: alpha, bbox, h w l,
    location, ry, score)."""
    rows = [line.split() for line in path.read_text().splitlines()]
    return [r[0] for r in rows], np.array([[float(v) for v in r[3:]]
                                           for r in rows]).reshape(-1, 13)


def test_test_cli_second_saves_kitti_results(tree, tmp_path):
    tag = f"cpu_{tmp_path.name}"
    out = ROOT_DIR / "output" / "cfgs" / "kitti_models" / "second" / tag
    try:
        torch.manual_seed(0)
        ret = test_cli.main(["--cfg_file", str(SECOND), "--device", "cpu",
                             "--save_to_file", "--extra_tag", tag, "--set",
                             "DATA_CONFIG.DATA_PATH", str(tree)])
        result_dir = out / "eval" / "default"
        with open(result_dir / "result.pkl", "rb") as f:
            annos = pickle.load(f)
        files = sorted((result_dir / "final_result" / "data").iterdir())
        assert [p.stem for p in files] == ["000000", "000001"]
        assert [a["frame_id"] for a in annos] == ["000000", "000001"]
        for path, anno in zip(files, annos):
            names, rows = _read_results(path)
            assert names == list(anno["name"])
            want = np.concatenate([anno["alpha"][:, None], anno["bbox"],
                                   anno["dimensions"][:, [1, 2, 0]],
                                   anno["location"],
                                   anno["rotation_y"][:, None],
                                   anno["score"][:, None]], axis=1)
            assert rows.shape == want.shape
            assert np.abs(rows - want).max(initial=0) <= 5e-5 + 1e-9
        assert "Car_3d/moderate_R40" in ret
    finally:
        shutil.rmtree(out, ignore_errors=True)

    # the gt boxes as detections, through the result files: every valid gt
    # found, no false positive, so each AP_R40 at the protocol's ceiling
    cfg, _ = configs(SECOND, {"DATA_CONFIG.DATA_PATH": str(tree)})
    ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 2,
                                     training=False)
    raw = next(iter(loader))
    ds.generate_prediction_dicts(raw, gt_predictions(raw), cfg.CLASS_NAMES,
                                 output_path=tmp_path)
    dets = read_results(tmp_path / "final_result" / "data", raw["frame_id"])
    _, res = ds.evaluation(dets, cfg.CLASS_NAMES, device="cpu")
    ceilings = ap_ceilings(ds.kitti_infos, dets, cfg.CLASS_NAMES)
    assert sum(n for n, _ in ceilings.values()) > 0
    for key, ap in res.items():
        if "aos" not in key:
            n, want = ceilings[(key.split("_")[0], key.split("/")[1][:-4])]
            assert abs(ap - want) <= 1e-9, (key, ap, n, want)


def gt_predictions(raw):
    """A batch's gt boxes as the forward's final arrays (score 1)."""
    gt = raw["gt_boxes"]
    return {"final_boxes": gt[..., :7], "final_scores": np.ones(gt.shape[:2]),
            "final_labels": gt[..., 7], "final_valid": gt[..., 7] > 0}


def ap_ceilings(infos, dets, class_names):
    """{(class, difficulty): (valid gts n, the AP_R40 ceiling 100 x (min(n,
    41) - 1) / 40)} of the official protocol: its 41 recall points take
    one threshold a matched gt, so perfect detections of fewer than 41
    gts score below 100."""
    from q3d_tpu_torch.datasets.kitti import kitti_eval
    out = {}
    for cls in class_names:
        for d, diff in enumerate(("easy", "moderate", "hard")):
            n = sum(kitti_eval._clean_data(
                info["annos"], dt, kitti_eval.CLASS_NAMES.index(cls), d)[0]
                for info, dt in zip(infos, dets))
            out[(cls, diff)] = (n, 100.0 * (min(n, 41) - 1) / 40 if n else 0.0)
    return out


def test_train_cli_on_the_kitti_tree(tree, tmp_path):
    pcfg, _ = _tiny_kitti_configs(tree)
    pcfg.OPTIMIZATION.BATCH_SIZE_PER_GPU = 2
    cfg_dir = tmp_path / "cfgs" / "kitti_models"
    cfg_dir.mkdir(parents=True)
    cfg_file = cfg_dir / "second_tiny_kitti.yaml"
    cfg_file.write_text(yaml.safe_dump(_plain(pcfg)))
    tag = f"cpu_{tmp_path.name}"
    out = ROOT_DIR / "output" / "cfgs" / "kitti_models" / \
        "second_tiny_kitti" / tag
    sampled = []
    real = database_sampler.DataBaseSampler.__call__

    def counting(self, data_dict=None, **kw):
        before = len(data_dict["gt_boxes"])
        out_dict = real(self, data_dict=data_dict, **kw)
        sampled.append(len(out_dict["gt_boxes"]) - before)
        return out_dict
    try:
        with mock.patch.object(database_sampler.DataBaseSampler, "__call__",
                               counting):
            _, history = train_cli.main(["--cfg_file", str(cfg_file),
                                         "--epochs", "1", "--device", "cpu",
                                         "--extra_tag", tag,
                                         "--fix_random_seed"])
    finally:
        shutil.rmtree(out, ignore_errors=True)
    assert len(history) == 1 and np.isfinite(history[0]["loss"])
    assert len(sampled) == 2 and sum(sampled) > 0
