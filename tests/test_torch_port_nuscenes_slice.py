"""PyTorch port vs the JAX package: the nuScenes slice through the models
and the CLIs, on a small nuScenes tree written under ``tmp_path`` (3
sweeps a frame, 5 point features: intensity and the sweep's time lag).

* ``eval_one_epoch`` of both packages with ``centerpoint_tiny``'s MODEL
  (its heads as ``cbgs_voxel0075_res3d_centerpoint.yaml``'s six over the
  ten nuScenes classes, with its velocity branch) and
  ``nuscenes_dataset.yaml``'s DATA_CONFIG at the tiny model's range and
  voxelization, seeded weights and BN statistics from the first batch (as
  ``torch_port_anchor_common`` seeds them), f32: the detections slot for
  slot (labels and valid equal, boxes and scores within 1e-4, as
  ``tests/test_torch_port_centerpoint.py`` holds them), the recall, NDS,
  mAP and each class's AP within 1e-6; the mean TP errors (mATE ...),
  means over the matched boxes' own differences, within 1e-5 (the seeded
  model's boxes agree to ~1e-5 m, f32 sums in another order, and mATE
  moved 1.1e-6).  The test-mode point shuffle and the sweep choice
  draw from numpy's global generator in the reference and from the port
  dataset's ``rng``, both seeded alike.  The reference's jitted step
  refuses the batch's ``metadata`` and ``frame_id`` (pinned); it is handed
  the device keys only (patched in the test only).
* ``create_infos nuscenes --gt_database_only`` builds the train split's gt
  database from the tree's infos, and the train CLI takes one step of that
  model (batch 10, a 1,500-voxel train cap) on the train split's 2 frames,
  which CBGS makes 20, with gt sampling from it: 2 steps.
"""

import shutil
from unittest import mock

import jax
import numpy as np
import pytest
import torch
import yaml

import q3d_tpu.eval_utils as jax_eval_utils
from q3d_tpu.datasets.nuscenes.nuscenes_dataset import \
    NuScenesDataset as JaxNuScenesDataset
from q3d_tpu.datasets import build_dataloader as jax_build_dataloader
from q3d_tpu.eval_utils import eval_one_epoch as jax_eval_one_epoch
from q3d_tpu.models import build_network as jax_build_network
from q3d_tpu.models import load_data_to_device as jax_load_data_to_device

import torch_port_anchor_common as common
from q3d_tpu_torch.config import ROOT_DIR
from q3d_tpu_torch.datasets import SimpleLoader
from q3d_tpu_torch.datasets.augmentor import database_sampler
from q3d_tpu_torch.datasets.nuscenes.nuscenes_dataset import NuScenesDataset
from q3d_tpu_torch.eval_utils import eval_one_epoch
from q3d_tpu_torch.models import build_network, load_data_to_device
from q3d_tpu_torch.tools import create_infos
from q3d_tpu_torch.tools import train as train_cli
from q3d_tpu_torch.utils.bn_calibration import calibrate_bns
from q3d_tpu_torch.utils.weights import state_dict_from_jax
from test_torch_port_centerpoint import CFG_DIR
from test_torch_port_eval import padded_iou3d
from test_torch_port_data import _plain
from test_torch_port_kitti_slice import _device_keys
from torch_port_dataset_common import (CFGS, NUSCENES_DATA, NUSCENES_SETS,
                                       NUSCENES_SWEEPS, configs,
                                       write_small_nuscenes)
from torch_port_jax_cache import jax_compile_cache  # noqa: F401

torch.set_num_threads(2)

SEED = 4
HEADS = CFGS / "nuscenes_models" / "cbgs_voxel0075_res3d_centerpoint.yaml"


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("nuscenes_slice") / "v1.0-trainval"
    write_small_nuscenes(root)
    return root


def _tiny_nuscenes_configs(root):
    """centerpoint_tiny's MODEL with the flagship config's classes, heads
    and velocity branch, on nuscenes_dataset.yaml's DATA_CONFIG at the tiny
    range and voxelization -> (port cfg, reference cfg)."""
    heads, _ = configs(HEADS)
    tiny = configs(CFG_DIR / "centerpoint_tiny.yaml")
    data = configs(NUSCENES_DATA, {**NUSCENES_SETS, "DATA_PATH": str(root)})
    for cfg, dc in zip(tiny, data):
        dc.POINT_CLOUD_RANGE = list(cfg.DATA_CONFIG.POINT_CLOUD_RANGE)
        dc.DATA_PROCESSOR = cfg.DATA_CONFIG.DATA_PROCESSOR
        dc.DATA_PROCESSOR[1].SHUFFLE_ENABLED.test = True
        dc.DATA_AUGMENTOR.AUG_CONFIG_LIST[0].DB_INFO_PATH = [
            f"nuscenes_dbinfos_{NUSCENES_SWEEPS}sweeps_withvelo.pkl"]
        cfg.DATA_CONFIG = dc
        cfg.CLASS_NAMES = list(heads.CLASS_NAMES)
        head = cfg.MODEL.DENSE_HEAD
        head.CLASS_NAMES_EACH_HEAD = [list(h) for h in
                                      heads.MODEL.DENSE_HEAD
                                      .CLASS_NAMES_EACH_HEAD]
        head.SEPARATE_HEAD_CFG.HEAD_ORDER = list(
            heads.MODEL.DENSE_HEAD.SEPARATE_HEAD_CFG.HEAD_ORDER)
        head.SEPARATE_HEAD_CFG.HEAD_DICT.vel = {"out_channels": 2,
                                                "num_conv": 2}
        head.LOSS_CONFIG.LOSS_WEIGHTS.code_weights = [1.0] * 10
        cfg.MODEL.POST_PROCESSING.EVAL_METRIC = "nuscenes"
    return tiny


def test_centerpoint_eval_one_epoch_matches_reference(tree, monkeypatch):
    pcfg, jcfg = _tiny_nuscenes_configs(tree)
    names = list(pcfg.CLASS_NAMES)
    np.random.seed(SEED)
    jds, jloader, _ = jax_build_dataloader(jcfg.DATA_CONFIG, names, 2,
                                           training=False)
    assert isinstance(jds, JaxNuScenesDataset) and len(jds) == 2
    jmodel = jax_build_network(jcfg.MODEL, num_class=10, dataset=jds)
    np.random.seed(SEED)
    variables = common._seeded_variables(jax.eval_shape(
        lambda k, b: jmodel.init(k, b, train=False), jax.random.PRNGKey(0),
        jax_load_data_to_device(_device_keys(next(iter(jloader))))))
    ds = NuScenesDataset(pcfg.DATA_CONFIG, names, training=False,
                         rng=np.random.RandomState(SEED))
    model = build_network(pcfg.MODEL, 10, ds, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    first = ds.collate_batch([ds[0], ds[1]])
    assert first["voxels"].shape[-1] == 5 and \
        len(np.unique(first["voxels"][0, :, 0, 4])) == NUSCENES_SWEEPS
    calibrate_bns(model, load_data_to_device(first, device="cpu"))
    common._set_leaves(variables, model.state_dict())

    frames = []
    ds.rng = np.random.RandomState(SEED)
    res = eval_one_epoch(model, SimpleLoader(ds, 2), ds, names, pcfg,
                         device="cpu", per_frame=frames)
    jframes, real = [], jds.generate_prediction_dicts

    def keep(raw, host, class_names, output_path=None):
        jframes.append(host)
        return real(raw, host, class_names, output_path)
    jds.generate_prediction_dicts = keep
    # pinned: the reference's step refuses a nuScenes batch (metadata)
    with pytest.raises(TypeError):
        jax_eval_one_epoch(jmodel, variables, jloader, jds, names, jcfg)
    real_load = jax_eval_utils.load_data_to_device
    monkeypatch.setattr(jax_eval_utils, "load_data_to_device",
                        lambda raw, **kw: real_load(_device_keys(raw), **kw))
    np.random.seed(SEED)
    with padded_iou3d():
        jres = jax_eval_one_epoch(jmodel, variables, jloader, jds, names,
                                  jcfg)
    assert len(frames) == len(jframes) == 1
    out, jout = frames[0], jframes[0]
    valid = jout["final_valid"].astype(bool)
    np.testing.assert_array_equal(out["final_valid"], valid)
    assert valid.sum() > 5
    np.testing.assert_array_equal(out["final_labels"][valid],
                                  jout["final_labels"][valid])
    for key in ("final_boxes", "final_scores"):
        np.testing.assert_allclose(out[key][valid], jout[key][valid],
                                   rtol=1e-4, atol=1e-4)
    keys = sorted(k for k in jres if k != "infer_time_ms")
    assert sorted(k for k in res if k != "infer_time_ms") == keys
    assert "NDS" in keys
    for k in keys:
        tol = 1e-5 if k in ("mATE", "mASE", "mAOE", "mAVE", "mAAE") else 1e-6
        assert abs(res[k] - jres[k]) <= tol, (k, res[k], jres[k])


def test_gt_database_and_train_cli_on_the_nuscenes_tree(tree, tmp_path):
    pcfg, _ = _tiny_nuscenes_configs(tree)
    pcfg.DATA_CONFIG.DATA_PROCESSOR[-1].MAX_NUMBER_OF_VOXELS.train = 1500
    cfg_dir = tmp_path / "cfgs" / "nuscenes_models"
    cfg_dir.mkdir(parents=True)
    data_file = tmp_path / "nuscenes_small.yaml"
    data_file.write_text(yaml.safe_dump(_plain(pcfg.DATA_CONFIG)))
    out = create_infos.main(["nuscenes", "--cfg_file", str(data_file),
                             "--data_path", str(tree.parent),
                             "--gt_database_only"])
    assert out["gt_database"].exists() and not out["infos"]
    cfg_file = cfg_dir / "centerpoint_tiny_nuscenes.yaml"
    cfg_file.write_text(yaml.safe_dump(_plain(pcfg)))
    tag = f"cpu_{tmp_path.name}"
    ckpt = ROOT_DIR / "output" / "cfgs" / "nuscenes_models" / \
        "centerpoint_tiny_nuscenes" / tag
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
                                         "--batch_size", "10",
                                         "--extra_tag", tag,
                                         "--fix_random_seed"])
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    # CBGS made 20 frames of the 2 (each holds all ten classes): 2 steps
    assert len(history) == 2 and all(np.isfinite(h["loss"]) for h in history)
    assert len(sampled) == 20 and sum(sampled) > 0
