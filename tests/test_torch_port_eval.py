"""PyTorch port vs the JAX package: evaluation.

* ``load_flax_checkpoint`` (no JAX, no msgpack) reads the trained fixture
  with every leaf bit for bit equal to the reference's ``load_checkpoint``,
  and refuses a pickle that asks for a class;
* ``boxes_iou3d`` within 1e-6 of the reference's (the same formula; XLA
  and PyTorch round a few of its f32 operations differently), and exactly
  equal where the reference's is 0;
* ``statistics_info``, ``nuscenes_eval`` and ``simple_map`` exactly equal to
  the reference's on identical inputs (the trained model's detections);
* ``eval_one_epoch`` in f32 on the CPU over the 16 test frames (batch 2):
  the port's NDS and mAP equal the reference's within 1e-6.
"""

import io
import pickle

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from q3d_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
from q3d_tpu.config import EDict as JaxEDict
from q3d_tpu.datasets import build_dataloader as jax_build_dataloader
from q3d_tpu.datasets.nuscenes import nuscenes_eval as jax_nus
from q3d_tpu.eval_utils import eval_one_epoch as jax_eval_one_epoch
from q3d_tpu.eval_utils import statistics_info as jax_statistics_info
from q3d_tpu.models import build_network as jax_build_network
from q3d_tpu.models import load_data_to_device as jax_load_data_to_device
from q3d_tpu.ops.iou3d_nms import boxes_iou3d as jax_boxes_iou3d
from q3d_tpu.utils import simple_eval as jax_simple_eval
from q3d_tpu.utils.checkpoint import load_checkpoint

from q3d_tpu_torch.config import cfg_from_yaml_file, EDict
from q3d_tpu_torch.datasets import build_dataloader
from q3d_tpu_torch.datasets.nuscenes import nuscenes_eval as port_nus
from q3d_tpu_torch.eval_utils import eval_one_epoch, statistics_info
from q3d_tpu_torch.models import build_network
from q3d_tpu_torch.ops.iou3d_nms import boxes_iou3d
from q3d_tpu_torch.utils import checkpoint as port_ckpt
from q3d_tpu_torch.utils import simple_eval as port_simple_eval
from q3d_tpu_torch.utils.weights import state_dict_from_jax

from test_torch_port_centerpoint import CFG_DIR, CKPT

torch.set_num_threads(2)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


@pytest.fixture(scope="module")
def reference():
    """The reference's model, loader and trained variables, and its f32
    evaluation of the 16 test frames (per-batch detections kept)."""
    cfg = jax_cfg_from_yaml(str(CFG_DIR / "centerpoint_tiny.yaml"), JaxEDict())
    cfg.MODEL.POST_PROCESSING.EVAL_METRIC = "nuscenes"
    ds, loader, _ = jax_build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                         batch_size=2, training=False)
    model = jax_build_network(cfg.MODEL, num_class=len(cfg.CLASS_NAMES),
                              dataset=ds)
    batch = jax_load_data_to_device(next(iter(loader)))
    # the variables' tree only (load_checkpoint takes every leaf's value
    # from the file): traced, not compiled
    template = jax.eval_shape(lambda k, b: model.init(k, b, train=False),
                              jax.random.PRNGKey(0), batch)
    variables, _, _, _ = load_checkpoint(str(CKPT), template)
    annos = []
    real = ds.generate_prediction_dicts

    def keep(raw, host, names, output_path=None):
        annos.append((raw, host))
        return real(raw, host, names, output_path)
    ds.generate_prediction_dicts = keep
    res = jax_eval_one_epoch(model, variables, loader, ds,
                             list(cfg.CLASS_NAMES), cfg)
    ds.generate_prediction_dicts = real
    return {"cfg": cfg, "ds": ds, "variables": variables, "result": res,
            "batches": annos}


def test_load_flax_checkpoint_equals_reference(reference):
    ours, epoch, it = port_ckpt.load_flax_checkpoint(str(CKPT))
    theirs = _flat(flax.core.unfreeze(jax.device_get(reference["variables"])))
    ours = _flat(ours)
    assert set(ours) == set(theirs) and len(ours) == 231
    for key, want in theirs.items():
        want = np.asarray(want)
        got = ours[key]
        assert got.dtype == want.dtype and got.shape == want.shape, key
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8),
                                      err_msg=str(key))
    with open(CKPT, "rb") as f:
        blob = pickle.load(f)
    assert (epoch, it) == (blob["epoch"], blob["it"])
    # the state dict the port loads strictly
    model = build_network(reference["cfg"].MODEL,
                          len(reference["cfg"].CLASS_NAMES), reference["ds"],
                          device="cpu")
    model.load_state_dict(state_dict_from_jax(
        port_ckpt.load_flax_checkpoint(str(CKPT))[0]), strict=True)


def test_load_flax_checkpoint_refuses_classes_and_foreign_ext(tmp_path):
    bad = tmp_path / "bad.pkl"
    bad.write_bytes(pickle.dumps({"model_state": b"", "x": io.BytesIO()}))
    with pytest.raises(pickle.UnpicklingError, match="refused"):
        port_ckpt.load_flax_checkpoint(str(bad))
    state = {"a": {"w": np.arange(6, dtype=np.int16).reshape(2, 3)},
             "s": np.float32(2.5), "n": 3, "f": 0.25, "t": "x" * 40,
             "l": [1, -7, 300, -40000, 2 ** 40]}
    got = port_ckpt.flax_msgpack_restore(
        flax.serialization.msgpack_serialize(state))
    want = flax.serialization.msgpack_restore(
        flax.serialization.msgpack_serialize(state))
    np.testing.assert_array_equal(got["a"]["w"], want["a"]["w"])
    assert got["a"]["w"].dtype == np.int16
    assert got["s"] == want["s"] and got["s"].dtype == np.float32
    assert [got[k] for k in "nftl"] == [want[k] for k in "nftl"]
    with pytest.raises(ValueError, match="complex"):
        port_ckpt.flax_msgpack_restore(
            flax.serialization.msgpack_serialize({"c": 1 + 2j}))


def test_boxes_iou3d_matches_reference():
    rng = np.random.RandomState(4)
    a = np.zeros((64, 7), np.float32)
    a[:, :2] = rng.uniform(-4, 4, (64, 2))
    a[:, 2] = rng.uniform(-1, 1, 64)
    a[:, 3:6] = rng.uniform(0.5, 4, (64, 3))
    a[:, 6] = rng.uniform(-np.pi, np.pi, 64)
    b = a[rng.permutation(64)[:48]] + rng.normal(0, 0.4, (48, 7)).astype(
        np.float32) * [1, 1, 1, 0.2, 0.2, 0.2, 1]
    ref = np.asarray(jax_boxes_iou3d(jnp.asarray(a), jnp.asarray(b)))
    ours = boxes_iou3d(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert ours.shape == ref.shape and (ref > 0.2).sum() > 20
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ours[ref == 0], 0)


def _annos(reference):
    ds = reference["ds"]
    names = list(reference["cfg"].CLASS_NAMES)
    dets = []
    for raw, host in reference["batches"]:
        dets += ds.generate_prediction_dicts(raw, host, names)
    return dets, names


def test_statistics_info_and_evaluators_match_reference(reference):
    """``statistics_info`` on every batch of the reference's evaluation,
    then ``nuscenes_eval`` (through ``SyntheticDataset.evaluation`` and on
    9-column boxes) and ``simple_map``, equal to the reference's."""
    thresh = [0.3, 0.5, 0.7]
    for raw, host in reference["batches"]:
        fresh = {"gt_num": 0, **{f"recall_rcnn_{t}": 0 for t in thresh}}
        assert statistics_info(host, raw["gt_boxes"], thresh, dict(fresh)) \
            == jax_statistics_info(host, raw["gt_boxes"], thresh, dict(fresh))
    ds = reference["ds"]
    port_ds = build_dataloader(reference["cfg"].DATA_CONFIG,
                               reference["cfg"].CLASS_NAMES, batch_size=2,
                               training=False)[0]
    dets, names = _annos(reference)
    ours = port_ds.evaluation(dets, names, eval_metric="nuscenes")
    theirs = ds.evaluation(dets, names, eval_metric="nuscenes")
    assert ours == theirs and theirs[1]["NDS"] > 0.4
    gts = [{"boxes": d["boxes_lidar"][:3] + 0.05, "names": d["name"][:3]}
           for d in dets]
    assert port_simple_eval.simple_map(dets, gts, names) \
        == jax_simple_eval.simple_map(dets, gts, names)
    assert port_ds.evaluation(dets, names) == ds.evaluation(dets, names)
    dets9 = [{"boxes": np.concatenate([d["boxes_lidar"], d["boxes_lidar"][:, :2]
                                       * 0.1], 1), "names": d["name"],
              "scores": d["score"]} for d in dets]
    gts9 = [{"boxes": d["boxes"] + 0.1, "names": d["names"]} for d in dets9]
    assert port_nus.nuscenes_eval(dets9, gts9, names) \
        == jax_nus.nuscenes_eval(dets9, gts9, names)


def test_eval_one_epoch_f32_matches_reference(reference):
    cfg = cfg_from_yaml_file(str(CFG_DIR / "centerpoint_tiny.yaml"), EDict())
    cfg.MODEL.POST_PROCESSING.EVAL_METRIC = "nuscenes"
    ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                     batch_size=2, training=False)
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), ds, device="cpu")
    variables, _, _ = port_ckpt.load_flax_checkpoint(str(CKPT))
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            eval_one_epoch(model, loader, ds, list(cfg.CLASS_NAMES), cfg)
    frames = []
    res = eval_one_epoch(model, loader, ds, list(cfg.CLASS_NAMES), cfg,
                         device="cpu", per_frame=frames)
    want = reference["result"]
    assert len(frames) == 8
    assert want["NDS"] > 0.4 and want["mAP"] > 0.3
    assert abs(res["NDS"] - want["NDS"]) <= 1e-6, (res["NDS"], want["NDS"])
    assert abs(res["mAP"] - want["mAP"]) <= 1e-6, (res["mAP"], want["mAP"])
    for key in ("recall/rcnn_0.3", "recall/rcnn_0.5", "recall/rcnn_0.7"):
        assert abs(res[key] - want[key]) <= 1e-6, key
    assert res["infer_time_ms"] > 0
