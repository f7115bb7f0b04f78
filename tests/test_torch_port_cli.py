"""The port's CLIs on the CPU: ``q3d_tpu_torch.tools.quant_driver`` and
``q3d_tpu_torch.tools.test``, on centerpoint_tiny with the trained fixture,
4 test frames (2 batches of 2).

* ``quant_driver --deploy_int8 --no_sq`` evaluates the fp32 model and
  ``int8_deploy_recipe()``; its fp32 metrics equal ``eval_one_epoch`` of
  the float model, and its quantized final scores stay within the JAX
  package's bound for the recipe (``tests/test_quant_model_e2e.py:72``:
  mean |fp - q| < 0.05).
* ``test --quant int8`` runs the same recipe: on a pcdet ``.pth`` of the
  same weights (spconv1 layout) it gives the driver's quantized metrics.
* ``quant_driver --deploy_int8 --static`` (SmoothQuant, histograms, method
  "max", 2 calibration batches) runs and stays within the same bound.
* ``quant_pointpillar`` (the PointPillars entry) runs the driver on
  pointpillar_tiny up to ``quantize_model`` under ``pointpillar_recipe``.
* ``--eval_all`` raises (the TransFusion recipe, which raised here until
  its model was ported, runs in ``test_torch_port_transfusion_quant.py``).
"""

import numpy as np
import pytest
import torch

from q3d_tpu_torch.config import cfg_from_list, cfg_from_yaml_file, EDict
from q3d_tpu_torch.datasets import build_dataloader
from q3d_tpu_torch.eval_utils import eval_one_epoch
from q3d_tpu_torch.models import build_network
from q3d_tpu_torch.tools import quant_driver, test as test_cli
from q3d_tpu_torch.utils.checkpoint import load_params_from_file

from test_torch_port_centerpoint import CFG_DIR, CKPT
from torch_port_jax_cache import jax_compile_cache  # noqa: F401

torch.set_num_threads(2)
CFG = str(CFG_DIR / "centerpoint_tiny.yaml")
SMALL = ["--device", "cpu", "--set", "DATA_CONFIG.NUM_FRAMES", "4"]
SCORE_BOUND = 0.05


def _no_time(ret):
    return {k: v for k, v in ret.items() if k != "infer_time_ms"}


def _mean_score_diff(frames):
    return float(np.mean([np.abs(a["final_scores"] - b["final_scores"]).mean()
                          for a, b in zip(frames["fp"], frames["quant"])]))


@pytest.fixture(scope="module")
def driver_int8():
    frames = {}
    fp, q = quant_driver.run(argv=["--cfg_file", CFG, "--ckpt", str(CKPT),
                                   "--deploy_int8", "--no_sq"] + SMALL,
                             frames=frames)
    return fp, q, frames


def test_quant_driver_deploy_int8(driver_int8):
    fp, q, frames = driver_int8
    cfg = cfg_from_yaml_file(CFG, EDict())
    cfg_from_list(["DATA_CONFIG.NUM_FRAMES", "4"], cfg)
    ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                     batch_size=2, training=False)
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), ds, device="cpu")
    load_params_from_file(model, str(CKPT))
    want = eval_one_epoch(model, loader, ds, list(cfg.CLASS_NAMES), cfg,
                          device="cpu")
    assert _no_time(fp) == _no_time(want)
    assert len(frames["fp"]) == len(frames["quant"]) == 2
    assert set(q) == set(fp) and q["recall/rcnn_0.3"] > 0.5
    assert _mean_score_diff(frames) < SCORE_BOUND


def test_test_cli_int8_on_pth(driver_int8, tmp_path):
    cfg = cfg_from_yaml_file(CFG, EDict())
    ds, _, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                batch_size=2, training=False)
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), ds, device="cpu")
    load_params_from_file(model, str(CKPT))
    # pcdet names; the sparse weights in spconv1's (kd, kh, kw, I, O)
    state = {k: v.reshape(3, 3, 3, *v.shape[1:]) if k.endswith("weight")
             and v.dim() == 3 and v.shape[0] == 27 else v
             for k, v in model.state_dict().items()}
    state["backbone_3d.conv_out.0.weight"] = model.state_dict()[
        "backbone_3d.conv_out.0.weight"].reshape(3, 1, 1, 128, 128)
    path = tmp_path / "tiny.pth"
    torch.save({"model_state": state, "epoch": 0}, str(path))
    ret = test_cli.main(["--cfg_file", CFG, "--ckpt", str(path),
                         "--quant", "int8"] + SMALL)
    assert _no_time(ret) == _no_time(driver_int8[1])


def test_quant_driver_static_smoothquant():
    frames = {}
    fp, q = quant_driver.run(argv=[
        "--cfg_file", CFG, "--ckpt", str(CKPT), "--deploy_int8", "--static",
        "--amax_method", "max", "--calib_batches", "2"] + SMALL, frames=frames)
    assert set(q) == set(fp) and q["recall/rcnn_0.3"] > 0.5
    assert _mean_score_diff(frames) < SCORE_BOUND


def test_quant_pointpillar_entry(monkeypatch):
    """``python -m q3d_tpu_torch.tools.quant_pointpillar`` runs the
    driver's ``run("pointpillar")``: it builds pointpillar_tiny and
    quantizes it under ``pointpillar_recipe`` with the reference's
    arguments (dynamic SmoothQuant; the VFE and the head's output convs
    float).  The run stops at ``quantize_model``: the driver's evaluations
    run on centerpoint_tiny above, and the recipe's layers and detections
    are held against the JAX package in ``test_torch_port_pointpillar.py``."""
    import runpy
    import sys
    from q3d_tpu_torch.quant import api as port_api

    class Quantized(Exception):
        pass
    recipes, models = [], []
    recipe = port_api.pointpillar_recipe

    def stop(model, rules, example):
        models.append(type(model).__name__)
        raise Quantized
    monkeypatch.setattr(port_api, "pointpillar_recipe",
                        lambda **kw: recipes.append(kw) or recipe(**kw))
    monkeypatch.setattr(port_api, "quantize_model", stop)
    monkeypatch.setattr(sys, "argv", [
        "quant_pointpillar", "--cfg_file",
        str(CFG_DIR / "pointpillar_tiny.yaml"), "--device", "cpu",
        "--skip_fp_baseline", "--set", "DATA_CONFIG.NUM_FRAMES", "2"])
    with pytest.raises(Quantized):
        runpy.run_module("q3d_tpu_torch.tools.quant_pointpillar",
                         run_name="__main__")
    assert recipes == [dict(w_bits=8, act_bits=8, sq=True, alpha=0.5,
                            static=False)]
    assert models == ["PointPillar"]


def test_unported_paths_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        test_cli.main(["--cfg_file", CFG, "--eval_all"] + SMALL)
