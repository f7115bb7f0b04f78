"""The four accuracy gates of ``tests/test_accuracy_regression.py``, run on
the PyTorch port alone, on the CPU (``device="cpu"``: the plain versions of
the kernels).

The trained centerpoint_tiny fixture is read by the port's own
``load_flax_checkpoint`` (no JAX), and each quantization mode runs the full
detection pipeline through ``eval_one_epoch`` (16 test frames, batch 2,
f32) and the nuScenes-protocol evaluator, with the reference test's
recipes and calibrations:

* fp32 detects: NDS > 0.4 and mAP > 0.3;
* int8 deploy (``int8_deploy_recipe(quantize_first_conv=True)``, full and
  with the head kept float), calibrated on the first batch given twice,
  method "max": relative NDS drop <= 1%;
* dynamic SmoothQuant (``centerpoint_recipe(sq=True, alpha=0.5)``): <= 2%;
* static entropy (``centerpoint_recipe(sq=False, static=True)``, three
  calibration batches, method "entropy"): <= 3%.
"""

import pytest
import torch

from q3d_tpu_torch.config import cfg_from_yaml_file, EDict
from q3d_tpu_torch.datasets import build_dataloader
from q3d_tpu_torch.eval_utils import eval_one_epoch
from q3d_tpu_torch.models import build_network, load_data_to_device
from q3d_tpu_torch.quant import api
from q3d_tpu_torch.utils.checkpoint import load_flax_checkpoint
from q3d_tpu_torch.utils.weights import state_dict_from_jax

from test_torch_port_centerpoint import CFG_DIR, CKPT

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def trained():
    cfg = cfg_from_yaml_file(str(CFG_DIR / "centerpoint_tiny.yaml"), EDict())
    cfg.MODEL.POST_PROCESSING.EVAL_METRIC = "nuscenes"
    ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                     batch_size=2, training=False)
    state = state_dict_from_jax(load_flax_checkpoint(str(CKPT))[0])

    def model():
        m = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), ds, device="cpu")
        m.load_state_dict(state, strict=True)
        return m

    def evaluate(m):
        return eval_one_epoch(m, loader, ds, list(cfg.CLASS_NAMES), cfg,
                              device="cpu")
    batch = load_data_to_device(next(iter(loader)), device="cpu")
    return model, evaluate, batch, evaluate(model())


def _drop(fp, q):
    """The relative NDS drop (printed with the metrics: ``pytest -s``)."""
    drop = (fp["NDS"] - q["NDS"]) / max(fp["NDS"], 1e-9)
    print(f"NDS {q['NDS']!r} mAP {q['mAP']!r} drop {drop!r}")
    return drop


def test_fp32_model_actually_detects(trained):
    *_, fp = trained
    print(f"NDS {fp['NDS']!r} mAP {fp['mAP']!r}")
    assert fp["NDS"] > 0.4, fp
    assert fp["mAP"] > 0.3, fp


@pytest.mark.parametrize("head_bf16", [False, True], ids=["full", "head_bf16"])
def test_int8_deploy_nds_drop_within_1pct(trained, head_bf16):
    model, evaluate, batch, fp = trained
    m = model()
    api.prepare_int8_deploy(m, [batch, batch], recipe_kwargs=dict(
        quantize_first_conv=True,
        extra_no_list=("dense_head.*",) if head_bf16 else ()))
    q = evaluate(m)
    assert _drop(fp, q) <= 0.01, (fp["NDS"], q["NDS"])


def test_dynamic_sq_nds_drop_small(trained):
    model, evaluate, batch, fp = trained
    m = api.quantize_model(model(), api.centerpoint_recipe(
        sq=True, alpha=0.5, static=False), batch)
    q = evaluate(m)
    assert _drop(fp, q) <= 0.02, (fp["NDS"], q["NDS"])


def test_static_entropy_nds_drop_small(trained):
    model, evaluate, batch, fp = trained
    m = api.quantize_model(model(), api.centerpoint_recipe(
        sq=False, static=True), batch)
    api.collect_stats(m, [batch] * 3, num_batches=3)
    api.compute_amax(m, method="entropy")
    q = evaluate(m)
    assert _drop(fp, q) <= 0.03, (fp["NDS"], q["NDS"])
