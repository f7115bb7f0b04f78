"""PyTorch port vs the JAX package: the whole CenterPoint slice.

The trained tiny CenterPoint fixture is loaded on the JAX side, carried
across with ``state_dict_from_jax`` and run through both packages on the
same batch (centerpoint_tiny, test split, batch 2, f32).  The BEV maps agree
within 1e-4 (absolute and relative: the same f32 arithmetic in another
summation order); the detections' validity and labels are equal and their
boxes and scores agree within 1e-4 where valid.

Also pinned here: the weight carry-over equals the reference's pcdet
export.  In ``test_torch_port_centerpoint_entry.py`` (so that each file
keeps at most 5 tests and ``--dist loadfile`` dispatches
``test_accuracy_regression.py`` early): the ref-width state dict loads
strictly, the package never imports JAX or the JAX package, and the entry
points refuse to run without CUDA unless the caller asks for the CPU.
"""

from pathlib import Path

import flax
import jax
import numpy as np
import pytest
import torch

from q3d_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
from q3d_tpu.config import EDict as JaxEDict
from q3d_tpu.datasets import build_dataloader as jax_build_dataloader
from q3d_tpu.models import build_network as jax_build_network
from q3d_tpu.models import load_data_to_device as jax_load_data_to_device
from q3d_tpu.utils.checkpoint import load_checkpoint
from q3d_tpu.utils.pcdet_names import export_torch_state_dict

from q3d_tpu_torch.config import cfg_from_yaml_file, EDict
from q3d_tpu_torch.datasets import build_dataloader
from q3d_tpu_torch.models import build_network, load_data_to_device
from q3d_tpu_torch.utils.weights import state_dict_from_jax
from torch_port_jax_cache import jax_compile_cache  # noqa: F401

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
CFG_DIR = ROOT / "tools" / "cfgs" / "synthetic_models"
CKPT = ROOT / "tests" / "fixtures" / "centerpoint_tiny_trained.pkl"


def _jax_model(name, batch_size=2):
    cfg = jax_cfg_from_yaml(str(CFG_DIR / f"{name}.yaml"), JaxEDict())
    ds, loader, _ = jax_build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                         batch_size=batch_size,
                                         training=False)
    model = jax_build_network(cfg.MODEL, num_class=len(cfg.CLASS_NAMES),
                              dataset=ds)
    return cfg, ds, loader, model


def _port_model(name):
    cfg = cfg_from_yaml_file(str(CFG_DIR / f"{name}.yaml"), EDict())
    ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                     batch_size=2, training=False)
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), ds, device="cpu")
    return cfg, ds, loader, model


@pytest.fixture(scope="module")
def tiny():
    """(JAX variables as numpy, JAX outputs, port model, port outputs)."""
    _, _, jloader, jmodel = _jax_model("centerpoint_tiny")
    jbatch = jax_load_data_to_device(next(iter(jloader)))
    template = jax.jit(lambda k, b: jmodel.init(k, b, train=False))(
        jax.random.PRNGKey(0), jbatch)
    variables, _, _, _ = load_checkpoint(str(CKPT), template)
    jout = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
        variables, jbatch)
    jout = {k: np.asarray(jout[k]) for k in (
        "spatial_features", "spatial_features_2d", "final_boxes",
        "final_scores", "final_labels", "final_valid")}
    numpy_vars = flax.core.unfreeze(jax.device_get(variables))

    _, _, loader, model = _port_model("centerpoint_tiny")
    model.load_state_dict(state_dict_from_jax(numpy_vars), strict=True)
    with torch.no_grad():
        out = model(load_data_to_device(next(iter(loader)), device="cpu"))
    return numpy_vars, jout, model, out


def _nchw(a):
    return np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2))


@pytest.mark.parametrize("key", ["spatial_features", "spatial_features_2d"])
def test_bev_maps_match_reference(tiny, key):
    _, jout, _, out = tiny
    ours, ref = out[key].numpy(), _nchw(jout[key])
    assert ours.shape == ref.shape
    assert np.abs(ref).max() > 1.0                   # a real, trained signal
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)


def test_detections_match_reference(tiny):
    _, jout, _, out = tiny
    valid = jout["final_valid"]
    np.testing.assert_array_equal(out["final_valid"].numpy(), valid)
    assert valid.sum() > 5                          # the trained model detects
    np.testing.assert_array_equal(out["final_labels"].numpy()[valid],
                                  jout["final_labels"][valid])
    np.testing.assert_allclose(out["final_boxes"].numpy()[valid],
                               jout["final_boxes"][valid], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(out["final_scores"].numpy()[valid],
                               jout["final_scores"][valid], rtol=1e-4,
                               atol=1e-4)


def test_weights_match_reference_pcdet_export(tiny):
    """Key for key and value for value against the reference's exporter;
    sparse-conv weights differ only in layout (spconv2's (O, kd, kh, kw, I)
    there, the kernel's (K, Cin, Cout) here)."""
    numpy_vars, _, model, _ = tiny
    ours = state_dict_from_jax(numpy_vars)
    ref, skipped = export_torch_state_dict(numpy_vars)
    assert not skipped
    assert set(ours) == set(ref) == set(model.state_dict())
    for name, r in ref.items():
        o = ours[name].numpy()
        if r.ndim == 5:
            r = r.reshape(r.shape[0], -1, r.shape[-1]).transpose(1, 2, 0)
        assert o.shape == r.shape, name
        np.testing.assert_array_equal(o, r, err_msg=name)
    # the BN eps the state dict cannot carry: 1e-3 in the sparse and BEV
    # BNs, BN_EPS (default 1e-5) in CenterHead
    assert model.backbone_3d.conv1[0].bn1.eps == 1e-3
    assert model.backbone_2d.blocks[0][2].eps == 1e-3
    assert model.dense_head.shared_conv[1].eps == 1e-5
