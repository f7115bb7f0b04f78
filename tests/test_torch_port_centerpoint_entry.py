"""The port's entry points and package on the CPU: the ref-width tree
loading strictly, the package importing no JAX, and the entry points
refusing to fall back to the CPU (moved out of
``test_torch_port_centerpoint.py`` so that each file keeps at most 5 tests
and ``--dist loadfile`` dispatches ``test_accuracy_regression.py`` early).
"""

import subprocess
import sys

import flax
import jax
import numpy as np
import pytest
import torch

from q3d_tpu_torch.config import cfg_from_yaml_file, EDict
from q3d_tpu_torch.datasets import build_dataloader
from q3d_tpu_torch.models import build_network, load_data_to_device
from q3d_tpu_torch.utils.weights import state_dict_from_jax

from test_torch_port_centerpoint import CFG_DIR, ROOT, _jax_model, _port_model
from torch_port_jax_cache import jax_compile_cache  # noqa: F401

torch.set_num_threads(2)


def test_ref_width_state_dict_loads_strictly():
    """centerpoint_ref at full width: the reference's variable tree (shapes
    only, from ``jax.eval_shape``) carries across and loads strictly."""
    cfg, ds, loader, jmodel = _jax_model("centerpoint_ref")
    pp = cfg.DATA_CONFIG.DATA_PROCESSOR[-1]
    v, p = int(pp.MAX_NUMBER_OF_VOXELS["test"]), int(pp.MAX_POINTS_PER_VOXEL)
    c = int(ds.point_feature_encoder.num_point_features)
    batch = {"voxels": jax.ShapeDtypeStruct((2, v, p, c), np.float32),
             "voxel_coords": jax.ShapeDtypeStruct((2, v, 3), np.int32),
             "voxel_num_points": jax.ShapeDtypeStruct((2, v), np.int32),
             "batch_size": 2}
    shapes = jax.eval_shape(
        lambda k, b: jmodel.init(k, b, train=False), jax.random.PRNGKey(0),
        batch)
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   flax.core.unfreeze(shapes))
    _, _, _, model = _port_model("centerpoint_ref")
    model.load_state_dict(state_dict_from_jax(zeros), strict=True)
    assert model.backbone_3d.conv_input[0].weight.shape == (27, 16, 16)
    assert model.backbone_3d.conv_out[0].weight.shape == (3, 128, 128)


def test_package_never_imports_jax():
    """Import every module of the port, the quant package included (and
    chip_smoke.py), in a fresh interpreter: neither jax, flax, msgpack nor
    the JAX package gets loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import q3d_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    q3d_tpu_torch.__path__, 'q3d_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'msgpack', 'q3d_tpu'))\n"
        "print(len(mods), bad)\n"
        "quant = [m for m in mods if m.startswith('q3d_tpu_torch.quant.')]\n"
        "sys.exit(1 if bad or len(mods) < 45 or len(quant) < 3 else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    """Without ``device`` the entry points want CUDA and raise without it;
    they never drop quietly to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = cfg_from_yaml_file(str(CFG_DIR / "centerpoint_tiny.yaml"), EDict())
    ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                     batch_size=2, training=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_network(cfg.MODEL, len(cfg.CLASS_NAMES), ds)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_data_to_device({"voxels": np.zeros((1, 2, 3), np.float32)})
    assert load_data_to_device({"voxels": np.zeros((1, 2, 3), np.float32)},
                               device="cpu")["voxels"].device.type == "cpu"
