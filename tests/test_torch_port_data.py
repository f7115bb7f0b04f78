"""PyTorch port vs the JAX package: config, voxelizer and the data batch.

Every comparison here is exact: the port's data pipeline is host numpy, so
its batches must equal the reference's element for element.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import q3d_tpu.ops.voxelizer as jax_vox
from q3d_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
from q3d_tpu.config import EDict as JaxEDict
from q3d_tpu.datasets import build_dataloader as jax_build_dataloader

from q3d_tpu_torch.config import cfg_from_yaml_file, cfg_from_list, EDict
from q3d_tpu_torch.datasets import build_dataloader
from q3d_tpu_torch.ops import voxelizer as port_vox
from torch_port_jax_cache import jax_compile_cache  # noqa: F401

torch.set_num_threads(2)

CFG_DIR = Path(__file__).resolve().parent.parent / "tools" / "cfgs" / \
    "synthetic_models"


def _plain(d):
    """EDict trees -> plain dicts/lists for comparison."""
    if isinstance(d, dict):
        return {k: _plain(v) for k, v in d.items()}
    if isinstance(d, (list, tuple)):
        return [_plain(v) for v in d]
    return d


@pytest.mark.parametrize("name", ["centerpoint_tiny", "centerpoint_ref"])
def test_config_matches_reference(name):
    path = str(CFG_DIR / f"{name}.yaml")
    ours = cfg_from_yaml_file(path, EDict())
    ref = jax_cfg_from_yaml(path, JaxEDict())
    assert _plain(ours) == _plain(ref)
    assert ours.MODEL.DENSE_HEAD.POST_PROCESSING.NMS_CONFIG.NMS_THRESH == \
        ref.MODEL.DENSE_HEAD.POST_PROCESSING.NMS_CONFIG.NMS_THRESH


def test_config_dotted_override():
    cfg = cfg_from_yaml_file(str(CFG_DIR / "centerpoint_tiny.yaml"), EDict())
    cfg_from_list(["MODEL.DENSE_HEAD.POST_PROCESSING.NMS_CONFIG.NMS_THRESH",
                   "0.5"], cfg)
    assert cfg.MODEL.DENSE_HEAD.POST_PROCESSING.NMS_CONFIG.NMS_THRESH == 0.5


@pytest.mark.parametrize("seed,max_points,max_voxels", [
    (0, 8, 6000),      # no overflow
    (1, 2, 6000),      # per-voxel point overflow
    (2, 4, 150),       # voxel-count overflow
])
def test_voxelize_matches_reference_numpy(monkeypatch, seed, max_points,
                                          max_voxels):
    """The port's vectorized voxelizer equals the reference's numpy loop
    exactly (the native C++ twin is switched off for the reference)."""
    monkeypatch.setattr(jax_vox, "_NATIVE", False)
    rng = np.random.RandomState(seed)
    pc_range = [-3.0, -3.0, -1.0, 3.0, 3.0, 1.0]
    vs = [0.3, 0.3, 0.25]
    # clustered points so voxels hold several points; some fall outside
    pts = np.concatenate([rng.uniform(-3.5, 3.5, (600, 3)),
                          rng.normal(0.0, 0.2, (600, 3))]).astype(np.float32)
    pts = np.concatenate([pts, rng.rand(len(pts), 1).astype(np.float32)], 1)
    ours = port_vox.voxelize_np(pts, vs, pc_range, max_points, max_voxels)
    ref = jax_vox.voxelize_np(pts, vs, pc_range, max_points, max_voxels)
    for a, b in zip(ours[:3], ref[:3]):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert ours[3] == ref[3]


def test_tiny_batch_matches_reference():
    """centerpoint_tiny, test split, batch 2: the collated numpy batch equals
    the reference's (which may voxelize with its C++ twin)."""
    path = str(CFG_DIR / "centerpoint_tiny.yaml")
    cfg = cfg_from_yaml_file(path, EDict())
    jcfg = jax_cfg_from_yaml(path, JaxEDict())
    ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                     batch_size=2, training=False)
    jds, jloader, _ = jax_build_dataloader(jcfg.DATA_CONFIG, jcfg.CLASS_NAMES,
                                           batch_size=2, training=False)
    assert len(ds) == len(jds) and len(loader) == len(jloader)
    ours, ref = next(iter(loader)), next(iter(jloader))
    for key in ("voxels", "voxel_coords", "voxel_num_points"):
        assert ours[key].dtype == ref[key].dtype, key
        np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)
    assert ours["batch_size"] == ref["batch_size"] == 2
    assert (ours["voxel_coords"][..., 0] >= 0).sum() > 0
    assert tuple(ds.grid_size) == tuple(jds.grid_size)
    np.testing.assert_array_equal(ds.point_cloud_range, jds.point_cloud_range)
