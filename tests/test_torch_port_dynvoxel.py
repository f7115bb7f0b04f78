"""PyTorch port vs the JAX package: the dynamic 3D VFEs on the tiny
CenterPoint of ``centerpoint_dynvoxel_tiny.yaml`` (DynamicVoxelVFE
[16, 16] -> VoxelResBackBone8x -> HeightCompression -> BaseBEVBackbone ->
CenterHead), f32, batch 2, on the reference's seeded weights with every
BN's statistics set from the batch (``torch_port_anchor_common.build``).

* ``DynamicVoxelVFE``: voxel coordinates and point counts bit-equal, the
  features within 1e-5 of their scale (the voxel means an f64 running sum
  rounded once against the reference's f32 scatter-add); in eval mode, and
  in train mode (``MaskedBatchNorm`` over the kept points) with a per-frame
  capacity that bites (1,500 of ~3,000 voxels a frame: the highest keys of
  each frame dropped), with the running statistics within 1e-6;
* ``DynamicMeanVFE`` (the mean over all of a voxel's points, no cap on
  the points of a voxel): coordinates and counts bit-equal, the means
  within 1e-6 of their scale, at the config's capacity and at 1,500;
* the whole tiny model: the BEV map within 1e-4 of its scale, the
  detections slot for slot (valid and labels equal, boxes and scores within
  1e-4 + 1e-4 relative), as ``test_torch_port_centerpoint.py`` holds them.
"""

import jax
import numpy as np
import pytest
import torch

from q3d_tpu.models.backbones_3d.vfe import dynamic_mean_vfe as jax_dmv
from q3d_tpu.models.backbones_3d.vfe import dynamic_voxel_vfe as jax_dvv

import torch_port_anchor_common as common
from q3d_tpu_torch.models.backbones_3d.vfe.dynamic_mean_vfe import (
    DynamicMeanVFE)
from q3d_tpu_torch.models.backbones_3d.vfe.dynamic_voxel_vfe import (
    DynamicVoxelVFE)
from q3d_tpu_torch.utils.weights import state_dict_from_jax
from torch_port_jax_cache import jax_compile_cache  # noqa: F401

torch.set_num_threads(2)
LAYER_RTOL = 1e-5
MAP_RTOL = 1e-4
DET_TOL = 1e-4
OUT_KEYS = ("final_boxes", "final_scores", "final_labels", "final_valid")
VFE_KEYS = ("voxel_features", "voxel_coords", "voxel_num_points")


@pytest.fixture(scope="module")
def ref():
    r = common.build("centerpoint_dynvoxel_tiny")

    def apply(v, b):
        out = r["model"].apply(v, b, train=False)
        return {k: out[k] for k in OUT_KEYS + VFE_KEYS
                + ("spatial_features_2d",)}
    out = jax.jit(apply)(r["vars"], r["batch"])
    r["out"] = {k: np.asarray(v) for k, v in out.items()}
    return r


def _rel(ours, theirs):
    scale = float(np.abs(theirs).max())
    assert scale > 1e-3, scale
    return float(np.abs(ours - theirs).max()) / scale


def _check_voxels(out, want, rtol):
    for k in ("voxel_coords", "voxel_num_points"):
        np.testing.assert_array_equal(out[k].numpy(), want[k], err_msg=k)
    assert _rel(out["voxel_features"].numpy(), want["voxel_features"]) <= rtol


def test_dynamic_voxel_vfe_matches_reference(ref):
    vfe = ref["port"].vfe
    with torch.no_grad():
        out = vfe(dict(ref["port_batch"]))
    want = ref["out"]
    assert (want["voxel_num_points"] > 0).sum(1).min() > 2500
    _check_voxels(out, want, LAYER_RTOL)

    cap = 1500
    jvfe = jax_dvv.DynamicVoxelVFE(ref["model"].model_cfg.VFE, 4,
                                   vfe.voxel_size, vfe.point_cloud_range,
                                   vfe.grid_size, cap)
    v = {c: ref["vars"][c]["vfe"] for c in ("params", "batch_stats")}
    want, upd = jax.jit(lambda v, b: jvfe.apply(
        v, b, True, mutable=["batch_stats"]))(v, ref["batch"])
    want = {k: np.asarray(want[k]) for k in VFE_KEYS}
    small = DynamicVoxelVFE(ref["cfg"].MODEL.VFE, 4, vfe.voxel_size,
                            vfe.point_cloud_range, vfe.grid_size, cap)
    small.load_state_dict(vfe.state_dict())
    small.train()
    with torch.no_grad():
        out = small(dict(ref["port_batch"]))
    assert (want["voxel_num_points"] > 0).all()         # full
    _check_voxels(out, want, LAYER_RTOL)
    stats = state_dict_from_jax({"batch_stats": {"vfe": jax.tree_util.tree_map(
        np.asarray, upd["batch_stats"])}})
    for k, t in small.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(t.numpy(), stats[f"vfe.{k}"],
                                       rtol=1e-6, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("cap", [6000, 1500])
def test_dynamic_mean_vfe_matches_reference(ref, cap):
    vfe = ref["port"].vfe
    jvfe = jax_dmv.DynamicMeanVFE(ref["model"].model_cfg.VFE, 4,
                                  vfe.voxel_size, vfe.point_cloud_range,
                                  vfe.grid_size, cap)
    want = jax.jit(lambda b: jvfe.apply({}, b, False))(ref["batch"])
    want = {k: np.asarray(want[k]) for k in VFE_KEYS}
    mean = DynamicMeanVFE(ref["cfg"].MODEL.VFE, 4, vfe.voxel_size,
                          vfe.point_cloud_range, vfe.grid_size, cap)
    out = mean(dict(ref["port_batch"]))
    assert mean.get_output_feature_dim() == 4
    assert want["voxel_num_points"].max() > 10    # beyond a 10-point cap
    _check_voxels(out, want, 1e-6)


def test_dynvoxel_tiny_detections_match_reference(ref):
    with torch.no_grad():
        out = ref["port"](dict(ref["port_batch"]))
    out = {k: v.numpy() for k, v in out.items()
           if isinstance(v, torch.Tensor)}
    want = ref["out"]
    assert _rel(out["spatial_features_2d"],
                want["spatial_features_2d"].transpose(0, 3, 1, 2)) <= MAP_RTOL
    valid = want["final_valid"]
    np.testing.assert_array_equal(out["final_valid"], valid)
    assert valid.sum() > 10
    np.testing.assert_array_equal(out["final_labels"][valid],
                                  want["final_labels"][valid])
    for k in ("final_boxes", "final_scores"):
        np.testing.assert_allclose(out[k][valid], want[k][valid],
                                   rtol=DET_TOL, atol=DET_TOL, err_msg=k)
