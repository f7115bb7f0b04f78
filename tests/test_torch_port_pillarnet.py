"""PyTorch port vs the JAX package: PillarNet, tiny (``pillarnet_tiny.yaml``),
f32, batch 2, on the reference's seeded weights with every BN's statistics
set from the batch (``torch_port_anchor_common.build``).

DynamicPillarVFE -> PillarBackBone8x (11 2D sparse convs, dense conv5) ->
BaseBEVBackboneV1 -> CenterHead, and the modules the slice adds beside
them: ``MaskedBatchNorm``, ``PillarRes18BackBone8x`` and
``BaseBEVResBackbone``.  Tolerances: integer coordinates bit-equal; a
module fed the reference's own input within 1e-5 of its output's largest
magnitude (f32 sums in another order; the VFE's pillar means are an f64
running sum rounded once against the reference's f32 scatter-add, a few
ulps apart); the whole model's maps within 1e-4 of their largest
magnitude (measured 8.3e-6 for ``spatial_features_2d``), the detections
slot for slot (valid and labels equal, boxes but the heading and scores
within 1e-4 + 1e-4 relative, the heading within 1e-3 rad: atan2 of the rot
branch's two outputs, short vectors on these random weights), as
``test_torch_port_voxelnext.py`` holds them.
"""

import dataclasses

import flax
import jax
import numpy as np
import pytest
import torch

from q3d_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
from q3d_tpu.config import EDict as JaxEDict
from q3d_tpu.models import build_network as jax_build_network
from q3d_tpu.models import layers as jax_layers
from q3d_tpu.models.backbones_2d import base_bev_backbone as jax_bev
from q3d_tpu.models.backbones_3d import spconv_backbone_2d as jax_sp2d
from q3d_tpu.models.backbones_3d.vfe import dynamic_pillar_vfe as jax_dpv
from q3d_tpu.models.detectors.detector3d_template import (
    DatasetInfo as JaxDatasetInfo)

import torch_port_anchor_common as common
from q3d_tpu_torch.config import EDict, cfg_from_yaml_file
from q3d_tpu_torch.models import build_network
from q3d_tpu_torch.models.backbones_2d.base_bev_backbone import (
    BaseBEVResBackbone)
from q3d_tpu_torch.models.backbones_3d import spconv_backbone_2d as port_sp2d
from q3d_tpu_torch.models.backbones_3d.vfe.dynamic_pillar_vfe import (
    DynamicPillarVFE)
from q3d_tpu_torch.models.detectors.detector3d_template import DatasetInfo
from q3d_tpu_torch.models.layers import MaskedBatchNorm
from q3d_tpu_torch.utils.weights import state_dict_from_jax
from torch_port_jax_cache import jax_compile_cache  # noqa: F401

torch.set_num_threads(2)
LAYER_RTOL = 1e-5
MAP_RTOL = 1e-4
DET_TOL = 1e-4
HEADING_TOL = 1e-3
PILLAR_CFG = common.CFG_DIR.parents[2] / "q3d_tpu_torch" / "cfgs" / \
    "nuscenes_models" / "cbgs_pillar0075_res2d_centerpoint.yaml"
OUT_KEYS = ("final_boxes", "final_scores", "final_labels", "final_valid")


@pytest.fixture(scope="module")
def ref():
    """The tiny model on both sides, and one jitted reference forward with
    the VFE's output, x_conv4, x_conv5 and the BEV map kept."""
    r = common.build("pillarnet_tiny")

    def apply(v, b):
        out = r["model"].apply(v, b, train=False)
        ms = out["multi_scale_2d_features"]
        return {**{k: out[k] for k in OUT_KEYS + (
            "pillar_features", "pillar_coords", "spatial_features_2d")},
                "x_conv4": ms["x_conv4"], "x_conv5": ms["x_conv5"]}
    out = jax.jit(apply)(r["vars"], r["batch"])
    r["out"] = {k: np.asarray(v) for k, v in out.items()}
    return r


def _rel(ours, theirs):
    scale = float(np.abs(theirs).max())
    assert scale > 1e-3, scale                 # a signal, not zeros
    return float(np.abs(ours - theirs).max()) / scale


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _port_variables(tree, module):
    """The reference's variables of one module (its own tree, no outer
    name) -> the port's state dict of that module."""
    wrapped = {c: {module: v} for c, v in tree.items()}
    return {k.split(".", 1)[1]: v
            for k, v in state_dict_from_jax(wrapped).items()}


def test_masked_batch_norm_matches_reference():
    """Train mode (statistics of the masked rows only, mean then biased
    variance; running statistics moved by 0.01) and eval mode, on rows with
    a per-channel offset and a third of them masked out."""
    rng = np.random.RandomState(0)
    x = (rng.randn(600, 16) * 3 + rng.randn(16) * 5).astype(np.float32)
    mask = rng.rand(600) > 0.33
    x[~mask] += 100.0                           # would move the statistics
    jbn = jax_layers.MaskedBatchNorm()
    leaves = {"scale": rng.uniform(0.5, 2, 16), "bias": rng.randn(16),
              "mean": rng.randn(16), "var": rng.uniform(0.5, 2, 16)}
    leaves = {k: a.astype(np.float32) for k, a in leaves.items()}
    v = {"params": {"bn": {k: leaves[k] for k in ("scale", "bias")}},
         "batch_stats": {"bn": {k: leaves[k] for k in ("mean", "var")}}}
    bn = MaskedBatchNorm(16, eps=1e-3)
    bn.load_state_dict({k: torch.from_numpy(leaves[j]) for k, j in (
        ("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"),
        ("running_var", "var"))})
    jy_eval = np.asarray(jbn.apply(v, x, mask, False))
    jy, upd = jbn.apply(v, x, mask, True, mutable=["batch_stats"])
    tx, tm = torch.from_numpy(x), torch.from_numpy(mask)
    with torch.no_grad():
        bn.eval()
        assert _rel(bn(tx, tm).numpy(), jy_eval) <= LAYER_RTOL
        bn.train()
        y = bn(tx, tm).numpy()
    assert _rel(y[mask], np.asarray(jy)[mask]) <= LAYER_RTOL
    assert np.abs(y[mask].mean(0) - leaves["bias"]).max() < 1e-3
    for ours, leaf in ((bn.running_mean, "mean"), (bn.running_var, "var")):
        np.testing.assert_allclose(ours.numpy(),
                                   np.asarray(upd["batch_stats"]["bn"][leaf]),
                                   rtol=1e-6, atol=1e-6)


def test_dynamic_pillar_vfe_matches_reference(ref):
    for train in (False, True):
        _vfe_case(ref, train)


def _vfe_case(ref, train):
    """The tiny model's VFE (eval: the model's own output) and, with a
    MAX_PILLARS that bites (3,000 of the batch's ~7,100 pillars: the
    highest keys, frame 1's and the top of frame 0's, fall into the
    overflow row) in train mode (``MaskedBatchNorm`` on the kept points'
    statistics): pillar coordinates bit-equal, features within 1e-5 of
    their scale, running statistics within 1e-6."""
    port_vfe = ref["port"].vfe
    batch = dict(ref["port_batch"])
    if not train:
        with torch.no_grad():
            out = port_vfe(batch)
        want = ref["out"]
        assert (want["pillar_coords"][:, 0] >= 0).sum() > 7000
    else:
        cap = 3000
        jvfe = jax_dpv.DynamicPillarVFE(
            ref["model"].model_cfg.VFE, 4, port_vfe.voxel_size,
            port_vfe.point_cloud_range, port_vfe.grid_size, cap)
        v = {c: ref["vars"][c]["vfe"] for c in ("params", "batch_stats")}
        want, upd = jax.jit(lambda v, b: jvfe.apply(
            v, b, True, mutable=["batch_stats"]))(v, ref["batch"])
        want = {k: np.asarray(want[k]) for k in ("pillar_features",
                                                 "pillar_coords")}
        port_vfe = DynamicPillarVFE(ref["cfg"].MODEL.VFE, 4,
                                    port_vfe.voxel_size,
                                    port_vfe.point_cloud_range,
                                    port_vfe.grid_size, cap)
        port_vfe.load_state_dict(ref["port"].vfe.state_dict())
        port_vfe.train()
        with torch.no_grad():
            out = port_vfe(batch)
        # full, and only frame 0's lowest keys kept
        assert (want["pillar_coords"][:, 0] == 0).all()
        stats = _port_variables(jax.tree_util.tree_map(np.asarray, upd),
                                "vfe")
        for k, t in port_vfe.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(t.numpy(), stats[k], rtol=1e-6,
                                           atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(out["pillar_coords"].numpy(),
                                  want["pillar_coords"])
    assert _rel(out["pillar_features"].numpy(),
                want["pillar_features"]) <= LAYER_RTOL


def test_pillar_backbones_and_bev_backbones_match_reference(ref):
    """Each fed the reference's own input: PillarBackBone8x (the tiny
    model's) and PillarRes18BackBone8x (seeded from numpy as the
    reference initialises it, BN statistics 0 / 1) on the reference VFE's
    rows -> x_conv4 (dense) and x_conv5 within 1e-5 of their scale (the
    VFE's empty rows, -1, sort last and ``dense()`` drops them);
    BaseBEVBackboneV1 on the reference's x_conv4 / x_conv5 ->
    spatial_features_2d; BaseBEVResBackbone ([1, 1] residual pairs, strides
    [1, 2], deblocks [1, 2]) on a random map, at small width."""
    out = ref["out"]
    feats = {"pillar_features": torch.tensor(out["pillar_features"]),
             "pillar_coords": torch.tensor(out["pillar_coords"]),
             "pillar_batch_size": 2}
    with torch.no_grad():
        ms = ref["port"].backbone_3d(dict(feats))["multi_scale_2d_features"]
        bev = ref["port"].backbone_2d({"multi_scale_2d_features": {
            k: _nchw(out[k]) for k in ("x_conv4", "x_conv5")}})
    for k in ("x_conv4", "x_conv5"):
        assert _rel(ms[k].numpy(), out[k].transpose(0, 3, 1, 2)) <= LAYER_RTOL
    # the VFE's -1 rows sort last and dense() drops them
    st = port_sp2d._make_pillar_tensor(feats,
                                       ref["port"].backbone_3d.sparse_shape)
    valid = st.valid.numpy()
    n = int(valid.sum())
    assert 0 < n < valid.size and valid[:n].all()
    ones = st.replace(features=torch.ones_like(st.features))
    assert float(ones.dense().sum()) == n * st.num_channels
    assert _rel(bev["spatial_features_2d"].numpy(),
                out["spatial_features_2d"].transpose(0, 3, 1, 2)) \
        <= LAYER_RTOL

    # PillarRes18BackBone8x, standalone
    vfe = ref["port"].vfe
    jres = jax_sp2d.PillarRes18BackBone8x(
        ref["model"].model_cfg.BACKBONE_3D, 32, vfe.grid_size, vfe.voxel_size,
        vfe.point_cloud_range)
    jb = {k: out[k] for k in ("pillar_features", "pillar_coords")}

    def with_size(b):
        return {**b, "pillar_batch_size": 2}
    v = common._seeded_variables(jax.eval_shape(
        lambda k, b: jres.init(k, with_size(b), False), jax.random.PRNGKey(0),
        jb), seed=3)
    jms = jax.jit(lambda v, b: jres.apply(v, with_size(b), False)[
        "multi_scale_2d_features"])(v, jb)
    res = port_sp2d.PillarRes18BackBone8x(ref["cfg"].MODEL.BACKBONE_3D, 32,
                                          vfe.grid_size)
    res.load_state_dict(_port_variables(v, "backbone_3d"), strict=True)
    res.eval()
    with torch.no_grad():
        pms = res(dict(feats))["multi_scale_2d_features"]
    assert sum(m.weight.dim() == 3 for m in res.modules()
               if hasattr(m, "weight") and m.weight is not None) == 19
    for k in ("x_conv4", "x_conv5"):
        assert _rel(pms[k].numpy(), np.asarray(jms[k]).transpose(0, 3, 1, 2)) \
            <= LAYER_RTOL, k

    # BaseBEVResBackbone, standalone, small width
    cfg = EDict({"LAYER_NUMS": [1, 1], "LAYER_STRIDES": [1, 2],
                 "NUM_FILTERS": [16, 32], "UPSAMPLE_STRIDES": [1, 2],
                 "NUM_UPSAMPLE_FILTERS": [16, 16]})
    jrb = jax_bev.BaseBEVResBackbone(cfg, 8)
    x = np.random.RandomState(4).randn(2, 20, 24, 8).astype(np.float32)
    v = common._seeded_variables(jax.eval_shape(
        lambda k, b: jrb.init(k, b, False), jax.random.PRNGKey(0),
        {"spatial_features": x}), seed=4)
    want = np.asarray(jax.jit(lambda v, b: jrb.apply(v, b, False)[
        "spatial_features_2d"])(v, {"spatial_features": x}))
    prb = BaseBEVResBackbone(cfg, 8)
    prb.load_state_dict(_port_variables(v, "backbone_2d"), strict=True)
    prb.eval()
    with torch.no_grad():
        got = prb({"spatial_features": _nchw(x)})["spatial_features_2d"]
    assert prb.num_bev_features == 32 and got.shape == (2, 32, 20, 24)
    assert _rel(got.numpy(), want.transpose(0, 3, 1, 2)) <= LAYER_RTOL


def test_tiny_pillarnet_detections_match_reference(ref):
    """The whole tiny model: pillar coordinates bit-equal, the BEV map
    within 1e-4 of its scale, the detections slot for slot."""
    with torch.no_grad():
        out = ref["port"](dict(ref["port_batch"]))
    out = {k: v.numpy() for k, v in out.items()
           if isinstance(v, torch.Tensor)}
    want = ref["out"]
    np.testing.assert_array_equal(out["pillar_coords"], want["pillar_coords"])
    assert _rel(out["spatial_features_2d"],
                want["spatial_features_2d"].transpose(0, 3, 1, 2)) <= MAP_RTOL
    valid = want["final_valid"]
    np.testing.assert_array_equal(out["final_valid"], valid)
    assert valid.sum() > 10
    np.testing.assert_array_equal(out["final_labels"][valid],
                                  want["final_labels"][valid])
    ob, tb = out["final_boxes"][valid], want["final_boxes"][valid]
    np.testing.assert_allclose(ob[:, :6], tb[:, :6], rtol=DET_TOL,
                               atol=DET_TOL)
    dh = np.abs(np.angle(np.exp(1j * (ob[:, 6] - tb[:, 6]))))
    assert dh.max() <= HEADING_TOL
    np.testing.assert_allclose(out["final_scores"][valid],
                               want["final_scores"][valid], rtol=DET_TOL,
                               atol=DET_TOL)


def test_full_width_config_builds_in_both_packages():
    """``cbgs_pillar0075_res2d_centerpoint.yaml`` loads unchanged in both
    packages (its ``_BASE_CONFIG_`` through the ``tools/`` fallback), and at
    its own geometry (1440 x 1440 x 1 pillars, the nuScenes dataset's 5
    point features) the reference's variable tree (``jax.eval_shape`` of
    ``init``, no forward) goes through ``state_dict_from_jax`` with the
    port's names and shapes and loads strictly: 19 sparse convs (the
    strided 128 -> 256 and four SubM 256 -> 256 among them), the dense
    conv5, [5, 5] BEV layers."""
    jcfg = jax_cfg_from_yaml(str(PILLAR_CFG), JaxEDict())
    pcfg = cfg_from_yaml_file(str(PILLAR_CFG), EDict())
    assert jcfg == pcfg
    dc = pcfg.DATA_CONFIG
    grid_step = dc.DATA_PROCESSOR[-1]
    assert grid_step.NAME == "calculate_grid_size"
    pc = np.asarray(dc.POINT_CLOUD_RANGE, np.float32)
    vs = np.asarray(grid_step.VOXEL_SIZE, np.float32)
    grid = tuple(int(g) for g in np.round((pc[3:] - pc[:3]) / vs))
    assert grid == (1440, 1440, 1)
    geo = dict(class_names=tuple(pcfg.CLASS_NAMES),
               num_point_features=len(
                   dc.POINT_FEATURE_ENCODING.used_feature_list),
               grid_size=grid, point_cloud_range=tuple(float(v) for v in pc),
               voxel_size=tuple(float(v) for v in vs))
    n = int(dc.MAX_RAW_POINTS)
    batch = {"points": jax.ShapeDtypeStruct((2, n, 5), np.float32),
             "points_mask": jax.ShapeDtypeStruct((2, n), np.bool_),
             "batch_size": 2}
    jmodel = jax_build_network(jcfg.MODEL, len(jcfg.CLASS_NAMES),
                               JaxDatasetInfo(**geo))
    shapes = jax.eval_shape(lambda k, b: jmodel.init(k, b, train=False),
                            jax.random.PRNGKey(0), batch)
    state = state_dict_from_jax(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), flax.core.unfreeze(shapes)))
    model = build_network(pcfg.MODEL, len(pcfg.CLASS_NAMES),
                          DatasetInfo(**geo), device="cpu")
    own = model.state_dict()
    assert set(state) == set(own)
    for key, t in state.items():
        assert tuple(t.shape) == tuple(own[key].shape), key
    model.load_state_dict(state, strict=True)
    sparse = [m.weight.shape for m in model.backbone_3d.modules()
              if getattr(m, "weight", None) is not None
              and m.weight.dim() == 3]
    assert len(sparse) == 19 and sum(s == (9, 256, 256) for s in sparse) == 4
    assert sum(s == (9, 128, 256) for s in sparse) == 1
    assert model.vfe.max_pillars == 240000
    assert model.vfe.pfn_layers[0].linear.weight.shape == (32, 10)
    assert model.backbone_2d.num_bev_features == 256
    assert dataclasses.asdict(DatasetInfo(**geo))["max_voxels"] is None
