"""PyTorch port vs the JAX package: the anchor heads' parts, cheaply.

The anchors of the tiny and the KITTI configs (exactly equal),
``ResidualCoder`` and the direction-bin correction (within 1e-6 of scale),
PillarVFE and PointPillarScatter alone (within 1e-5 of scale), the SECOND
and PointPillars recipes (rules equal for every ``(sq, static)``), and the
KITTI configs' full-width variable trees (``jax.eval_shape``), which load
strictly into the port's SECONDNet and PointPillar with every shape equal.
"""

import dataclasses
import itertools
from pathlib import Path

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from q3d_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
from q3d_tpu.config import EDict as JaxEDict
from q3d_tpu.models import build_network as jax_build_network
from q3d_tpu.models.detectors.detector3d_template import (
    DatasetInfo as JaxDatasetInfo)
from q3d_tpu.quant import api as jax_api
from q3d_tpu.utils import box_coder_utils as jax_coder

import torch_port_anchor_common as common
from q3d_tpu_torch.config import cfg_from_yaml_file, EDict
from q3d_tpu_torch.models import build_network
from q3d_tpu_torch.models.detectors.detector3d_template import DatasetInfo
from q3d_tpu_torch.quant import api as port_api
from q3d_tpu_torch.utils import box_coder_utils as port_coder
from q3d_tpu_torch.utils.weights import state_dict_from_jax

torch.set_num_threads(2)

KITTI = Path(__file__).resolve().parent.parent / "tools" / "cfgs" / \
    "kitti_models"


def _kitti(name):
    """Both packages' KITTI configs and their geometry, as a DatasetInfo
    each (no KITTI data is needed to build the model)."""
    jcfg = jax_cfg_from_yaml(str(KITTI / f"{name}.yaml"), JaxEDict())
    pcfg = cfg_from_yaml_file(str(KITTI / f"{name}.yaml"), EDict())
    dc = pcfg.DATA_CONFIG
    vox = dc.DATA_PROCESSOR[-1]
    pc_range = np.asarray(dc.POINT_CLOUD_RANGE, np.float32)
    grid = np.round((pc_range[3:] - pc_range[:3])
                    / np.asarray(vox.VOXEL_SIZE, np.float32)).astype(int)
    geo = dict(class_names=tuple(pcfg.CLASS_NAMES), num_point_features=4,
               grid_size=tuple(int(g) for g in grid),
               point_cloud_range=tuple(float(v) for v in pc_range),
               voxel_size=tuple(float(v) for v in vox.VOXEL_SIZE))
    return jcfg, pcfg, JaxDatasetInfo(**geo), DatasetInfo(**geo), vox


def _jax_head(jcfg, info):
    """The reference's AnchorHeadSingle, bound without variables (its
    setup computes the anchors)."""
    model = jax_build_network(jcfg.MODEL, len(jcfg.CLASS_NAMES), info)
    return model.bind({}).dense_head


@pytest.mark.parametrize("name", ["second_iou_tiny", "pointpillar_tiny",
                                  "kitti/second", "kitti/pointpillar"])
def test_anchors_equal_reference(name):
    """(Na, 7) anchors, bit for bit, in the reference's flattening order:
    SECOND at KITTI 176 x 200 x 6 = 211,200, PointPillars 216 x 248 x 6 =
    321,408."""
    if name.startswith("kitti/"):
        jcfg, pcfg, jinfo, pinfo, _ = _kitti(name.split("/")[1])
    else:
        jcfg, pcfg = common.configs(name)
        from q3d_tpu.datasets import build_dataloader as jax_bl
        from q3d_tpu_torch.datasets import build_dataloader
        jinfo = jax_bl(jcfg.DATA_CONFIG, jcfg.CLASS_NAMES, 2,
                       training=False)[0]
        pinfo = build_dataloader(pcfg.DATA_CONFIG, pcfg.CLASS_NAMES, 2,
                                 training=False)[0]
    theirs = np.asarray(_jax_head(jcfg, jinfo).flat_anchors())
    model = build_network(pcfg.MODEL, len(pcfg.CLASS_NAMES), pinfo,
                          device="cpu")
    ours = model.dense_head.anchors.numpy()
    assert ours.dtype == theirs.dtype == np.float32
    np.testing.assert_array_equal(ours, theirs)
    want = {"kitti/second": 211200, "kitti/pointpillar": 321408}
    assert ours.shape[0] == want.get(name, ours.shape[0])


@pytest.mark.parametrize("sincos", [False, True])
def test_residual_coder_matches_reference(sincos):
    rng = np.random.RandomState(3)
    n = 4096
    anchors = np.concatenate([rng.uniform(-40, 40, (n, 3)),
                              rng.uniform(0.3, 5, (n, 3)),
                              rng.uniform(-np.pi, np.pi, (n, 1))], 1)
    boxes = anchors + np.concatenate([rng.normal(0, 1, (n, 3)),
                                      rng.uniform(-0.2, 0.2, (n, 3)),
                                      rng.normal(0, 1, (n, 1))], 1)
    anchors, boxes = anchors.astype(np.float32), boxes.astype(np.float32)
    jc = jax_coder.ResidualCoder(encode_angle_by_sincos=sincos)
    pc = port_coder.ResidualCoder(encode_angle_by_sincos=sincos)
    assert pc.code_size == jc.code_size == 7 + sincos
    enc = np.asarray(jc.encode(jnp.asarray(boxes), jnp.asarray(anchors)))
    ours = pc.encode(torch.from_numpy(boxes), torch.from_numpy(anchors))
    np.testing.assert_allclose(ours.numpy(), enc, rtol=1e-5, atol=1e-5)
    dec = np.asarray(jc.decode(jnp.asarray(enc), jnp.asarray(anchors)))
    ours = pc.decode(torch.from_numpy(enc.copy()), torch.from_numpy(anchors))
    np.testing.assert_allclose(ours.numpy(), dec, rtol=1e-6, atol=1e-5)
    # a round trip (the sin/cos form gives the heading back within a turn)
    back = ours.numpy()
    back[:, 6] += np.round((boxes[:, 6] - back[:, 6]) / (2 * np.pi)) * 2 * np.pi
    np.testing.assert_allclose(back, boxes, rtol=1e-4, atol=1e-4)


def test_direction_correction_matches_reference():
    """``generate_predicted_boxes`` on random NHWC maps (the port's NCHW):
    the flattening order, the decode and the direction-bin correction
    (limit_period, then the argmax bin's half-turn)."""
    jcfg, pcfg = common.configs("second_iou_tiny")
    from q3d_tpu.datasets import build_dataloader as jax_bl
    from q3d_tpu_torch.datasets import build_dataloader
    jhead = _jax_head(jcfg, jax_bl(jcfg.DATA_CONFIG, jcfg.CLASS_NAMES, 2,
                                   training=False)[0])
    model = build_network(pcfg.MODEL, 3, build_dataloader(
        pcfg.DATA_CONFIG, pcfg.CLASS_NAMES, 2, training=False)[0],
        device="cpu")
    rng = np.random.RandomState(5)
    na_loc, hw = 6, (16, 16)
    maps = [rng.normal(0, s, (2, *hw, na_loc * d)).astype(np.float32)
            for s, d in ((2.0, 3), (0.5, 7), (1.0, 2))]
    jcls, jbox = jhead.generate_predicted_boxes(2, *map(jnp.asarray, maps))
    cls, box = model.dense_head.generate_predicted_boxes(
        2, *(torch.from_numpy(m).permute(0, 3, 1, 2) for m in maps))
    np.testing.assert_array_equal(cls.numpy(), np.asarray(jcls))
    np.testing.assert_allclose(box.numpy(), np.asarray(jbox), rtol=1e-6,
                               atol=1e-5)
    # both direction bins chosen, the headings wrapped into their half-turns
    dirs = maps[2].reshape(2, -1, 2).argmax(-1)
    assert 0 < dirs.mean() < 1


def test_pillar_vfe_and_scatter_match_reference():
    """PillarVFE (masked points zeroed before the linear layer, still in BN
    and the max) and PointPillarScatter (padding pillars dropped) on the
    tiny config's first test batch, the reference's seeded weights with
    calibrated BN statistics: pillar features and the canvas within 1e-5
    of scale."""
    ref = common.build("pointpillar_tiny")

    def vfe_scatter(m, b):
        b = m.vfe(dict(b), False)
        return m.map_to_bev_module(b, False)
    jb = jax.jit(lambda v, b: ref["model"].apply(v, b, method=vfe_scatter))(
        ref["vars"], ref["batch"])
    model = ref["port"]
    with torch.no_grad():
        out = model.map_to_bev_module(model.vfe(dict(ref["port_batch"])))
    for key, theirs in (("pillar_features", np.asarray(jb["pillar_features"])),
                        ("spatial_features", np.asarray(
                            jb["spatial_features"]).transpose(0, 3, 1, 2))):
        ours = out[key].numpy()
        assert ours.shape == theirs.shape, key
        scale = np.abs(theirs).max()
        assert scale > 0.1
        assert np.abs(ours - theirs).max() <= 1e-5 * scale, key
    # every occupied pillar landed on the canvas, nothing else did
    occupied = (np.abs(out["spatial_features"].numpy()).sum(1) > 0).sum()
    assert occupied == int((ref["port_batch"]["voxel_num_points"] > 0).sum())


@pytest.mark.parametrize("recipe", ["second_recipe", "pointpillar_recipe"])
def test_recipes_match_reference(recipe):
    """Rules and no_list equal to the reference's for every (sq, static),
    with its signature; every rule is one the port runs; the PFN's linear
    layer has a reference path ``vfe*`` matches, and a rule for a linear
    layer is refused."""
    ours_fn, theirs_fn = getattr(port_api, recipe), getattr(jax_api, recipe)
    for sq, static in itertools.product((False, True), repeat=2):
        kw = dict(sq=sq, static=static, alpha=0.4, w_bits=8, act_bits=8)
        ours, theirs = ours_fn(**kw), theirs_fn(**kw)
        assert [dataclasses.asdict(r) for r in ours.rules] \
            == [dataclasses.asdict(r) for r in theirs.rules]
        assert ours.no_list == theirs.no_list
        for rule in ours.rules:
            for kind in rule.layer_kinds:
                port_api._check_rule(rule, "x", kind)
    import inspect
    assert inspect.signature(ours_fn) == inspect.signature(theirs_fn)
    from q3d_tpu_torch.utils.weights import reference_module_path
    assert reference_module_path("vfe.pfn_layers.0.linear") \
        == "vfe.pfn_layers_0.linear"
    assert port_api.pointpillar_recipe().lookup(
        "vfe.pfn_layers_0.linear", "linear") is None
    with pytest.raises(NotImplementedError, match="Linear"):
        port_api._check_rule(port_api.centerpoint_recipe().rules[1],
                             "vfe.pfn_layers_0.linear", "linear")


@pytest.mark.parametrize("name", ["second", "pointpillar"])
def test_kitti_state_dicts_load_strictly(name):
    """The KITTI config's ``MODEL`` at full width: the reference's variable
    tree (shapes only, ``jax.eval_shape`` at 40,000 voxels) goes through
    ``state_dict_from_jax`` and loads strictly into the port's model, every
    shape equal to the port's own."""
    jcfg, pcfg, jinfo, pinfo, vox = _kitti(name)
    v, p = int(vox.MAX_NUMBER_OF_VOXELS["test"]), int(vox.MAX_POINTS_PER_VOXEL)
    batch = {"voxels": jax.ShapeDtypeStruct((2, v, p, 4), np.float32),
             "voxel_coords": jax.ShapeDtypeStruct((2, v, 3), np.int32),
             "voxel_num_points": jax.ShapeDtypeStruct((2, v), np.int32),
             "batch_size": 2}
    jmodel = jax_build_network(jcfg.MODEL, len(jcfg.CLASS_NAMES), jinfo)
    shapes = jax.eval_shape(lambda k, b: jmodel.init(k, b, train=False),
                            jax.random.PRNGKey(0), batch)
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   flax.core.unfreeze(shapes))
    state = state_dict_from_jax(zeros)
    model = build_network(pcfg.MODEL, len(pcfg.CLASS_NAMES), pinfo,
                          device="cpu")
    own = model.state_dict()
    assert set(state) == set(own)
    for key, t in state.items():
        assert tuple(t.shape) == tuple(own[key].shape), key
    model.load_state_dict(state, strict=True)
    head = model.dense_head
    assert head.conv_cls.weight.shape[0] == 6 * 3
    assert head.conv_box.weight.shape[0] == 6 * 7
    if name == "second":
        assert len(model.backbone_3d.state_dict()) == 12 * 5  # conv + BN
        assert model.backbone_3d.conv4[0][0].padding == (0, 1, 1)
    else:
        assert model.vfe.pfn_layers[0].linear.weight.shape == (64, 10)
