"""PyTorch port vs the JAX package: PillarVFE + scatter on the tiny
PointPillars, the KITTI configs' trees loading strictly into the
full-width port models, and the direction correction (moved out of
``test_torch_port_anchor.py`` so that each file keeps at most 5 tests and
``--dist loadfile`` dispatches ``test_accuracy_regression.py`` early).
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from q3d_tpu.models import build_network as jax_build_network

import torch_port_anchor_common as common
from q3d_tpu_torch.models import build_network
from q3d_tpu_torch.utils.weights import state_dict_from_jax

from test_torch_port_anchor import _jax_head, _kitti
from torch_port_jax_cache import jax_compile_cache  # noqa: F401

torch.set_num_threads(2)


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
