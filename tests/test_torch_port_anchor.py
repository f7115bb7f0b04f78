"""PyTorch port vs the JAX package: the anchor heads' parts, cheaply.

The anchors of the tiny and the KITTI configs (exactly equal),
``ResidualCoder`` and the direction-bin correction (within 1e-6 of scale),
PillarVFE and PointPillarScatter alone (within 1e-5 of scale), the SECOND
and PointPillars recipes (rules equal for every ``(sq, static)``), and the
KITTI configs' full-width variable trees (``jax.eval_shape``), which load
strictly into the port's SECONDNet and PointPillar with every shape equal.
The direction correction, PillarVFE + scatter and the KITTI trees live in
``test_torch_port_anchor_vfe.py``, so that each file keeps at most 5 tests
and ``--dist loadfile`` dispatches ``test_accuracy_regression.py`` early.
"""

import dataclasses
import itertools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from q3d_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
from q3d_tpu.config import EDict as JaxEDict
from q3d_tpu.models import build_network as jax_build_network
from q3d_tpu.models.detectors.detector3d_template import (
    DatasetInfo as JaxDatasetInfo)
from q3d_tpu.quant import api as jax_api

import torch_port_anchor_common as common
from q3d_tpu_torch.config import cfg_from_yaml_file, EDict
from q3d_tpu_torch.models import build_network
from q3d_tpu_torch.models.detectors.detector3d_template import DatasetInfo
from q3d_tpu_torch.quant import api as port_api
from torch_port_jax_cache import jax_compile_cache  # noqa: F401

torch.set_num_threads(2)

TESTS = Path(__file__).resolve().parent
KITTI = TESTS.parent / "tools" / "cfgs" / \
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


@pytest.fixture(scope="module")
def coder_cases(tmp_path_factory):
    """Both coders' outputs for both forms, from one fresh interpreter
    (``torch_port_coder_case.py``) -> {sincos: npz path}."""
    out = tmp_path_factory.mktemp("coder")
    subprocess.run([sys.executable, str(TESTS / "torch_port_coder_case.py"),
                    str(out)], check=True, cwd=TESTS.parent,
                   env={**os.environ, "JAX_PLATFORMS": "cpu"})
    return {sincos: out / f"coder_{sincos}.npz" for sincos in (False, True)}


@pytest.mark.parametrize("sincos", [False, True])
def test_residual_coder_matches_reference(sincos, coder_cases):
    """Encode within 1e-5, decode of the reference's encoding within 1e-6
    relative + 1e-5, and the round trip within 1e-4.  Both coders run in a
    fresh interpreter: the [False] case failed once in a 4-worker run after
    other files (encode 3e-4 relative apart) and never again, though its
    inputs come from a local ``RandomState`` and its arithmetic measured
    the same for torch's 1, 2, 3 and 8 threads (the worst element at 0.7% of
    the tolerance); whatever state a file left in the worker, it cannot
    reach this comparison."""
    r = np.load(coder_cases[sincos])
    assert list(r["sizes"]) == [7 + sincos] * 2
    np.testing.assert_allclose(r["ours"], r["enc"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(r["ours_dec"], r["dec"], rtol=1e-6,
                               atol=1e-5)
    # a round trip (the sin/cos form gives the heading back within a turn)
    back, boxes = r["ours_dec"].copy(), r["boxes"]
    back[:, 6] += np.round((boxes[:, 6] - back[:, 6]) / (2 * np.pi)) * 2 * np.pi
    np.testing.assert_allclose(back, boxes, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("recipe", ["second_recipe", "pointpillar_recipe"])
def test_recipes_match_reference(recipe):
    """Rules and no_list equal to the reference's for every (sq, static),
    with its signature; every rule is one the port runs; the PFN's linear
    layer has a reference path ``vfe*`` matches; a fake-quant rule for a
    linear layer runs (TransFusion's decoder), an int8 deploy one is
    refused, as the reference has no int8 path for it."""
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
    port_api._check_rule(port_api.centerpoint_recipe().rules[1],
                         "vfe.pfn_layers_0.linear", "linear")
    with pytest.raises(NotImplementedError, match="no int8 deploy"):
        port_api._check_rule(port_api.int8_deploy_recipe().rules[1],
                             "vfe.pfn_layers_0.linear", "linear")
