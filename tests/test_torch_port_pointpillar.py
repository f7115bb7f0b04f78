"""PyTorch port vs the JAX package: PointPillars, tiny
(``pointpillar_tiny.yaml``), f32, batch 2.

PillarVFE -> PointPillarScatter -> BaseBEVBackbone -> AnchorHeadSingle ->
post_processing (K = 1024 NMS candidates), on the reference's seeded
weights with BN statistics and the cls bias set as
``torch_port_anchor_common`` describes.  Tolerances: every map within 1e-5
of its largest magnitude, the decoded per-anchor boxes within 1e-4 (+1e-5
relative), the detections slot for slot.  Under ``pointpillar_recipe()``
(dynamic SmoothQuant fake-quant; the VFE and the head's output convs stay
float) each BEV conv fed the reference's input agrees within 2e-3 of its
scale, each float conv within 2e-6, and the quantized model's head and
post-processing on the reference's quantized BEV map give the reference's
detections slot for slot (``torch_port_anchor_common.recipe_detections``
says why not end to end).
"""

import pytest
import torch

from q3d_tpu.quant import api as jax_api

import torch_port_anchor_common as common
from q3d_tpu_torch.quant import api as port_api
from torch_port_jax_cache import jax_compile_cache  # noqa: F401

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pointpillar():
    ref = common.build("pointpillar_tiny")
    jout, jmaps, _ = common.reference_forward(ref)
    out = common.port_forward(ref["port"], ref["port_batch"])
    return ref, jout, jmaps, out


@pytest.fixture(scope="module")
def pointpillar_recipe(pointpillar):
    return common.quantized(pointpillar[0], port_api.pointpillar_recipe(),
                            jax_api.pointpillar_recipe())


def test_pointpillar_maps_match_reference(pointpillar):
    _, jout, jmaps, out = pointpillar
    common.check_maps(out, jout, jmaps)


def test_pointpillar_decoded_boxes_match_reference(pointpillar):
    _, jout, _, out = pointpillar
    common.check_decoded(out, jout)


def test_pointpillar_detections_match_reference(pointpillar):
    _, jout, _, out = pointpillar
    common.check_detections(out, jout)


def test_pointpillar_recipe_layers(pointpillar_recipe):
    """6 BEV convs (SmoothQuant) and the head's 3 float convs, each fed the
    reference's input; the VFE's linear layer stays float (``vfe*``)."""
    _, layers, model = pointpillar_recipe
    assert model.vfe.pfn_layers[0].linear.rule is None
    assert common.check_quantized_layers(model, layers, 6 + 3,
                                         2e-6, 2e-3) == 6


def test_pointpillar_recipe_detections(pointpillar_recipe):
    """The quantized model's head and post-processing on the reference's
    quantized BEV map: the reference's detections, slot for slot."""
    jout, _, model = pointpillar_recipe
    common.check_detections(common.recipe_detections(model, jout), jout)
