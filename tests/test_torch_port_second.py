"""PyTorch port vs the JAX package: SECOND, tiny (``second_iou_tiny.yaml``
with ``MODEL.NAME = SECONDNet`` and its ROI head removed), f32, batch 2.

MeanVFE -> VoxelBackBone8x (12 sparse convs) -> HeightCompression ->
BaseBEVBackbone -> AnchorHeadSingle -> post_processing, on the reference's
seeded weights with BN statistics and the cls bias set as
``torch_port_anchor_common`` describes.  Tolerances: every map within 1e-5
of its largest magnitude, the decoded per-anchor boxes within 1e-4 (+1e-5
relative), the detections slot for slot (boxes as those, scores 1e-5).  Under
``second_recipe()`` (dynamic SmoothQuant fake-quant) each conv fed the
reference's input agrees within 2e-6 of its scale (sparse and float convs)
or 2e-3 (the SmoothQuant BEV convs: XLA's jitted ``pow`` rounds some column
scales an ulp away), and the quantized model's head and
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
def second():
    ref = common.build("second_iou_tiny")
    jout, jmaps, _ = common.reference_forward(ref)
    out = common.port_forward(ref["port"], ref["port_batch"])
    return ref, jout, jmaps, out


@pytest.fixture(scope="module")
def second_recipe(second):
    ref = second[0]
    return common.quantized(ref, port_api.second_recipe(),
                            jax_api.second_recipe())


def test_second_maps_match_reference(second):
    _, jout, jmaps, out = second
    common.check_maps(out, jout, jmaps)


def test_second_decoded_boxes_match_reference(second):
    _, jout, _, out = second
    common.check_decoded(out, jout)


def test_second_detections_match_reference(second):
    _, jout, _, out = second
    common.check_detections(out, jout)


def test_second_recipe_layers(second_recipe):
    """12 sparse convs (conv_input float), 6 BEV convs (SmoothQuant) and the
    head's 3 float convs, each fed the reference's input."""
    _, layers, model = second_recipe
    assert common.check_quantized_layers(model, layers, 12 + 6 + 3,
                                         2e-6, 2e-3) == 11 + 6


def test_second_recipe_detections(second_recipe):
    """The quantized model's head and post-processing on the reference's
    quantized BEV map: the reference's detections, slot for slot."""
    jout, _, model = second_recipe
    common.check_detections(common.recipe_detections(model, jout), jout)
