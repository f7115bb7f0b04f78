"""The port's int8 deploy path, entry recipe (``prepare_int8_deploy``
with no recipe kwargs, as ``test_torch_port_quant_entry.py``): the head's
shared map is quantized once and its hidden branch convs run int8 (moved
out of that file so that each file keeps at most 5 tests and ``--dist
loadfile`` dispatches ``test_accuracy_regression.py`` early).

The test reads which of the head's layers run int8, which the rules
decide and the calibrated scales do not, so its fixture is the port's own
calibration of the trained tiny fixture (read without JAX), not that
file's, which also calibrates the reference (~200 s of CPU) and loads its
scales.
"""

import pytest
import torch

from q3d_tpu_torch.quant import api as port_quant
from q3d_tpu_torch.utils.checkpoint import load_flax_checkpoint
from q3d_tpu_torch.utils.weights import state_dict_from_jax

import torch_port_quant_common as common
from test_torch_port_centerpoint import CKPT
from torch_port_jax_cache import jax_compile_cache  # noqa: F401

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def with_ref_amax():
    """(None, the port's centerpoint_tiny with the trained weights under
    the entry recipe, calibrated by ``prepare_int8_deploy`` on its first
    test batch given twice, that batch)."""
    model, batch = common.port_model(
        {"float": load_flax_checkpoint(str(CKPT))[0]})
    port_quant.prepare_int8_deploy(model, [batch, batch])
    return None, model, batch


def test_head_runs_int8(with_ref_amax):
    """The head's shared map is quantized once and its hidden branch convs
    take it as int8; the heatmap branch (excluded) dequantizes it."""
    _, model, _ = with_ref_amax
    head = model.dense_head
    assert head.shared_requant.residency and head.shared_conv[0].residency
    for branches in head.heads_list:
        for name in branches.names:
            hidden = getattr(branches, name)[0][0]
            assert (hidden.rule is None) == (name == "hm"), name
