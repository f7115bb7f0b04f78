"""PyTorch port vs the JAX package: the pcdet ``.pth`` import
(``utils/checkpoint.py``: ``load_pth_file``, ``import_torch_state_dict``,
``adapt_torch_tensor``), on the four cases of ``tests/test_ckpt_e2e_import.py``.

The test writes its own ``.pth``: the trained centerpoint_tiny fixture
exported by the reference's ``export_torch_state_dict`` (pcdet names, torch
layouts, spconv2 sparse weights).  Each case imports one state dict into
both packages and holds the port's against the reference's import: the
port's state dict equals the reference's import carried across by
``state_dict_from_jax`` tensor for tensor, and the port's boxes equal those
the reference's import gives (its jitted forward on test frames 0-1) within
1e-4, as the reference's own test holds its round trip, with the same
valid slots.
"""

import pickle

import jax
import numpy as np
import pytest
import torch

from q3d_tpu.utils.checkpoint import (
    import_torch_state_dict as jax_import_torch_state_dict)
from q3d_tpu.utils.pcdet_names import export_torch_state_dict

import torch_port_quant_common as common
from q3d_tpu_torch.utils.checkpoint import (import_torch_state_dict,
                                            load_pth_file)
from q3d_tpu_torch.utils.weights import state_dict_from_jax
from torch_port_jax_cache import jax_compile_cache  # noqa: F401

torch.set_num_threads(2)
FINAL = ("final_boxes", "final_scores", "final_labels", "final_valid")


@pytest.fixture(scope="module")
def setup():
    ref = common.reference_model(template=False)
    model, batch = common.port_model(ref)
    state, skipped = export_torch_state_dict(ref["variables"])
    assert not skipped
    fwd = jax.jit(lambda v, b: {k: o[k] for o in [
        ref["model"].apply(v, b, train=False)] for k in FINAL})
    imported = jax_import_torch_state_dict(state, ref["variables"],
                                           strict=True)
    boxes = {k: np.asarray(v) for k, v in fwd(imported, ref["batch"]).items()}
    return ref, model, batch, state, boxes


def _check(setup, state):
    """``state`` through both imports: equal state dicts, equal boxes."""
    ref, model, batch, _, boxes = setup
    ours = import_torch_state_dict(state, model, strict=True)
    theirs = state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, jax_import_torch_state_dict(state, ref["variables"],
                                                strict=True)))
    assert set(ours) == set(theirs)
    for key, want in theirs.items():
        assert torch.equal(ours[key], want), key
    model.load_state_dict(ours, strict=True)
    with torch.no_grad():
        out = model(dict(batch))
    np.testing.assert_array_equal(out["final_valid"].numpy(),
                                  boxes["final_valid"])
    assert boxes["final_valid"].sum() > 5
    for key in ("final_boxes", "final_scores"):
        np.testing.assert_allclose(out[key].numpy(), boxes[key], rtol=1e-4,
                                   atol=1e-4, err_msg=key)


def test_export_covers_every_tensor(setup):
    """Every tensor of the port's model is named in the export, by its own
    name, in the port's shape or the kernel's reshape of spconv2's."""
    _, model, _, state, _ = setup
    target = model.state_dict()
    assert set(target) == set(state)
    assert state["backbone_3d.conv_input.0.weight"].shape == (16, 3, 3, 3, 16)
    assert target["backbone_3d.conv_input.0.weight"].shape == (27, 16, 16)
    assert state["backbone_2d.blocks.0.1.weight"].shape \
        == tuple(target["backbone_2d.blocks.0.1.weight"].shape)


def test_pth_roundtrip_boxes_match(setup, tmp_path):
    """export -> torch.save(.pth) -> load_pth_file -> import (strict) ->
    the reference's boxes; a .pth that asks for another class is refused."""
    state = setup[3]
    path = tmp_path / "centerpoint_tiny.pth"
    torch.save({"model_state": {k: torch.from_numpy(np.asarray(v))
                                for k, v in state.items()},
                "version": "pcdet+0.6.0", "epoch": 50, "it": 0}, str(path))
    _check(setup, load_pth_file(str(path)))
    bad = tmp_path / "bad.pth"
    with open(bad, "wb") as f:
        pickle.dump({"model_state": {}, "x": pickle.PickleError()}, f)
    with pytest.raises(pickle.UnpicklingError):
        load_pth_file(str(bad))


def test_import_reference_shaped_first_conv(setup):
    """conv_input stored with the reference's 4 input channels: zero-padded
    to the port's 16 lanes."""
    state = dict(setup[3])
    w = state["backbone_3d.conv_input.0.weight"]
    state["backbone_3d.conv_input.0.weight"] = np.ascontiguousarray(w[..., :4])
    _check(setup, state)


def test_import_spconv1_layout(setup):
    """spconv 1.x's (kd, kh, kw, I, O) sparse weights."""
    state = {k: np.ascontiguousarray(np.transpose(v, (1, 2, 3, 4, 0)))
             if v.ndim == 5 else v for k, v in setup[3].items()}
    _check(setup, state)
