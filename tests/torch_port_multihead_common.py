"""Shared body of the SECOND-MultiHead parity tests
(``test_torch_port_multihead*.py``): both packages on one small model made
from ``tools/cfgs/lyft_models/cbgs_second_multihead.yaml``.

The Lyft yaml as each package's reader gives it, with its 9 classes, their
anchors and thresholds, the 5 head groups, the shared conv, the sin/cos
box coder, the loss weights and the multi-class NMS as written; cut to a
small grid and narrow widths by ``lyft_synthetic.small_config`` (+-16 m,
1,800 anchors a frame, NMS_PRE_MAXSIZE 256).  The scenes are
the port's synthetic ones with the yaml's five point features (x, y, z,
intensity and a zero timestamp); the reference takes the port's numpy
batch, since its dataset has no timestamp column.  Weights: the
reference's seeded tree (``torch_port_anchor_common``); for inference BN
statistics calibrated on the batch and written back to both sides and
every tower's conv_cls bias 0 (the initialiser's -log 99 otherwise leaves
every score under SCORE_THRESH on random weights), for training the
initialisers' -log 99.

The reference fills the class channels a tower does not predict with a
logit of 0, and reads the box coder's config from where the yaml does not
put it (``ROADMAP.md`` §3); ``patched_fill`` makes it fill them as the
port does, and ``coder_at_head_level`` gives it the yaml's coder, in the
tests only.
"""

import contextlib
import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from q3d_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
from q3d_tpu.config import EDict as JaxEDict
from q3d_tpu.models import build_network as jax_build_network
from q3d_tpu.models import layers as jax_layers
from q3d_tpu.models import load_data_to_device as jax_load_data_to_device
from q3d_tpu.models.dense_heads import anchor_head_multi as jax_multi
from q3d_tpu.models.detectors.detector3d_template import (
    DatasetInfo as JaxDatasetInfo)
from q3d_tpu.ops.spconv import modules as jax_spmodules
from q3d_tpu.quant.rules import quant_rules_scope

from q3d_tpu_torch.config import cfg_from_yaml_file, EDict
from q3d_tpu_torch.datasets import build_dataloader
from q3d_tpu_torch.datasets.lyft_synthetic import (LYFT_CFG, SCENE_CLASSES,
                                                  small_config)
from q3d_tpu_torch.models import build_network, load_data_to_device
from q3d_tpu_torch.models.dense_heads.anchor_head_multi import ABSENT_LOGIT
from q3d_tpu_torch.models.detectors.detector3d_template import DatasetInfo
from q3d_tpu_torch.utils.bn_calibration import calibrate_bns
from q3d_tpu_torch.utils.weights import state_dict_from_jax

import torch_port_anchor_common as anchor_common
import torch_port_quant_common as quant_common

OUT_KEYS = anchor_common.OUT_KEYS

def coder_at_head_level(jcfg):
    """The reference reads its anchor head's box coder from the head's own
    level, where the Lyft yaml (as OpenPCDet's) has none: it lies in
    TARGET_ASSIGNER_CONFIG, which the port reads (``ROADMAP.md`` §3).
    Copied up, the reference builds the yaml's sin/cos coder (code size 8)
    too."""
    head = jcfg.MODEL.DENSE_HEAD
    for key in ("BOX_CODER", "BOX_CODER_CONFIG"):
        head[key] = head.TARGET_ASSIGNER_CONFIG[key]
    return jcfg


def configs(frames=4, seed=1234):
    """Both packages' small configs, each read by its own reader (the
    reference's box coder copied to where it reads it)."""
    return (coder_at_head_level(small_config(jax_cfg_from_yaml(
                str(LYFT_CFG), JaxEDict()), frames, seed)),
            small_config(cfg_from_yaml_file(str(LYFT_CFG), EDict()), frames,
                         seed))


def data(cfg, batch_size=2, training=False, seed=0):
    """The port's small dataset (the scenes' class names, ids 1-3) and one
    numpy batch -> (geometry dict, numpy batch)."""
    np.random.seed(seed)
    ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, list(SCENE_CLASSES),
                                     batch_size=batch_size, training=training,
                                     seed=seed)
    geo = dict(class_names=tuple(cfg.CLASS_NAMES),
               num_point_features=int(
                   ds.point_feature_encoder.num_point_features),
               grid_size=tuple(int(g) for g in ds.grid_size),
               point_cloud_range=tuple(float(v)
                                       for v in ds.point_cloud_range),
               voxel_size=tuple(float(v) for v in ds.voxel_size))
    return geo, next(iter(loader))


def jax_batch(raw):
    return jax_load_data_to_device({k: v for k, v in raw.items()
                                    if k != "frame_id"})


def build(batch_size=2, training=False):
    """-> dict: the reference's model, batch and seeded variables (BN
    statistics calibrated unless ``training``), the port's model holding
    the same variables and its batch, both configs and the numpy batch."""
    jcfg, pcfg = configs()
    geo, raw = data(pcfg, batch_size, training)
    assert geo["num_point_features"] == 5
    jmodel = jax_build_network(jcfg.MODEL, len(jcfg.CLASS_NAMES),
                               JaxDatasetInfo(**geo))
    jb = jax_batch(raw)
    variables = anchor_common._seeded_variables(jax.eval_shape(
        lambda k, b: jmodel.init(k, b, train=False), jax.random.PRNGKey(0),
        jb))
    if training:
        # both initialisers' prior: a zero bias behind a dead ReLU would give
        # a logit of exactly 0, where the focal loss's stable BCE has no
        # derivative and the reference takes another than the true one
        # (ROADMAP.md §3)
        variables = with_cls_bias(variables, -np.log(99.0))
    model = build_network(pcfg.MODEL, len(pcfg.CLASS_NAMES),
                          DatasetInfo(**geo), device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    batch = load_data_to_device(raw, device="cpu")
    if not training:
        with torch.no_grad():
            for head in model.dense_head.heads:
                head.conv_cls.bias.zero_()
            for g in range(len(model.dense_head.heads)):
                variables["params"]["dense_head"][f"heads_{g}"]["conv_cls"][
                    "bias"][...] = 0.0
        calibrate_bns(model, batch)
        anchor_common._set_leaves(variables, model.state_dict())
    return {"model": jmodel, "batch": jb, "vars": variables, "port": model,
            "port_batch": batch, "cfg": pcfg, "jcfg": jcfg, "raw": raw}


@contextlib.contextmanager
def patched_fill():
    """The reference's head fills a tower's absent class channels with
    ABSENT_LOGIT, as the port's, instead of 0 (its ``jnp.zeros``, its only
    call of it), for the duration."""
    fake = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                    if not k.startswith("__")})
    fake.zeros = lambda shape, dtype=None: jnp.full(shape, ABSENT_LOGIT,
                                                    dtype)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax_multi, "jnp", fake)
        yield


def reference_forward(ref, rules=None, variables=None):
    """One jitted reference forward -> (outputs, {path: (input, output)} of
    every sparse and dense conv)."""
    recorded = (jax_spmodules.SubMConv3d, jax_spmodules.SparseConv3d,
                jax_layers.Conv2d)

    def apply(v, b):
        store = {}
        with quant_rules_scope(rules), fnn.intercept_methods(
                quant_common._record(store, recorded)):
            out = ref["model"].apply(v, b, train=False)
        return {k: out[k] for k in OUT_KEYS}, store

    out, store = jax.jit(apply)(variables or ref["vars"], ref["batch"])
    layers = {p: (quant_common._arrays(i), quant_common._arrays(o))
              for p, (i, o) in store.items()}
    return {k: np.asarray(v) for k, v in out.items()}, layers


def port_forward(fn, batch, record=(), modules=None):
    """``fn`` (a detector, or any function of a batch dict over the modules
    of ``modules``) on ``batch`` -> (outputs as numpy, {module name: output
    NHWC} of the modules of ``modules`` (default ``fn``) named in
    ``record``)."""
    store, hooks = {}, []
    for name, mod in (modules or fn).named_modules():
        if name in record:
            hooks.append(mod.register_forward_hook(
                lambda m, a, o, name=name: store.__setitem__(
                    name, o.detach().permute(0, 2, 3, 1).float().numpy())))
    try:
        with torch.no_grad():
            out = fn(dict(batch))
    finally:
        for h in hooks:
            h.remove()
    return {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
            for k, v in out.items() if isinstance(v, torch.Tensor)}, store


def idle_box_convs(model, gt_boxes):
    """The towers' conv_box modules none of whose classes the gt boxes hold
    (ids 1-3 only in these scenes): their regression loss has no term, so
    their gradient is exactly 0 -> set of module names."""
    present = {int(c) - 1 for c in np.unique(np.asarray(gt_boxes)[..., 7])
               if c > 0}
    return {f"dense_head.heads.{g}.conv_box"
            for g, (ids, _) in enumerate(model.dense_head.groups)
            if not present & set(ids)}


def with_cls_bias(variables, bias):
    """A copy of the reference's variables with every tower's conv_cls bias
    set to ``bias``."""
    out = jax.tree_util.tree_map(np.array, variables)
    for name, tower in out["params"]["dense_head"].items():
        if name.startswith("heads_"):
            tower["conv_cls"]["bias"][...] = bias
    return out
