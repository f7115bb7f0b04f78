"""PyTorch port vs the JAX package: the int8 deploy recipe and its layers
without residency (dynamic, static, SmoothQuant).

``int8_deploy_recipe`` has the reference's signature and defaults, and gives
the reference's rules for every (sq, static, residency) combination: called
with no arguments it is dynamic per-tensor int8 without residency in both
packages.

One layer at a time, fed the same inputs as the reference's flax module:

* a dynamic int8 sparse conv (SubM 16 -> 32 with a bias, and a strided
  conv 16 -> 32), pad rows holding large values that the act amax must not
  see: the int8 features and weights equal the reference's, and the f32
  output is within 1e-6 of its largest magnitude (the rescale
  ``s_act * s_w`` is a product of two f32 numbers that XLA may associate
  otherwise).  That output exceeds 2e4 units of the rescale, so the s32 sums
  are exact: one sum off by one unit would miss by 2e-5 of it;
* a dense int8 conv (3x3 stride 2, 24 -> 40, bias) in f32 and in bf16: the
  output keeps the input's dtype; f32 within 1e-6 of its largest magnitude,
  bf16 within one bf16 step before the bias and one after it;
* a SmoothQuant int8 conv (alpha 0.5): its per-column scale comes from
  XLA's jitted ``pow``, which rounds a third of its values an ulp away
  from PyTorch's, so the scales agree within 2e-3 relative, the int8 patches
  are equal but at most 0.1% of them, each off by exactly 1, and the output
  is within 2e-3 of its largest magnitude.

Mixed recipes run: ``sq=True, residency=True`` keeps the sparse convs in
residency while the dense convs take SmoothQuant without it, and an
``extra_no_list`` keeps its layers float.  The whole model against the
reference: ``test_torch_port_deploy_model.py`` (dynamic),
``..._deploy_sq.py`` (SmoothQuant) and ``..._deploy_static.py``.  The
sparse conv, the SmoothQuant conv and the mixed recipes live in
``test_torch_port_deploy_layers.py``, so that each file keeps at most 5
tests and ``--dist loadfile`` dispatches ``test_accuracy_regression.py``
early.
"""

import dataclasses
import inspect
import itertools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from q3d_tpu.models import layers as jax_layers
from q3d_tpu.quant import api as jax_api
from q3d_tpu.quant.rules import (LayerRule as JaxLayerRule,
                                 QuantRules as JaxQuantRules,
                                 quant_rules_scope)
from q3d_tpu.quant.tensor_quant import TensorQuantizer as JaxTensorQuantizer
from tests.test_pallas_conv import _sorted_sparse

from q3d_tpu_torch.models.layers import Conv2d
from q3d_tpu_torch.quant import api as port_api
from q3d_tpu_torch.quant.rules import LayerRule, SmoothQuantCfg
from torch_port_jax_cache import jax_compile_cache  # noqa: F401

torch.set_num_threads(2)
RESCALE_RTOL = 1e-6       # the rescale's association: last bits only
SQ_SCALE_RTOL = 2e-3      # an ulp of XLA's pow
SQ_OFF_BY_ONE_SHARE = 1e-3
SQ_RTOL = 2e-3


# ---------------------------------------------------------------- recipe

@pytest.mark.parametrize("sq,static,residency",
                         list(itertools.product((False, True), repeat=3)))
def test_int8_deploy_recipe_matches_reference(sq, static, residency):
    kw = dict(sq=sq, static=static, residency=residency, alpha=0.4,
              extra_no_list=("dense_head.shared_conv",))
    ours, theirs = port_api.int8_deploy_recipe(**kw), \
        jax_api.int8_deploy_recipe(**kw)
    assert [dataclasses.asdict(r) for r in ours.rules] \
        == [dataclasses.asdict(r) for r in theirs.rules]
    assert ours.no_list == theirs.no_list
    for qf in (False, True):
        assert port_api.int8_deploy_recipe(quantize_first_conv=qf).no_list \
            == jax_api.int8_deploy_recipe(quantize_first_conv=qf).no_list
    sig = inspect.signature
    assert sig(port_api.int8_deploy_recipe) == sig(jax_api.int8_deploy_recipe)
    # every rule of the recipe is one the port runs
    for rule in ours.rules:
        for kind in rule.layer_kinds:
            port_api._check_rule(rule, "x", kind)


def test_int8_deploy_default_is_dynamic_without_residency():
    for api in (port_api, jax_api):
        for rule in api.int8_deploy_recipe().rules:
            assert rule.deploy_int8 and not rule.int8_residency
            assert rule.act.dynamic and rule.act.axis is None
            assert rule.smoothquant is None


# ----------------------------------------------------- one sparse layer

def _sparse_input(seed, cin):
    """A sorted sparse tensor (batch 2) whose pad rows hold large values."""
    st, _ = _sorted_sparse(np.random.RandomState(seed), 2, (4, 10, 16), 300,
                           cin, 384)
    valid = np.asarray(st.indices[:, 0] >= 0)
    feats = np.array(st.features) * 3.0
    feats[~valid] = 50.0
    return st.replace(features=jnp.asarray(feats)), valid


# ------------------------------------------------------ one dense layer

def _dense_inputs(seed):
    rng = np.random.RandomState(seed)
    return [np.maximum(rng.randn(2, 21, 19, 24), 0).astype(np.float32) * s
            for s in (1.0, 2.5)]


def _dense_pair(jrule, rule, x_nhwc):
    """The flax Conv2d (40 out, 3x3, stride 2, bias 0.3) and the port's on
    the same weights -> (reference NHWC output, the input and output of each
    of its quantizers by name, port NCHW module)."""
    jmod = jax_layers.Conv2d(40, 3, 2, 1, bias_init=0.3)
    with quant_rules_scope(JaxQuantRules(rules=(jrule,))):
        v = jmod.init(jax.random.PRNGKey(4), jnp.asarray(x_nhwc))

        def apply(v_, x):
            seen = {}

            def record(f, args, kwargs, ctx):
                out = f(*args, **kwargs)
                if isinstance(ctx.module, JaxTensorQuantizer) \
                        and ctx.method_name == "__call__":
                    seen[ctx.module.name] = (args[0], out)
                return out
            with fnn.intercept_methods(record):
                return jmod.apply(v_, x), seen
        want, seen = jax.jit(apply)(v, jnp.asarray(x_nhwc))
    mod = Conv2d(24, 40, 3, 2, 1)
    mod.weight.data = torch.from_numpy(
        np.array(v["params"]["kernel"]).transpose(3, 2, 0, 1).copy())
    mod.bias.data = torch.from_numpy(np.array(v["params"]["bias"]))
    mod.rule = rule
    mod.calibrating = True
    with torch.no_grad():
        mod(torch.from_numpy(x_nhwc.transpose(0, 3, 1, 2).copy()))
    mod.calibrating = False
    return want, seen, mod


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dynamic_int8_dense_conv_matches_reference(dtype):
    x = _dense_inputs(5)[1]
    jx = jnp.asarray(x).astype(dtype)
    want, _, mod = _dense_pair(JaxLayerRule(("conv2d",), deploy_int8=True),
                            LayerRule(("conv2d",), deploy_int8=True),
                            np.asarray(jx.astype(jnp.float32)))
    if dtype == "bfloat16":
        jmod = jax_layers.Conv2d(40, 3, 2, 1, bias_init=0.3)
        with quant_rules_scope(JaxQuantRules(rules=(
                JaxLayerRule(("conv2d",), deploy_int8=True),))):
            v = jmod.init(jax.random.PRNGKey(4), jx)
            want = jax.jit(jmod.apply)(v, jx)
    px = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).to(getattr(
        torch, dtype))
    with torch.no_grad():
        got = mod(px)
    assert got.dtype == px.dtype and str(want.dtype) == dtype
    got = got.float().permute(0, 2, 3, 1).numpy()
    want = np.asarray(want.astype(jnp.float32))
    assert np.abs(want).max() > 1.0
    if dtype == "float32":
        assert np.abs(got - want).max() <= RESCALE_RTOL * np.abs(want).max()
    else:
        # the f32 results agree to the last bits; each is rounded to bf16
        # before the bias (a step of at most 2^-7 of |want| + |bias|) and
        # after it (2^-7 of |want|)
        bias = np.abs(mod.bias.detach().numpy())
        assert (np.abs(got - want)
                <= 2.0 ** -7 * (2 * np.abs(want) + bias) + 1e-6).all()


# ---------------------------------------------------- the rules' checks

def test_unported_deploy_rules_raise():
    sq = SmoothQuantCfg()
    for kind in ("subm_conv3d", "subm_conv2d", "sparse_conv2d"):
        with pytest.raises(NotImplementedError, match="int8 sparse conv"):
            port_api._check_rule(LayerRule((kind,), deploy_int8=True,
                                           smoothquant=sq), "x", kind)
    for kw, msg in ((dict(int8_residency=True), "static"),
                    (dict(int8_residency=True, smoothquant=sq), "static"),
                    (dict(act=port_api.QuantSpec(8, axis=1)), "per-tensor"),
                    (dict(act=port_api.QuantSpec(8, group_size=4)), "group")):
        with pytest.raises(ValueError, match=msg):
            port_api._check_rule(LayerRule(("conv2d",), deploy_int8=True, **kw),
                                 "x", "conv2d")


# ------------------------------------------------------- mixed recipes

def _port_tiny():
    """The port's centerpoint_tiny with the trained fixture, on the CPU,
    and its first test batch."""
    from q3d_tpu_torch.config import cfg_from_yaml_file, EDict
    from q3d_tpu_torch.datasets import build_dataloader
    from q3d_tpu_torch.models import build_network, load_data_to_device
    from q3d_tpu_torch.utils.checkpoint import load_flax_checkpoint
    from q3d_tpu_torch.utils.weights import state_dict_from_jax
    from test_torch_port_centerpoint import CFG_DIR, CKPT

    cfg = cfg_from_yaml_file(str(CFG_DIR / "centerpoint_tiny.yaml"), EDict())
    ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                     batch_size=2, training=False)
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), ds, device="cpu")
    model.load_state_dict(state_dict_from_jax(
        load_flax_checkpoint(str(CKPT))[0]), strict=True)
    return model, load_data_to_device(next(iter(loader)), device="cpu")
