"""PyTorch port vs the JAX package: the whole model under
``int8_deploy_recipe(sq=True)``, what ``tools/quant/quant_driver.py
--deploy_int8`` runs by default: the sparse convs dynamic int8 as in
``test_torch_port_deploy_model.py``, and every quantized dense conv (the 6
BEV convs, the head's shared conv and its 8 hidden regression convs) a
SmoothQuant int8 conv: the float im2col, the per-column scale
max(act_amax^0.5 / w_amax^0.5, 1e-5) from the batch, the patches quantized
per tensor, the scaled weight per output channel, an s8 GEMM with s32 sums.

XLA's jitted ``pow`` rounds some of the column scales an ulp away from
PyTorch's, and an ulp in a scale can move a patch across a rounding boundary
of its int8 quantization.  On centerpoint_tiny with the trained fixture,
batch 2, each SmoothQuant conv fed the reference's own input is held:

* column scales within 2e-3 relative (measured 2.5e-7, a few ulps);
* int8 patches equal but at most 0.1% of them, each off by exactly 1
  (measured: 2 of 3.4 million, in two head convs);
* act scale within 2e-3 relative (measured 1.2e-7);
* output within 2e-3 of its largest magnitude (measured 1.3e-3 where a
  patch flips, 2e-7 elsewhere); the other convs within 1e-6.

End to end, a flipped patch moves a few detections: spatial_features
within 1e-6 (the sparse side is exact), the same valid slots and labels,
and every reference detection matched by label with its box within 0.03
and its score within 2e-3 (measured 0.015 and 2.7e-4).
"""

import numpy as np
import pytest
import torch

import torch_port_quant_common as common
from q3d_tpu.quant.tensor_quant import TensorQuantizer as JaxTensorQuantizer
from q3d_tpu_torch.models.layers import Conv2d
from q3d_tpu_torch.utils.weights import reference_module_path
from torch_port_jax_cache import jax_compile_cache  # noqa: F401

torch.set_num_threads(2)
RECIPE = dict(sq=True)
SCALE_RTOL = 2e-3
OFF_BY_ONE_SHARE = 1e-3
SQ_RTOL = 2e-3
LAYER_RTOL = 1e-6


@pytest.fixture(scope="module")
def setup():
    ref = common.reference_dynamic(RECIPE, extra=(JaxTensorQuantizer,))
    model, batch = common.port_dynamic(ref, RECIPE)
    return ref, model, batch


def test_smoothquant_convs_fed_reference_inputs(setup):
    ref, model, _ = setup
    layers = ref["layers"]
    sq = [(n, m) for n, m in model.named_modules()
          if isinstance(m, Conv2d) and m.rule is not None]
    assert len(sq) == 6 + 1 + 2 * 4
    flips = 0
    for name, conv in sq:
        path = reference_module_path(name)
        assert conv.rule.smoothquant is not None and not conv.residency, path
        seen = {}
        hooks = [getattr(conv, q).register_forward_hook(
            lambda m, a, o, q=q: seen.__setitem__(q, (a[0], o)))
            for q in ("act_quant", "weight_quant")]
        with torch.no_grad():
            conv(common._dense(layers[path][0]))
        for h in hooks:
            h.remove()
        w2d = conv.weight.detach().reshape(conv.weight.shape[0], -1).t()
        nz = (w2d != 0).numpy()
        scale_p = seen["weight_quant"][0].numpy()[nz] / w2d.numpy()[nz]
        scale_j = layers[f"{path}.weight_quant"][0][nz] / w2d.numpy()[nz]
        assert np.abs(scale_p - scale_j).max() \
            <= SCALE_RTOL * np.abs(scale_j).max(), path
        (pq, ps), (jq, js) = seen["act_quant"][1], layers[f"{path}.act_quant"][1]
        diff = np.abs(pq.numpy().reshape(-1).astype(np.int32)
                      - jq.reshape(-1).astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() <= OFF_BY_ONE_SHARE, \
            (path, int(diff.max()), float((diff > 0).mean()))
        flips += int((diff > 0).sum())
        assert float(ps) == pytest.approx(float(js), rel=SCALE_RTOL), path
    report = common.check_conv_layers(model, ref, expected=48,
                                      sparse_rtol=LAYER_RTOL,
                                      dense_rtol=SQ_RTOL)
    exact = [p for p, err in report.items() if err > LAYER_RTOL]
    # a conv off by more than the float tolerance is one whose patches flip
    assert (len(exact) > 0) == (flips > 0), (exact, flips)


def test_end_to_end(setup):
    ref, model, batch = setup
    with torch.no_grad():
        out = model(dict(batch))
    jout = ref["out"]
    sf = out["spatial_features"].numpy()
    jsf = jout["spatial_features"].transpose(0, 3, 1, 2)
    assert np.abs(sf - jsf).max() <= LAYER_RTOL * np.abs(jsf).max()
    ours = {k: v.numpy() for k, v in out.items() if k.startswith("final_")}
    np.testing.assert_array_equal(ours["final_valid"], jout["final_valid"])
    assert jout["final_valid"].sum() > 5
    common.check_detections_matched(ours, jout, box_tol=0.03, score_tol=2e-3)
