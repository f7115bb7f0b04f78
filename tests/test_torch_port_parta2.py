"""PyTorch port vs the JAX package: PartA2, tiny (``parta2_tiny.yaml``),
f32, batch 2, on the reference's seeded weights with every BN's statistics
set from the batch (``torch_port_anchor_common.build``).

* ``SparseInverseConv3d``: its book equal, integer for integer, to the
  reference's ``inverse_conv_indices`` (the reference's own
  ``tests/test_spconv.py`` case and both UNet paddings), as the transpose
  of the strided conv's cached book and as the rule; without that book
  cached the conv raises; its f32
  output and its input gradient (kernel 1's plain version over the
  strided conv's book) within 1e-5 of the reference's and ``jax.grad``'s
  largest magnitude;
* ``roiaware_pool3d`` on rotated rois: MAX exactly equal, AVG within 1e-6,
  on one frame; the reference's pooling fault pinned (below);
* each module fed the reference's own input: UNetV2's ``point_features``
  and stride-8 tensor within 1e-5 of their scale (indices equal), the
  part head's scores and offsets and PartA2FCHead's outputs within
  ``LAYER_RTOL``;
* the whole forward: the rois the same keep set (valid flags and labels
  equal, boxes within 1e-4 + 1e-5 of their magnitude, as
  ``torch_port_anchor_common`` holds decoded boxes: seeded boxes run to
  ~55 m a side), the final boxes within 1e-3 and the scores
  within 1e-4, slot for slot; and the weights: every variable of the tiny
  model carried by ``state_dict_from_jax``, none left over on either side.

The reference pools each frame's rois over every row of the batch, the
other frames' features zeroed (``parta2_head.py:60-70``), so its AVG pool
of the part features divides by a count that takes in the other frames'
points and the padded rows inside the roi; the port pools each frame's own
points, as OpenPCDet does.  Pinned on the unpatched reference
(``test_reference_avg_pool_fault_pinned``); elsewhere its AVG pool is
patched in the test only to each frame's own rows
(``own_frame_avg_pool``).
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from q3d_tpu.models.roi_heads import PartA2FCHead as JaxPartA2FCHead
from q3d_tpu.models.roi_heads import parta2_head as jax_parta2
from q3d_tpu.ops.roiaware_pool3d import roiaware_pool3d as jax_pool
from q3d_tpu.ops.spconv import SparseConvTensor as JaxSparseConvTensor
from q3d_tpu.ops.spconv import engine as jax_engine

import torch_port_anchor_common as common
from test_spconv import _random_sparse
from test_torch_port_pvrcnn import (BOX_TOL, LAYER_RTOL, ROI_TOL, ROIS,
                                    SCORE_TOL, _rel, _t, rois_final_checks)
from q3d_tpu_torch.ops.roiaware_pool3d import roiaware_pool3d
from q3d_tpu_torch.ops.spconv import (SparseConv3d, SparseConvTensor,
                                      SparseInverseConv3d)
from q3d_tpu_torch.ops.spconv import engine
from q3d_tpu_torch.ops.spconv.modules import inverse_cache_key
from q3d_tpu_torch.utils.weights import state_dict_from_jax
from torch_port_jax_cache import jax_compile_cache  # noqa: F401

torch.set_num_threads(2)
OP_RTOL = 1e-5
POINT_KEYS = ("point_features", "point_coords", "point_cls_scores",
              "point_part_offset")
KEPT = ("final_boxes", "final_scores", "final_labels", "final_valid") \
    + ROIS + POINT_KEYS + ("spatial_features",)
HEAD_IN = ROIS + POINT_KEYS


def own_frame_avg_pool(monkeypatch):
    """The reference's AVG pool over each frame's own rows, in the test
    only.  Its ``pool_one`` hands the pool every row with the other
    frames' and the padded rows' part features zeroed; a frame's own rows
    are those whose seg score (the last column, a sigmoid) is not 0, and
    the others are moved out of every roi."""
    real = jax_parta2.roiaware_pool3d

    def pool(rois, points, feats, out_size, pool_method="max", **kw):
        if pool_method == "avg":
            points = jnp.where((feats[:, -1] != 0)[:, None], points, 1e9)
        return real(rois, points, feats, out_size, pool_method=pool_method,
                    **kw)
    monkeypatch.setattr(jax_parta2, "roiaware_pool3d", pool)


def reference_forward(r):
    """One jitted reference forward: the outputs, the stride-8 tensor and
    the ROI head's ``cls_out``."""
    def apply(v, b):
        out, state = r["model"].apply(
            v, b, train=False,
            capture_intermediates=lambda m, n: m.name == "cls_out")
        enc = out["encoded_spconv_tensor"]
        return ({k: out[k] for k in KEPT}, (enc.features, enc.indices),
                state["intermediates"]["roi_head"]["cls_out"]["__call__"][0])
    out, enc, cls_out = jax.jit(apply)(r["vars"], r["batch"])
    return ({k: np.asarray(v) for k, v in out.items()},
            tuple(np.asarray(a) for a in enc), np.asarray(cls_out))


@pytest.fixture(scope="module")
def ref():
    with pytest.MonkeyPatch.context() as mp:
        own_frame_avg_pool(mp)
        r = common.build("parta2_tiny")
        r["out"], r["enc"], r["cls_out"] = reference_forward(r)
    return r


def test_inverse_conv_matches_reference():
    """The book (the transpose of the strided conv's, and the rule) equal
    to the reference's; the f32 output and the input gradient within 1e-5
    of the reference's (``jax.grad``); a cache without the strided conv's
    book raises."""
    rng = np.random.RandomState(13)
    spatial, cin, cout = (6, 8, 8), 16, 32
    for padding in (1, (0, 1, 1)):
        st, _ = _random_sparse(rng, 2, spatial, 40, cin, capacity=96)
        out_idx, gidx, out_spatial = jax_engine.sparse_conv_downsample(
            st, 3, 2, padding, out_capacity=96)
        down = rng.randn(96, cin).astype(np.float32)
        down_st = JaxSparseConvTensor(features=jnp.asarray(down),
                                      indices=out_idx,
                                      spatial_shape=out_spatial, batch_size=2)
        want = np.asarray(jax_engine.inverse_conv_indices(
            down_st, st.indices, spatial, 3, 2, padding))
        assert (want < 96).sum() > 50
        pst = SparseConvTensor(features=_t(st.features),
                               indices=_t(st.indices), spatial_shape=spatial,
                               batch_size=2)
        # the strided conv's book, then the inverse conv over its transpose
        cache = {}
        strided = SparseConv3d(cin, cin, 3, 2, padding)
        x = strided(pst, cache, None)
        np.testing.assert_array_equal(x.indices.numpy(), np.asarray(out_idx))
        inv = SparseInverseConv3d(cin, cout, 3, 2, padding)
        inv.reset_parameters(torch.Generator().manual_seed(0))
        leaf = torch.tensor(down, requires_grad=True)
        y = inv(x.replace(features=leaf), pst, cache)
        book, back = cache[inverse_cache_key(spatial, inv.kernel_size, 2,
                                             padding)]
        assert back is not None
        np.testing.assert_array_equal(book.numpy(), want)
        np.testing.assert_array_equal(engine.inverse_conv_indices(
            x, pst.indices, 3, 2, padding).numpy(), want)
        # with no strided book cached there is no book to transpose
        with pytest.raises(ValueError, match="strided conv"):
            inv(x.replace(features=leaf), pst, {})

        w = inv.weight.detach().numpy()
        valid = np.asarray(st.indices)[:, 0] >= 0
        g_out = rng.randn(96, cout).astype(np.float32)

        def jax_fn(f):
            o = jax_engine.gather_conv(f, jnp.asarray(want), jnp.asarray(w),
                                       out_valid=jnp.asarray(valid))
            return (o * g_out).sum(), o
        (_, want_y), want_dx = jax.value_and_grad(jax_fn, has_aux=True)(
            jnp.asarray(down))
        assert _rel(y.features.detach().numpy(), np.asarray(want_y)) \
            <= OP_RTOL
        (y.features * _t(g_out)).sum().backward()
        assert _rel(leaf.grad.numpy(), np.asarray(want_dx)) <= OP_RTOL


def test_roiaware_pool3d_matches_reference():
    """Rotated rois over scattered points (some rois past the points, a
    thin one): MAX exactly equal (empty cells 0), AVG within 1e-6, also
    over a subset of the points (``point_valid``) against the reference on
    that subset."""
    rng = np.random.RandomState(5)
    rois = np.concatenate([rng.uniform(-4, 4, (7, 3)),
                           rng.uniform(0.8, 4.5, (7, 3)),
                           rng.uniform(-np.pi, np.pi, (7, 1))], 1)
    rois[5, :3] = 40.0                      # no point inside
    rois[6, 3:6] = (4.0, 0.3, 1.5)          # thin
    rois = rois.astype(np.float32)
    pts = rng.uniform(-6, 6, (4000, 3)).astype(np.float32)
    feats = np.maximum(rng.randn(4000, 6), 0).astype(np.float32)
    keep = rng.rand(4000) > 0.3
    for method, tol in (("max", 0.0), ("avg", 1e-6)):
        want = np.asarray(jax_pool(jnp.asarray(rois), jnp.asarray(pts),
                                   jnp.asarray(feats), 6, pool_method=method))
        got = roiaware_pool3d(_t(rois), _t(pts), _t(feats), 6, method).numpy()
        assert (want != 0).mean() > 0.02 and not want[5].any()
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
        want = np.asarray(jax_pool(jnp.asarray(rois), jnp.asarray(pts[keep]),
                                   jnp.asarray(feats[keep]), 6,
                                   pool_method=method))
        got = roiaware_pool3d(_t(rois), _t(pts), _t(feats), 6, method,
                              _t(keep)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _head_inputs(out, frames):
    """The reference's ROI-head inputs for ``frames`` (a frame's point rows
    are its own, pads dropped, when one frame is taken)."""
    d = {k: out[k][frames] for k in ROIS}
    rows = np.ones(len(out["point_coords"]), bool) if len(frames) > 1 \
        else out["point_coords"][:, 0] == frames[0]
    d.update({k: out[k][rows] for k in POINT_KEYS})
    return d


def test_reference_avg_pool_fault_pinned(ref):
    """The reference's PartA2FCHead on its own inputs: at batch 2, frame
    0's AVG-pooled part features differ from those of frame 0 alone
    (other frames' points counted), and so do its final scores; pooled
    over each frame's own rows (patched) they are equal, and the port's
    head gives frame 0 the same outputs at batch 2 and alone."""
    out, jcfg = ref["out"], common.configs("parta2_tiny")[0]
    head = JaxPartA2FCHead(model_cfg=jcfg.MODEL.ROI_HEAD, input_channels=16,
                           num_class=1, voxel_size=ref["port"].roi_head.
                           voxel_size, point_cloud_range=ref["port"].
                           roi_head.point_cloud_range)
    v = {c: ref["vars"][c]["roi_head"] for c in ("params", "batch_stats")}
    v = flax.core.freeze(v)

    def run(frames):
        pooled = []
        real = jax_parta2.roiaware_pool3d

        def record(*a, **kw):
            res = real(*a, **kw)
            if kw.get("pool_method") == "avg":
                pooled.append(res)
            return res
        def go(b):
            bd = head.apply(v, b, train=False)
            return pooled[0], bd["final_scores"][0]
        jax_parta2.roiaware_pool3d = record
        try:
            res = jax.jit(go)({k: jnp.asarray(a) for k, a in
                               _head_inputs(out, frames).items()})
        finally:
            jax_parta2.roiaware_pool3d = real
        return tuple(np.asarray(a) for a in res)

    pair, alone = run([0, 1]), run([0])
    assert np.abs(pair[0] - alone[0]).max() > 1e-2
    assert np.abs(pair[1] - alone[1]).max() > 1e-5
    with pytest.MonkeyPatch.context() as mp:
        own_frame_avg_pool(mp)
        pair, alone = run([0, 1]), run([0])
    np.testing.assert_allclose(pair[0], alone[0], rtol=0, atol=1e-6)
    with torch.no_grad():
        got = [ref["port"].roi_head({k: _t(a) for k, a in
                                     _head_inputs(out, f).items()})
               for f in ([0, 1], [0])]
    np.testing.assert_allclose(got[0]["final_scores"][0].numpy(),
                               got[1]["final_scores"][0].numpy(), rtol=0,
                               atol=1e-6)
    assert _rel(got[0]["final_scores"].numpy(), out["final_scores"]) \
        <= LAYER_RTOL


def test_unet_part_head_and_roi_head_match_reference(ref):
    """Each module on the reference's own input: UNetV2 (on the VFE's
    voxel features of the same batch), the part head on the reference's
    point features, PartA2FCHead on its rois and point and part
    features."""
    model, out = ref["port"], ref["out"]
    with torch.no_grad():
        bd = model.backbone_3d(model.vfe(dict(ref["port_batch"])))
    np.testing.assert_array_equal(bd["point_coords"].numpy(),
                                  out["point_coords"])
    assert _rel(bd["point_features"].numpy(), out["point_features"]) \
        <= OP_RTOL
    enc = bd["encoded_spconv_tensor"]
    np.testing.assert_array_equal(enc.indices.numpy(), ref["enc"][1])
    assert _rel(enc.features.numpy(), ref["enc"][0]) <= OP_RTOL

    with torch.no_grad():
        got = model.point_head({"point_features":
                                _t(out["point_features"])})
    for key in ("point_cls_scores", "point_part_offset"):
        assert _rel(got[key].numpy(), out[key]) <= LAYER_RTOL, key

    with torch.no_grad():
        got = model.roi_head({k: _t(out[k]) for k in HEAD_IN})
    valid = out["final_valid"]
    assert valid.sum() > 10
    np.testing.assert_array_equal(got["final_valid"].numpy(), valid)
    for key in ("final_boxes", "final_scores"):
        assert _rel(got[key].numpy()[valid], out[key][valid]) \
            <= LAYER_RTOL, key


def test_tiny_parta2_matches_reference(ref):
    """The whole forward: the proposal layer's rois the same keep set, the
    final detections matched slot for slot; every variable of the
    reference carried across with none left over (the 19 sparse convs: 12
    SubM, 4 strided, 3 inverse); the ROI head's outputs final, with no NMS
    after the refinement (``rois_final_checks``)."""
    with torch.no_grad():
        got = {k: v.numpy() for k, v in
               ref["port"](dict(ref["port_batch"])).items()
               if isinstance(v, torch.Tensor)}
    out = ref["out"]
    np.testing.assert_array_equal(got["roi_valid"], out["roi_valid"])
    v = out["roi_valid"]
    assert v.sum() > 10
    np.testing.assert_array_equal(got["roi_labels"][v], out["roi_labels"][v])
    # seeded boxes run to ~55 m a side: the decode's relative term too
    np.testing.assert_allclose(got["rois"][v], out["rois"][v],
                               rtol=common.BOX_RTOL, atol=ROI_TOL)
    np.testing.assert_array_equal(got["final_valid"], out["final_valid"])
    np.testing.assert_allclose(got["final_boxes"][v], out["final_boxes"][v],
                               rtol=0, atol=BOX_TOL)
    np.testing.assert_allclose(got["final_scores"][v],
                               out["final_scores"][v], rtol=0,
                               atol=SCORE_TOL)
    state = state_dict_from_jax(ref["vars"])
    assert set(state) == set(ref["port"].state_dict())
    kinds = [type(m).__name__ for m in ref["port"].backbone_3d.modules()
             if hasattr(m, "QUANT_KIND")]
    assert (kinds.count("SubMConv3d"), kinds.count("SparseConv3d"),
            kinds.count("SparseInverseConv3d")) == (12, 4, 3)
    rois_final_checks(ref)
