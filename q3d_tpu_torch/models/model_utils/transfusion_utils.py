"""TransFusion's transformer pieces (port of
``q3d_tpu/models/model_utils/transfusion_utils.py``): ``clip_sigmoid``, the
learned position embedding, multi-head attention from four quantizable
``Linear``s, and the post-norm decoder layer.  Rows are (B, L, C), as the
reference's.  Module slots follow OpenPCDet's ``TransformerDecoderLayer``
(``self_attn``, ``multihead_attn``, ``linear1``, ``linear2``, ``norm1-3``,
``self_posembed`` / ``cross_posembed.position_embedding_head.{0,1,3}``) as
far as the reference's structure allows: the attention keeps the
reference's separate ``q_proj``, ``k_proj`` and ``v_proj`` where torch's
``nn.MultiheadAttention`` packs them into ``in_proj``.

The attention products are XLA einsums in the reference, outside any
Pallas kernel, so they are ``torch.matmul`` here; not
``F.scaled_dot_product_attention``, whose fused paths round otherwise than
the reference's f32 logits.
"""

import math

import torch
from torch import nn

from ..layers import BatchNorm1d, Conv1d, LayerNorm, Linear


def clip_sigmoid(x, eps=1e-4):
    return torch.clamp(torch.sigmoid(x), eps, 1 - eps)


def promoting_bn1d(num_features):
    """The reference's ``BatchNorm(epsilon=1e-5, momentum=0.1)`` over
    (rows, C): its output is the promotion of the input's dtype and its f32
    statistics, as flax's, so a bf16 input gives f32."""
    bn = BatchNorm1d(num_features, eps=1e-5, momentum=0.1)
    bn.out_f32 = True
    return bn


class PositionEmbeddingLearned(nn.Module):
    """(B, P, 2) positions -> (B, P, num_pos_feats): Conv1d,
    ``promoting_bn1d`` over the (B * P, C) rows, ReLU, Conv1d."""

    def __init__(self, input_channel, num_pos_feats=128):
        super().__init__()
        self.position_embedding_head = nn.Sequential(
            Conv1d(input_channel, num_pos_feats, 1),
            promoting_bn1d(num_pos_feats),
            nn.ReLU(),
            Conv1d(num_pos_feats, num_pos_feats, 1))

    def forward(self, xyz):
        return self.position_embedding_head(xyz)


class MultiheadAttention(nn.Module):
    """Multi-head attention over (B, L, C) rows: q, k and v projected and
    split into heads, the logits q k^T in f32 (the reference's
    ``preferred_element_type=jnp.float32``; a bf16 product of bf16 values
    is exact in f32), divided by sqrt(d_head), softmax in f32, the
    probabilities cast to v's dtype and multiplied by v with f32 sums, the
    result in q's dtype, then ``out_proj``."""

    def __init__(self, d_model, num_heads):
        super().__init__()
        self.d_model, self.num_heads = d_model, num_heads
        self.q_proj = Linear(d_model, d_model)
        self.k_proj = Linear(d_model, d_model)
        self.v_proj = Linear(d_model, d_model)
        self.out_proj = Linear(d_model, d_model)

    def forward(self, q, k, v):
        b, lq, _ = q.shape
        d_head = self.d_model // self.num_heads

        def split(x):                       # (B, L, C) -> (B, heads, L, d)
            return x.reshape(b, -1, self.num_heads, d_head).transpose(1, 2)

        qh, kh = split(self.q_proj(q)), split(self.k_proj(k))
        vh = split(self.v_proj(v))
        logits = torch.matmul(qh.float(), kh.float().transpose(2, 3))
        attn = torch.softmax(logits / math.sqrt(d_head), dim=-1)
        out = torch.matmul(attn.to(vh.dtype).float(), vh.float()).to(q.dtype)
        out = out.transpose(1, 2).reshape(b, lq, self.d_model)
        return self.out_proj(out)


class TransformerDecoderLayer(nn.Module):
    """Post-norm decoder layer: the queries' self-attention, then
    cross-attention to the keys, then the ReLU FFN, each followed by its
    residual and LayerNorm; the position embeddings of the queries and the
    keys are added to the attention inputs.  (The reference's dropout
    field is never read, and its ``cross_only`` switch no caller sets.)"""

    def __init__(self, d_model, nhead, dim_feedforward=2048,
                 activation="relu"):
        super().__init__()
        if activation != "relu":
            raise NotImplementedError(
                f"activation {activation!r}: only relu is ported (every "
                f"TransFusion config sets it)")
        self.self_attn = MultiheadAttention(d_model, nhead)
        self.multihead_attn = MultiheadAttention(d_model, nhead)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)
        self.self_posembed = PositionEmbeddingLearned(2, d_model)
        self.cross_posembed = PositionEmbeddingLearned(2, d_model)

    def forward(self, query, key, query_pos, key_pos):
        """query (B, P, C), key (B, L, C), query_pos (B, P, 2), key_pos
        (B, L, 2) -> (B, P, C)."""
        q_embed = self.self_posembed(query_pos)
        k_embed = self.cross_posembed(key_pos)
        qkv = query + q_embed
        query = self.norm1(query + self.self_attn(qkv, qkv, qkv))
        kv = key + k_embed
        query = self.norm2(query + self.multihead_attn(query + q_embed, kv,
                                                       kv))
        ff = self.linear2(torch.relu(self.linear1(query)))
        return self.norm3(query + ff)
