"""incubate.nn.functional (port of paddle_tpu.incubate.nn.functional):
the fused-op API (norms, rotary embedding, bias + activation, the fused
feed-forward and attention blocks, the masked decode attention, weight-
only int8 linear, a dense MoE), the fused_parity tranche and the paged
decode of ``fused_transformer``.

Each function keeps the reference's signature, its ops the reference's
names, AMP policies and ``differentiable`` flags, and the reference's
expression term for term:

- ``fused_bias_act``'s ``gelu`` and ``geglu`` are tanh gelu (JAX's
  default), while ``fused_linear_activation``, ``fused_feedforward`` and
  ``fused_moe`` call ``F.gelu``, exact by default;
- the two norms return ``(y, residual_out)`` only when a residual is
  passed;
- ``weight_only_linear`` multiplies the int8 weight, widened to bf16, by
  the fp32 scales: an fp32 weight under type promotion, so the output is
  fp32 whatever the activation's floating dtype (the reference's
  promotion);
- ``masked_multihead_attention`` writes each sequence's k and v into
  ``cache_kv`` in place at its own ``sequence_lengths`` entry (the
  reference returns an updated copy; the returned cache holds the same
  values) and attends in fp32 over the positions up to it.

The attention entries reach the port's flash kernels where the
reference reaches its flash kernel: ``memory_efficient_attention`` and
``fused_multi_head_attention`` through ``scaled_dot_product_attention``
(K1-sep forward, K3-sep backward with no mask and no dropout), and
``fused_parity.fused_dot_product_attention`` through
``flash_attention_raw``. Everything else is plain PyTorch on either
device, as it is a jnp expression in the reference.

``memory_efficient_attention`` honours ``scale``, which the reference
takes and ignores (ROADMAP Queue 3, defect M).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from ....core.dispatch import op
from ....core.tensor import Tensor, as_torch
from ....nn import functional as F
from ....ops.quant import absmax_quantize_int8

__all__ = [
    "fused_rms_norm", "fused_layer_norm", "fused_rotary_position_embedding",
    "swiglu", "fused_bias_act", "fused_linear", "fused_linear_activation",
    "fused_feedforward", "fused_multi_head_attention",
    "variable_length_memory_efficient_attention",
    "memory_efficient_attention", "masked_multihead_attention",
    "weight_quantize", "weight_only_linear", "fused_moe",
]

swiglu = F.swiglu


def _data(t):
    """The torch buffer of ``t``, off the tape (the reference computes the
    int8 helpers on raw arrays)."""
    return (t._data if isinstance(t, Tensor) else as_torch(t)).detach()


def _residual_norm(x, bias, residual, normed):
    """The two norms' shared frame: x + bias + residual, normalized by
    ``normed`` (a function of fp32 x), cast back; (y, x + ...) with a
    residual."""
    if bias is not None:
        x = x + bias
    if residual is not None:
        x = x + residual
    y = normed(x.float()).to(x.dtype)
    return (y, x) if residual is not None else y


@op("fused_rms_norm", amp="keep_fp32")
def fused_rms_norm(x, norm_weight, norm_bias=None, epsilon=1e-5,
                   begin_norm_axis=-1, bias=None, residual=None,
                   quant_scale=-1, **kw):
    """reference: fused_rms_norm (phi fusion rms_norm_kernel). Returns
    (out, residual_out) when residual is passed, like the reference."""
    def normed(x32):
        y = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + epsilon)
        y = y * norm_weight.float()
        return y if norm_bias is None else y + norm_bias.float()

    return _residual_norm(x, bias, residual, normed)


@op("fused_layer_norm", amp="keep_fp32")
def fused_layer_norm(x, norm_weight, norm_bias, epsilon=1e-5,
                     begin_norm_axis=-1, bias=None, residual=None, **kw):
    def normed(x32):
        mu = x32.mean(-1, keepdim=True)
        var = torch.square(x32 - mu).mean(-1, keepdim=True)
        y = (x32 - mu) * torch.rsqrt(var + epsilon)
        if norm_weight is not None:
            y = y * norm_weight.float()
        return y if norm_bias is None else y + norm_bias.float()

    return _residual_norm(x, bias, residual, normed)


@op("fused_rotary_position_embedding")
def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True,
                                    rotary_emb_base=10000.0):
    """reference: fused_rope (phi/kernels/fusion/gpu/fused_rope). q/k/v:
    [B, T, nH, dH]; returns rotated tensors (None passthrough). cos and
    sin may be [T, d], [B, T, d] or [T, 1, d]; their first d/2 columns
    are used. ``use_neox_rotary_style`` rotates halves, else interleaved
    pairs."""
    B, T, nH, dH = q.shape
    dev = q.device
    if cos is None or sin is None:
        inv = 1.0 / (rotary_emb_base ** (torch.arange(
            0, dH, 2, dtype=torch.float32, device=dev) / dH))
        pos = (position_ids if position_ids is not None
               else torch.arange(T, device=dev))
        ang = pos.float()[..., None] * inv   # [T, d/2] or [B, T, d/2]
        cos, sin = torch.cos(ang), torch.sin(ang)

    def _fit(c):
        c = torch.as_tensor(c, device=dev)
        if c.dim() == 2:
            c = c[None, :, None, :]
        elif c.dim() == 3 and c.shape[0] == B and c.shape[1] == T:
            c = c[:, :, None, :]
        else:
            c = c.reshape(1, T, 1, -1)
        return c[..., :dH // 2]

    cos, sin = _fit(cos), _fit(sin)

    def rot(x):
        if x is None:
            return None
        x32 = x.float()
        if use_neox_rotary_style:
            x1, x2 = torch.chunk(x32, 2, dim=-1)
            o = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
        else:
            x1, x2 = x32[..., 0::2], x32[..., 1::2]
            o = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                            -1).reshape(x.shape)
        return o.to(x.dtype)

    return tuple(rot(t) for t in (q, k, v))


def _gelu_tanh(x):
    return TF.gelu(x, approximate="tanh")


@op("fused_bias_act")
def fused_bias_act(x, bias=None, act_method="gelu", **kw):
    """reference: fused_bias_act_kernel (phi fusion); gelu and geglu are
    tanh gelu."""
    if bias is not None:
        x = x + bias
    if act_method == "gelu":
        return _gelu_tanh(x)
    if act_method == "geglu":
        a, b = torch.chunk(x, 2, dim=-1)
        return _gelu_tanh(a) * b
    if act_method == "swiglu":
        a, b = torch.chunk(x, 2, dim=-1)
        return TF.silu(a) * b
    if act_method == "relu":
        return torch.relu(x)
    return x


def fused_linear(x, weight, bias=None, transpose_weight=False, name=None):
    if transpose_weight:
        weight = weight.transpose([1, 0]) if isinstance(weight, Tensor) \
            else weight.T
    return F.linear(x, weight, bias)


def fused_linear_activation(x, y, bias, trans_x=False, trans_y=False,
                            activation="gelu"):
    out = fused_linear(x, y, bias, transpose_weight=trans_y)
    return F.gelu(out) if activation == "gelu" else F.relu(out)


def fused_feedforward(x, linear1_weight, linear2_weight, linear1_bias=None,
                      linear2_bias=None, ln1_scale=None, ln1_bias=None,
                      ln2_scale=None, ln2_bias=None, dropout1_rate=0.5,
                      dropout2_rate=0.5, activation="relu",
                      ln1_epsilon=1e-5, ln2_epsilon=1e-5,
                      pre_layer_norm=False, training=True,
                      mode='upscale_in_train', name=None):
    """reference: fused_feedforward op (phi/kernels/fusion/gpu/
    fused_feedforward). pre/post-LN residual MLP."""
    residual = x
    if pre_layer_norm:
        x = F.layer_norm(x, x.shape[-1:], ln1_scale, ln1_bias, ln1_epsilon)
    h = F.linear(x, linear1_weight, linear1_bias)
    h = F.relu(h) if activation == "relu" else F.gelu(h)
    h = F.dropout(h, dropout1_rate, training=training)
    h = F.linear(h, linear2_weight, linear2_bias)
    h = F.dropout(h, dropout2_rate, training=training)
    out = residual + h
    if not pre_layer_norm:
        out = F.layer_norm(out, out.shape[-1:], ln2_scale, ln2_bias,
                           ln2_epsilon)
    return out


def fused_multi_head_attention(x, qkv_weight, linear_weight,
                               pre_layer_norm=False, pre_ln_scale=None,
                               pre_ln_bias=None, ln_scale=None, ln_bias=None,
                               pre_ln_epsilon=1e-5, qkv_bias=None,
                               linear_bias=None, cache_kv=None,
                               attn_mask=None, dropout_rate=0.0,
                               attn_dropout_rate=0.0, ln_epsilon=1e-5,
                               training=True, mode='upscale_in_train',
                               ring_id=-1, add_residual=True, num_heads=None,
                               transpose_qkv_wb=False, name=None):
    """reference: fused_attention op. qkv_weight [3, nH, dH, H]. With no
    mask and no attention dropout the attention is the flash kernels
    (``scaled_dot_product_attention``'s route)."""
    from .... import einsum
    from ....nn.functional.attention import scaled_dot_product_attention

    residual = x
    if pre_layer_norm:
        x = F.layer_norm(x, x.shape[-1:], pre_ln_scale, pre_ln_bias,
                         pre_ln_epsilon)
    B, T, H = x.shape
    _, nH, dH, _ = qkv_weight.shape
    qkv = einsum("bth,kndh->kbtnd", x, qkv_weight)
    if qkv_bias is not None:
        qkv = qkv + qkv_bias.reshape([3, 1, 1, nH, dH])
    q, k, v = qkv[0], qkv[1], qkv[2]
    o = scaled_dot_product_attention(q, k, v, attn_mask=attn_mask,
                                     dropout_p=attn_dropout_rate,
                                     training=training)
    o = o.reshape([B, T, nH * dH])
    out = F.linear(o, linear_weight, linear_bias)
    out = F.dropout(out, dropout_rate, training=training)
    if add_residual:
        out = residual + out
    if not pre_layer_norm:
        out = F.layer_norm(out, out.shape[-1:], ln_scale, ln_bias, ln_epsilon)
    return out


def memory_efficient_attention(query, key, value, attn_bias=None, p=0.0,
                               scale=None, training=True):
    """reference: cutlass memory-efficient attention → the flash route of
    ``scaled_dot_product_attention``. A ``scale`` other than 1/sqrt(d)
    scales the queries first (the reference drops it: defect M)."""
    from ....nn.functional.attention import scaled_dot_product_attention

    if scale is not None:
        query = query * (float(scale) * math.sqrt(query.shape[-1]))
    return scaled_dot_product_attention(query, key, value,
                                        attn_mask=attn_bias, dropout_p=p,
                                        training=training)


variable_length_memory_efficient_attention = memory_efficient_attention


def masked_multihead_attention(x, cache_kv=None, bias=None, src_mask=None,
                               sequence_lengths=None, rotary_tensor=None,
                               beam_cache_offset=None, qkv_out_scale=None,
                               out_shift=None, seq_len=1, rotary_emb_dims=0,
                               use_neox_rotary_style=False,
                               compute_dtype='default', out_scale=-1,
                               quant_round_type=1, quant_max_bound=127.0,
                               quant_min_bound=-127.0):
    """Decode-step attention against a KV cache (reference:
    phi/kernels/fusion/gpu/masked_multihead_attention_kernel.cu).
    ``x`` is the fused single-token qkv [B, 3*nH*dH], ``cache_kv``
    [2, B, nH, S, dH]; each sequence writes its k and v at its own
    ``sequence_lengths`` entry (per-batch ints; 0 for all when None) and
    attends over the positions up to it. The write goes into ``cache_kv``
    in place, as Paddle's kernel writes its cache; the returned cache is
    that tensor. Returns (out [B, nH*dH], cache_kv). The quantized,
    rotary, bias, mask and beam variants raise ``NotImplementedError``,
    as the reference's."""
    if any(v is not None for v in (bias, src_mask, beam_cache_offset,
                                   qkv_out_scale, out_shift,
                                   rotary_tensor)) \
            or rotary_emb_dims or out_scale != -1:
        raise NotImplementedError(
            "masked_multihead_attention: quant/rotary/bias/mask variants "
            "are served by models/llama.py's decode path")
    if cache_kv is None:
        raise ValueError("cache_kv [2, B, nH, S, dH] is required")
    if sequence_lengths is None:
        sequence_lengths = torch.zeros((cache_kv.shape[1],),
                                       dtype=torch.int32,
                                       device=_data(cache_kv).device)
    return _masked_mha_impl(x, cache_kv, sequence_lengths)


@op("masked_multihead_attention", differentiable=False)
def _masked_mha_impl(x, cache_kv, sequence_lengths):
    _, B, nH, S, dH = cache_kv.shape
    qkv = x.reshape(B, 3, nH, dH)
    q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]           # [B, nH, dH]
    pos = sequence_lengths.reshape(-1).to(device=x.device,
                                          dtype=torch.int64)
    rows = torch.arange(B, device=x.device)
    # each sequence's write at its own position, in place
    cache_kv[0, rows, :, pos] = k.to(cache_kv.dtype)
    cache_kv[1, rows, :, pos] = v.to(cache_kv.dtype)
    kc, vc = cache_kv[0], cache_kv[1]
    s = torch.einsum("bhd,bhsd->bhs", q.float(), kc.float()) / math.sqrt(dH)
    mask = torch.arange(S, device=x.device)[None, :] <= pos[:, None]
    s = torch.where(mask[:, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhs,bhsd->bhd", p, vc.float())
    return o.reshape(B, nH * dH).to(x.dtype), cache_kv


def weight_quantize(x, algo="weight_only_int8", arch=None, group_size=-1):
    """reference: weight_quantize op → (int8 weights [K, N], fp32 scales
    [N]): per-column absmax."""
    q, scale = absmax_quantize_int8(_data(x), axis=0)
    return Tensor(q), Tensor(scale[0])


def weight_dequantize(x, scale, algo="weight_only_int8", group_size=-1):
    """reference: weight_dequantize op — inverse of weight_quantize."""
    return Tensor(_data(x).float() * _data(scale))


def weight_only_linear(x, weight, bias=None, weight_scale=None,
                       weight_dtype="int8", arch=None, group_size=-1):
    """reference: weight_only_linear — the int8 weight widened to bf16
    times the fp32 scales (an fp32 weight), then ``F.linear``: the output
    is the promotion of x's dtype and fp32."""
    deq = Tensor(_data(weight).to(torch.bfloat16) * _data(weight_scale))
    dt = torch.promote_types(x.dtype, deq.dtype)
    if x.dtype != dt:
        x = x.astype(dt)
    return F.linear(x, deq, bias)


def fused_moe(x, gate_weight, ffn1_weight, ffn2_weight, ffn1_bias=None,
              ffn1_scale=None, ffn2_bias=None, ffn2_scale=None,
              quant_method="None", moe_topk=2, norm_topk_prob=True):
    """reference: fused_moe_kernel (cutlass). Dense-dispatch top-k MoE: every
    expert on every token, combined by its top-k weight."""
    from .... import topk, zeros_like

    B, T, H = x.shape
    E = gate_weight.shape[-1]
    flat = x.reshape([B * T, H])
    logits = flat.matmul(gate_weight)
    probs = F.softmax(logits, axis=-1)
    topv, topi = topk(probs, moe_topk, axis=-1)
    if norm_topk_prob:
        topv = topv / topv.sum(axis=-1, keepdim=True)
    out = zeros_like(flat)
    for e in range(E):
        h = flat.matmul(ffn1_weight[e])
        if ffn1_bias is not None:
            h = h + ffn1_bias[e]
        h = F.gelu(h)
        h = h.matmul(ffn2_weight[e])
        if ffn2_bias is not None:
            h = h + ffn2_bias[e]
        weight_e = ((topi == e).astype(flat.dtype) * topv).sum(
            axis=-1, keepdim=True)
        out = out + h * weight_e
    return out.reshape([B, T, H])


from .fused_parity import *  # noqa: F401,F403,E402
from . import fused_parity  # noqa: F401,E402
from .fused_transformer import (  # noqa: F401,E402
    fused_multi_transformer, block_multihead_attention, PagedKVCache,
    paged_decode_attention)

__all__ += [
    "weight_dequantize", "fused_multi_transformer",
    "block_multihead_attention", "PagedKVCache", "paged_decode_attention",
]
__all__ += list(fused_parity.__all__)
