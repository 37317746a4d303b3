"""The fused-op parity tranche (port of paddle_tpu/incubate/nn/functional/
fused_parity.py).

Each op of the reference's fused_ops.yaml coverage, with its name,
``differentiable`` flag and AMP policy, as one torch expression in the
reference's order of operations. ``fused_dot_product_attention`` takes
``flash_attention_raw`` (K1-sep forward, K3-sep backward on the card)
where the reference takes its flash kernel: no mask and a shape the
flash gate accepts (``flash_supported``, the reference's
``supported``); otherwise the reference's masked expression. The ops
that convolve or pool inside their body (``max_pool2d_v2``,
``resnet_unit``, ``resnet_basic_block``, ``fused_scale_bias_relu_conv_bn``,
``fused_conv2d_add_act``) call the port's plain conv and pool functions,
not a second op. The dropout ops draw from the port's generator: the
reference's distribution, other bits.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as TF

from ....core import random as prandom
from ....core.dispatch import op
from ....nn.functional.common import _keep_mask
from ....nn.functional.conv import _conv_impl
from ....nn.functional.pooling import _pool
from ....ops.kernels import flash_attention as _fa

__all__ = [
    "fc", "fused_elementwise_add", "fused_elementwise_sub",
    "fused_elementwise_mul", "fused_elementwise_div",
    "fused_elemwise_activation", "fused_elemwise_add_activation",
    "fused_dropout_add", "fused_bias_dropout_residual_layer_norm",
    "fused_bias_residual_layernorm", "skip_layernorm",
    "fused_embedding_eltwise_layernorm", "fused_fc_elementwise_layernorm",
    "multihead_matmul", "self_dp_attention", "fused_dot_product_attention",
    "fused_conv2d_add_act", "fused_scale_bias_add_relu",
    "add_group_norm_silu", "fused_batch_norm_act",
    "fused_bn_add_activation", "max_pool2d_v2", "resnet_unit",
    "resnet_basic_block", "squeeze_excitation_block",
    "fusion_repeated_fc_relu", "fusion_squared_mat_sub",
    "fusion_transpose_flatten_concat", "fused_token_prune",
    "qkv_unpack_mha", "blha_get_max_len",
]


def _identity(x):
    return x


_ACTS = {
    "relu": torch.relu, "gelu": lambda x: TF.gelu(x, approximate="tanh"),
    "sigmoid": torch.sigmoid, "tanh": torch.tanh, "silu": TF.silu,
    "swish": TF.silu, "identity": _identity, "": _identity,
    None: _identity,
}


def _ln(x, scale, bias, eps):
    mu = x.mean(-1, keepdim=True)
    var = torch.square(x - mu).mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale
    if bias is not None:
        y = y + bias
    return y


def _keep(shape, keep: float, device):
    """Bernoulli(keep) over ``shape`` from the port's generator."""
    return _keep_mask(prandom.default_generator().torch_generator(device),
                      shape, keep, device)


def _conv2d(x, w, bias=None, stride=1, padding=0, dilation=1, groups=1):
    return _conv_impl(x, w, bias, stride, padding, dilation, groups, 2,
                      "NCHW")


@op("fc")
def fc(x, w, bias=None, activation_type: str = ""):
    """fused_ops.yaml `fc` (fc_kernel): matmul+bias+act, flattening
    leading dims."""
    y = torch.matmul(x, w)
    if bias is not None:
        y = y + bias
    return _ACTS[activation_type](y)


@op("fused_elementwise_add")
def fused_elementwise_add(x, y, act: str = ""):
    return _ACTS[act](x + y)


@op("fused_elementwise_sub")
def fused_elementwise_sub(x, y, act: str = ""):
    return _ACTS[act](x - y)


@op("fused_elementwise_mul")
def fused_elementwise_mul(x, y, act: str = ""):
    return _ACTS[act](x * y)


@op("fused_elementwise_div")
def fused_elementwise_div(x, y, act: str = ""):
    return _ACTS[act](x / y)


_BINOPS = {"add": torch.add, "sub": torch.subtract, "mul": torch.multiply}


@op("fused_elemwise_activation")
def fused_elemwise_activation(x, y, functor_list=("add", "relu")):
    binop, act = functor_list[0], functor_list[1]
    return _ACTS[act](_BINOPS[binop.replace("elementwise_", "")](x, y))


@op("fused_elemwise_add_activation")
def fused_elemwise_add_activation(x, y, act: str = "relu"):
    return _ACTS[act](x + y)


@op("fused_dropout_add")
def fused_dropout_add(x, y, p: float = 0.5, training: bool = True,
                      mode: str = "upscale_in_train"):
    """fusion/gpu/fused_dropout_add_kernel.cu."""
    if not training or p == 0.0:
        return x + y
    keep = _keep(x.shape, 1.0 - p, x.device)
    kept = x / (1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(keep, kept, 0.0).to(x.dtype) + y


@op("fused_bias_dropout_residual_layer_norm")
def fused_bias_dropout_residual_layer_norm(
        x, residual, bias=None, ln_scale=None, ln_bias=None,
        dropout_rate: float = 0.5, ln_epsilon: float = 1e-5,
        training: bool = True):
    """fusion/gpu/fused_bias_dropout_residual_layer_norm (yaml
    fused_bias_dropout_residual_layer_norm)."""
    h = x if bias is None else x + bias
    if training and dropout_rate > 0:
        keep = _keep(h.shape, 1.0 - dropout_rate, h.device)
        h = torch.where(keep, h / (1.0 - dropout_rate), 0.0).to(h.dtype)
    h = h + residual
    return _ln(h.float(), ln_scale, ln_bias, ln_epsilon).to(x.dtype)


@op("fused_bias_residual_layernorm")
def fused_bias_residual_layernorm(x, residual=None, bias=None,
                                  norm_weight=None, norm_bias=None,
                                  epsilon: float = 1e-5,
                                  residual_alpha: float = 1.0):
    h = x if bias is None else x + bias
    if residual is not None:
        h = h + residual_alpha * residual
    out = _ln(h.float(), norm_weight, norm_bias, epsilon).to(x.dtype)
    return out, h


@op("skip_layernorm")
def skip_layernorm(x, y, scale=None, bias=None, epsilon: float = 1e-5):
    """fusion skip_layernorm: LN(x + y)."""
    return _ln((x + y).float(), scale, bias, epsilon).to(x.dtype)


@op("fused_embedding_eltwise_layernorm")
def fused_embedding_eltwise_layernorm(ids_list, emb_list, scale=None,
                                      bias=None, epsilon: float = 1e-5):
    """Sum of embedding lookups + LN (fused_embedding_eltwise_layernorm)."""
    h = None
    for ids, emb in zip(ids_list, emb_list):
        e = emb[ids.long()]
        h = e if h is None else h + e
    return _ln(h.float(), scale, bias, epsilon).to(h.dtype)


@op("fused_fc_elementwise_layernorm")
def fused_fc_elementwise_layernorm(x, w, y, bias0=None, scale=None,
                                   bias1=None, epsilon: float = 1e-5):
    h = torch.matmul(x, w)
    if bias0 is not None:
        h = h + bias0
    h = h + y
    return _ln(h.float(), scale, bias1, epsilon).to(x.dtype)


def _attend(qh, kh, vh, scale, s_bias=None, causal=False, divide=False):
    """[B, h, S, d] attention with fp32 scores, times ``scale`` (or
    divided by it), softmax cast to q's dtype before the value product
    (the reference's order)."""
    s = torch.einsum("bhqd,bhkd->bhqk", qh.float(), kh.float())
    s = s / scale if divide else s * scale
    if causal:
        S = s.shape[-1]
        s = torch.where(torch.ones(S, S, dtype=torch.bool,
                                   device=s.device).tril(), s, -1e30)
    if s_bias is not None:
        s = s + s_bias
    p = torch.softmax(s, dim=-1).to(qh.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, vh)


@op("multihead_matmul")
def multihead_matmul(x, w, bias=None, bias_qk=None, transpose_qkv: bool = True,
                     head_number: int = 1):
    """TensorRT-era fused MHA (fusion/gpu/multihead_matmul_op): one packed
    qkv weight [H, 3H], self attention, merge heads."""
    B, S, H = x.shape
    qkv = torch.matmul(x, w)
    if bias is not None:
        qkv = qkv + bias
    d = H // head_number
    qkv = qkv.reshape(B, S, 3, head_number, d)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    o = _attend(q, k, v, math.sqrt(d), bias_qk, divide=True)
    return o.transpose(1, 2).reshape(B, S, H)


@op("self_dp_attention")
def self_dp_attention(x, head_number: int = 1, alpha: float = 1.0):
    """onednn self_dp_attention: packed qkv input [B, S, 3, nH, d]."""
    q, k, v = (x[:, :, i].transpose(1, 2) for i in range(3))
    o = _attend(q, k, v, alpha).transpose(1, 2)
    return o.reshape(o.shape[0], o.shape[1], -1)


@op("fused_dot_product_attention")
def fused_dot_product_attention(q, k, v, mask=None, scale=None,
                                dropout: float = 0.0, causal: bool = False):
    """cudnn fused_dot_product_attention, [B, S, nH, d] layout: the flash
    kernels where the reference's gate holds (no mask, a supported shape
    and dtype), else the masked expression."""
    if mask is None and _fa.flash_supported(tuple(q.shape), q.dtype):
        return _fa.flash_attention_raw(q, k, v, causal=causal,
                                       sm_scale=scale)
    sc = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    o = _attend(*(t.transpose(1, 2) for t in (q, k, v)), sc, mask, causal)
    return o.transpose(1, 2)


@op("fused_conv2d_add_act")
def fused_conv2d_add_act(x, filter, residual=None, bias=None,  # noqa: A002
                         strides=(1, 1), paddings=(0, 0), dilations=(1, 1),
                         groups: int = 1, activation: str = "relu"):
    """cutlass/cudnn conv+bias+add+act (fused_conv2d_add_act)."""
    y = _conv2d(x, filter, bias, strides, paddings, dilations, groups)
    if residual is not None:
        y = y + residual
    return _ACTS[activation](y)


@op("fused_scale_bias_add_relu")
def fused_scale_bias_add_relu(x1, scale1, bias1, x2, scale2=None,
                              bias2=None):
    a = x1 * scale1 + bias1
    b = x2 if scale2 is None else x2 * scale2 + (bias2 if bias2 is not None
                                                 else 0)
    return torch.relu(a + b)


@op("add_group_norm_silu")
def add_group_norm_silu(x, residual=None, scale=None, bias=None,
                        groups: int = 32, epsilon: float = 1e-5):
    """fusion add_group_norm_silu (NCHW)."""
    h = x if residual is None else x + residual
    N, C, H, W = h.shape
    g = h.reshape(N, groups, C // groups, H, W).float()
    mu = g.mean(dim=(2, 3, 4), keepdim=True)
    var = torch.square(g - mu).mean(dim=(2, 3, 4), keepdim=True)
    y = ((g - mu) * torch.rsqrt(var + epsilon)).reshape(N, C, H, W)
    if scale is not None:
        y = y * scale.reshape(1, -1, 1, 1)
    if bias is not None:
        y = y + bias.reshape(1, -1, 1, 1)
    return TF.silu(y).to(x.dtype), h


def _bn_infer(x, scale, bias, mean, var, eps):
    inv = torch.rsqrt(var + eps)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return (x - mean.reshape(shape)) * (inv * scale).reshape(shape) + \
        bias.reshape(shape)


@op("fused_batch_norm_act")
def fused_batch_norm_act(x, scale, bias, mean, variance,
                         momentum: float = 0.9, epsilon: float = 1e-5,
                         act_type: str = "relu"):
    return _ACTS[act_type](_bn_infer(x, scale, bias, mean, variance,
                                     epsilon))


@op("fused_bn_add_activation")
def fused_bn_add_activation(x, z, scale, bias, mean, variance,
                            momentum: float = 0.9, epsilon: float = 1e-5,
                            act_type: str = "relu"):
    return _ACTS[act_type](_bn_infer(x, scale, bias, mean, variance,
                                     epsilon) + z)


@op("max_pool2d_v2", differentiable=False)
def max_pool2d_v2(x, kernel_size, stride=None, padding=0):
    return _pool(x, kernel_size, stride, padding, 2, False, "max")


@op("resnet_unit")
def resnet_unit(x, filter_x, scale_x, bias_x, mean_x, var_x,
                z=None, filter_z=None, scale_z=None, bias_z=None,
                mean_z=None, var_z=None, stride: int = 1,
                padding: int = 1, epsilon: float = 1e-5,
                act_type: str = "relu"):
    """fused resnet_unit (conv+BN on main path, optional shortcut
    conv+BN, add, relu) — fusion/gpu/resnet_unit_op."""
    y = _conv2d(x, filter_x, stride=stride, padding=padding)
    y = _bn_infer(y, scale_x, bias_x, mean_x, var_x, epsilon)
    if z is not None:
        if filter_z is not None:
            z = _conv2d(z, filter_z, stride=stride, padding=0)
            z = _bn_infer(z, scale_z, bias_z, mean_z, var_z, epsilon)
        y = y + z
    return _ACTS[act_type](y)


@op("resnet_basic_block")
def resnet_basic_block(x, filter1, scale1, bias1, mean1, var1,
                       filter2, scale2, bias2, mean2, var2,
                       stride: int = 1, epsilon: float = 1e-5):
    """Two conv+BN stages with residual add + relu (resnet_basic_block)."""
    y = _conv2d(x, filter1, stride=stride, padding=1)
    y = torch.relu(_bn_infer(y, scale1, bias1, mean1, var1, epsilon))
    y = _conv2d(y, filter2, stride=1, padding=1)
    y = _bn_infer(y, scale2, bias2, mean2, var2, epsilon)
    if x.shape == y.shape:
        y = y + x
    return torch.relu(y)


@op("squeeze_excitation_block")
def squeeze_excitation_block(x, w1, b1, w2, b2):
    """SE block (xpu squeeze_excitation_block): GAP -> fc+relu ->
    fc+sigmoid -> channel scale. NCHW."""
    s = x.mean(dim=(2, 3))
    h = torch.relu(s @ w1 + b1)
    g = torch.sigmoid(h @ w2 + b2)
    return x * g[:, :, None, None]


@op("fusion_repeated_fc_relu")
def fusion_repeated_fc_relu(x, ws, biases):
    for w, b in zip(ws, biases):
        x = torch.relu(torch.matmul(x, w) + b)
    return x


@op("fusion_squared_mat_sub")
def fusion_squared_mat_sub(x, y, scalar: float = 1.0):
    """(x·y)^2 - x^2·y^2, scaled (fusion_squared_mat_sub_op)."""
    xy = x @ y
    return scalar * (xy * xy - (x * x) @ (y * y))


@op("fusion_transpose_flatten_concat")
def fusion_transpose_flatten_concat(xs, trans_axis, flatten_axis: int = 1,
                                    concat_axis: int = 0):
    outs = []
    for t in xs:
        t = t.permute(*trans_axis)
        lead = int(np.prod(t.shape[:flatten_axis])) if flatten_axis else 1
        outs.append(t.reshape(lead, -1))
    return torch.cat(outs, dim=concat_axis)


@op("fused_token_prune", differentiable=False)
def fused_token_prune(attn, x, mask=None, new_mask=None,
                      keep_first_token: bool = True, keep_order: bool = True):
    """Prune tokens by attention score to new_mask's length
    (fused_token_prune_op): keeps the top-scoring tokens, ties in
    position order (a stable sort, as the reference's), the first token
    first when ``keep_first_token``. Returns (kept x, int32 indices)."""
    B, S, H = x.shape
    slim = new_mask.shape[-1] if new_mask is not None else S // 2
    score = attn.sum(dim=(1, 2)) if attn.dim() == 4 else attn.sum(dim=1)
    if keep_first_token:
        score = score.clone()
        score[:, 0] = math.inf
    idx = torch.argsort(-score, dim=-1, stable=True)[:, :slim]
    if keep_order:
        idx = torch.sort(idx, dim=-1).values
    kept = torch.gather(x, 1, idx[..., None].expand(-1, -1, H))
    return kept, idx.to(torch.int32)


@op("qkv_unpack_mha")
def qkv_unpack_mha(q, k, v, src_mask=None):
    o = _attend(*(t.transpose(1, 2) for t in (q, k, v)),
                math.sqrt(q.shape[-1]), src_mask, divide=True)
    return o.transpose(1, 2)


@op("blha_get_max_len", differentiable=False)
def blha_get_max_len(seq_lens_encoder, seq_lens_decoder, batch_size=None):
    """Max sequence lengths for block attention (blha_get_max_len op)."""
    return seq_lens_encoder.max(), seq_lens_decoder.max()


@op("fused_softmax_mask")
def fused_softmax_mask(x, mask):
    """softmax(x + mask) in fp32 (fusion fused_softmax_mask_kernel)."""
    s = x.float() + mask.float()
    return torch.softmax(s, dim=-1).to(x.dtype)


@op("fused_softmax_mask_upper_triangle")
def fused_softmax_mask_upper_triangle(x):
    """Causal-masked softmax (fused_softmax_mask_upper_triangle): query i
    of Sq sees keys up to i + S - Sq."""
    Sq, S = x.shape[-2], x.shape[-1]
    mask = torch.ones(Sq, S, dtype=torch.bool, device=x.device).tril(S - Sq)
    s = torch.where(mask, x.float(), -1e30)
    return torch.softmax(s, dim=-1).to(x.dtype)


@op("fused_scale_bias_relu_conv_bn")
def fused_scale_bias_relu_conv_bn(x, w, scale, bias, bn_scale, bn_bias,
                                  bn_mean, bn_var, stride=1, padding=1,
                                  epsilon: float = 1e-5):
    """cudnn-fusion scale+bias+relu -> conv -> BN (fused_scale_bias_
    relu_conv_bn)."""
    h = torch.relu(x * scale.reshape(1, -1, 1, 1) + bias.reshape(1, -1, 1, 1))
    y = _conv2d(h, w, stride=stride, padding=padding)
    return _bn_infer(y, bn_scale, bn_bias, bn_mean, bn_var, epsilon)
