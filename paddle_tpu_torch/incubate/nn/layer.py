"""The fused Layers (port of paddle_tpu/incubate/nn/layer.py; Paddle's
python/paddle/incubate/nn/layer/fused_transformer.py, fused_linear.py
and fused_dropout_add.py), with the reference's parameter names, shapes
and initializers: ``FusedMultiHeadAttention``'s qkv weight is
[3, nH, dH, H]. Each routes through the incubate functionals, so the
attention of ``FusedMultiHeadAttention`` (and of the encoder and
multi-transformer stacks built from it) is the flash kernels where no
mask and no attention dropout apply. ``FusedMultiHeadAttention`` ignores
``key`` and ``value`` and ``FusedMultiTransformer`` ignores ``caches``,
as the reference's do.
"""

from __future__ import annotations

from ...nn import Layer, initializer as I
from ...nn import functional as NF
from . import functional as F

__all__ = ["FusedLinear", "FusedDropoutAdd",
           "FusedBiasDropoutResidualLayerNorm", "FusedMultiHeadAttention",
           "FusedFeedForward", "FusedTransformerEncoderLayer",
           "FusedMultiTransformer"]


class FusedLinear(Layer):
    """reference fused_linear.py:26 (gemm_epilogue kernel)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, transpose_weight=False, name=None):
        super().__init__()
        shape = ([out_features, in_features] if transpose_weight
                 else [in_features, out_features])
        self.weight = self.create_parameter(
            shape, attr=weight_attr, default_initializer=I.XavierNormal())
        self.bias = None if bias_attr is False else self.create_parameter(
            [out_features], attr=bias_attr, is_bias=True)
        self.transpose_weight = transpose_weight

    def forward(self, input):
        return F.fused_linear(input, self.weight, self.bias,
                              self.transpose_weight)


class FusedDropoutAdd(Layer):
    """reference fused_dropout_add.py:26: y = dropout(x) + residual."""

    def __init__(self, p=0.5, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.mode = mode

    def forward(self, x, y):
        return NF.dropout(x, p=self.p, training=self.training,
                          mode=self.mode) + y

    def extra_repr(self):
        return f"p={self.p}, mode={self.mode}"


class FusedBiasDropoutResidualLayerNorm(Layer):
    """reference fused_transformer.py:94: LN(residual + dropout(x + bias))."""

    def __init__(self, embed_dim, dropout_rate=0.5, weight_attr=None,
                 bias_attr=None, epsilon=1e-5, name=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.dropout_rate = dropout_rate
        self._epsilon = epsilon
        self.linear_bias = self.create_parameter([embed_dim], is_bias=True)
        self.ln_scale = self.create_parameter(
            [embed_dim], attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.ln_bias = self.create_parameter([embed_dim], attr=bias_attr,
                                             is_bias=True)

    def forward(self, x, residual):
        y = NF.dropout(x + self.linear_bias, p=self.dropout_rate,
                       training=self.training)
        return NF.layer_norm(residual + y, [self.embed_dim],
                             weight=self.ln_scale, bias=self.ln_bias,
                             epsilon=self._epsilon)


class FusedMultiHeadAttention(Layer):
    """reference fused_transformer.py:213 (fused_attention kernel)."""

    def __init__(self, embed_dim, num_heads, dropout_rate=0.5,
                 attn_dropout_rate=0.5, kdim=None, vdim=None,
                 normalize_before=False, need_weights=False,
                 qkv_weight_attr=None, qkv_bias_attr=None,
                 linear_weight_attr=None, linear_bias_attr=None,
                 pre_ln_scale_attr=None, pre_ln_bias_attr=None,
                 ln_scale_attr=None, ln_bias_attr=None, epsilon=1e-5,
                 nranks=1, ring_id=-1, name=None):
        super().__init__()
        assert embed_dim % num_heads == 0
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.normalize_before = normalize_before
        self.dropout_rate = dropout_rate
        self.attn_dropout_rate = attn_dropout_rate
        self._epsilon = epsilon
        head_dim = embed_dim // num_heads
        self.qkv_weight = self.create_parameter(
            [3, num_heads, head_dim, embed_dim], attr=qkv_weight_attr,
            default_initializer=I.XavierUniform())
        self.qkv_bias = None if qkv_bias_attr is False else \
            self.create_parameter([3, num_heads, head_dim],
                                  attr=qkv_bias_attr, is_bias=True)
        self.linear_weight = self.create_parameter(
            [embed_dim, embed_dim], attr=linear_weight_attr,
            default_initializer=I.XavierUniform())
        self.linear_bias = None if linear_bias_attr is False else \
            self.create_parameter([embed_dim], attr=linear_bias_attr,
                                  is_bias=True)
        self.pre_ln_scale = self.create_parameter(
            [embed_dim], attr=pre_ln_scale_attr,
            default_initializer=I.Constant(1.0))
        self.pre_ln_bias = self.create_parameter([embed_dim],
                                                 attr=pre_ln_bias_attr,
                                                 is_bias=True)
        self.ln_scale = self.create_parameter(
            [embed_dim], attr=ln_scale_attr,
            default_initializer=I.Constant(1.0))
        self.ln_bias = self.create_parameter([embed_dim], attr=ln_bias_attr,
                                             is_bias=True)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        return F.fused_multi_head_attention(
            query, self.qkv_weight, self.linear_weight,
            pre_layer_norm=self.normalize_before,
            pre_ln_scale=self.pre_ln_scale, pre_ln_bias=self.pre_ln_bias,
            ln_scale=self.ln_scale, ln_bias=self.ln_bias,
            pre_ln_epsilon=self._epsilon, qkv_bias=self.qkv_bias,
            linear_bias=self.linear_bias, attn_mask=attn_mask,
            dropout_rate=self.dropout_rate,
            attn_dropout_rate=self.attn_dropout_rate,
            ln_epsilon=self._epsilon, training=self.training,
            num_heads=self.num_heads)


class FusedFeedForward(Layer):
    """reference fused_transformer.py:534 (fused_feedforward kernel)."""

    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-5, activation="relu", act_dropout_rate=None,
                 normalize_before=False, linear1_weight_attr=None,
                 linear1_bias_attr=None, linear2_weight_attr=None,
                 linear2_bias_attr=None, ln1_scale_attr=None,
                 ln1_bias_attr=None, ln2_scale_attr=None,
                 ln2_bias_attr=None, nranks=1, ring_id=-1, name=None):
        super().__init__()
        self.normalize_before = normalize_before
        self.dropout_rate = dropout_rate
        self.act_dropout_rate = act_dropout_rate if act_dropout_rate is not \
            None else dropout_rate
        self.activation = activation
        self._epsilon = epsilon
        self.linear1_weight = self.create_parameter(
            [d_model, dim_feedforward], attr=linear1_weight_attr,
            default_initializer=I.XavierUniform())
        self.linear1_bias = self.create_parameter([dim_feedforward],
                                                  attr=linear1_bias_attr,
                                                  is_bias=True)
        self.linear2_weight = self.create_parameter(
            [dim_feedforward, d_model], attr=linear2_weight_attr,
            default_initializer=I.XavierUniform())
        self.linear2_bias = self.create_parameter([d_model],
                                                  attr=linear2_bias_attr,
                                                  is_bias=True)
        self.ln1_scale = self.create_parameter(
            [d_model], attr=ln1_scale_attr,
            default_initializer=I.Constant(1.0))
        self.ln1_bias = self.create_parameter([d_model], attr=ln1_bias_attr,
                                              is_bias=True)
        self.ln2_scale = self.create_parameter(
            [d_model], attr=ln2_scale_attr,
            default_initializer=I.Constant(1.0))
        self.ln2_bias = self.create_parameter([d_model], attr=ln2_bias_attr,
                                              is_bias=True)

    def forward(self, src, cache=None):
        return F.fused_feedforward(
            src, self.linear1_weight, self.linear2_weight,
            self.linear1_bias, self.linear2_bias, self.ln1_scale,
            self.ln1_bias, self.ln2_scale, self.ln2_bias,
            dropout1_rate=self.act_dropout_rate,
            dropout2_rate=self.dropout_rate,
            activation=self.activation, ln1_epsilon=self._epsilon,
            ln2_epsilon=self._epsilon,
            pre_layer_norm=self.normalize_before, training=self.training)


class FusedTransformerEncoderLayer(Layer):
    """reference fused_transformer.py:750: fused MHA + fused FFN."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout_rate=0.1,
                 activation="relu", attn_dropout_rate=None,
                 act_dropout_rate=None, normalize_before=False,
                 weight_attr=None, bias_attr=None):
        super().__init__()
        attn_dropout_rate = dropout_rate if attn_dropout_rate is None else \
            attn_dropout_rate
        act_dropout_rate = dropout_rate if act_dropout_rate is None else \
            act_dropout_rate
        self.normalize_before = normalize_before
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate=dropout_rate,
            attn_dropout_rate=attn_dropout_rate,
            normalize_before=normalize_before)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate=dropout_rate,
            activation=activation, act_dropout_rate=act_dropout_rate,
            normalize_before=normalize_before)

    def forward(self, src, src_mask=None, cache=None):
        out = self.fused_attn(src, attn_mask=src_mask)
        return self.ffn(out)


class FusedMultiTransformer(Layer):
    """reference fused_transformer.py:1071 (fused_multi_transformer
    kernel): N pre-LN decoder blocks in one layer object — the serving
    block. Here each block runs through the fused functionals; the
    decode-loop serving engine lives in models/llama.py."""

    def __init__(self, embed_dim, num_heads, dim_feedforward,
                 dropout_rate=0.0, activation="gelu", normalize_before=True,
                 ln_scale_attrs=None, ln_bias_attrs=None, epsilon=1e-5,
                 num_layers=-1, nranks=1, ring_id=-1, name=None):
        super().__init__()
        if num_layers <= 0:
            num_layers = 1
        self.layers = []
        for i in range(num_layers):
            blk = FusedTransformerEncoderLayer(
                embed_dim, num_heads, dim_feedforward,
                dropout_rate=dropout_rate, activation=activation,
                normalize_before=normalize_before)
            self.add_sublayer(f"blk{i}", blk)
            self.layers.append(blk)

    def forward(self, src, attn_mask=None, caches=None):
        out = src
        for blk in self.layers:
            out = blk(out, src_mask=attn_mask)
        return out
