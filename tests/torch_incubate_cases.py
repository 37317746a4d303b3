"""The incubate cases (incubate/nn/functional: its ops, its functions and
the fused_parity tranche), in numpy only: the CPU tests hold each port
op and function against the reference's on them
(tests/test_torch_fused_parity.py, test_torch_incubate_functional.py),
and chip_smoke.py's phase ``incubate`` holds each on the card against
the same port op or function on the CPU. Nothing here imports JAX.

``OP_CASES`` maps a registered op name to its cases and ``FUNC_CASES``
a function name of ``incubate.nn.functional`` to its cases, each case
(case id, factory, options) as in tests/torch_ops_cases.py: the factory
returns (args, kwargs) with numpy arrays standing for tensors, ``None``
for the op contract's own case, a (lo, hi) pair for the contract's
shapes with data uniform over that domain; the options go to the
comparison. ``FLASH`` marks a case on the flash route (K1-sep on the
card, its plain version on the CPU), held at ``FLASH_RTOL`` of the
output's largest magnitude: two fp32 softmaxes summed in other orders.
The random ops (``fused_dropout_add`` and
``fused_bias_dropout_residual_layer_norm`` with a rate) have cases only
where no mask is drawn; their draws are held by property elsewhere.
"""

import numpy as np

from torch_ops_cases import f32, i32

FLASH_RTOL = 2e-6
FLASH = {"fwd_rtol": FLASH_RTOL}


def _pos(*shape, seed=0):
    return f32(*shape, seed=seed, lo=0.5, hi=1.5)


def _bn(c, seed):
    """scale, bias, mean, variance (positive) of ``c`` channels."""
    return [f32(c, seed=seed), f32(c, seed=seed + 1), f32(c, seed=seed + 2),
            _pos(c, seed=seed + 3)]


def _qkv(B, S, h, d, seed=0, scale=1.0):
    return [(f32(B, S, h, d, seed=seed + i) * scale).astype(np.float32)
            for i in range(3)]


OP_CASES = {
    # incubate.nn.functional's own ops
    "fused_rms_norm": [
        ("contract", None, {}),
        ("residual", lambda: ([f32(2, 5, 8), f32(8, seed=1)],
                              {"norm_bias": f32(8, seed=2),
                               "bias": f32(8, seed=3),
                               "residual": f32(2, 5, 8, seed=4)}), {})],
    "fused_layer_norm": [
        ("contract", None, {}),
        ("residual", lambda: ([f32(2, 5, 8), f32(8, seed=1), f32(8, seed=2)],
                              {"bias": f32(8, seed=3),
                               "residual": f32(2, 5, 8, seed=4),
                               "epsilon": 1e-6}), {})],
    "fused_rotary_position_embedding": [
        ("neox", lambda: (_qkv(2, 5, 2, 8), {}), {}),
        ("interleaved", lambda: (_qkv(2, 5, 2, 8),
                                 {"use_neox_rotary_style": False}), {}),
        ("q_only_base", lambda: ([f32(1, 6, 3, 16)],
                                 {"rotary_emb_base": 500000.0}), {}),
        ("cos_sin_td", lambda: (_qkv(2, 5, 2, 8)[:2],
                                {"cos": f32(5, 8, seed=7),
                                 "sin": f32(5, 8, seed=8)}), {}),
        ("cos_sin_t1d", lambda: (_qkv(2, 5, 2, 8)[:2],
                                 {"cos": f32(5, 1, 8, seed=7),
                                  "sin": f32(5, 1, 8, seed=8)}), {}),
        ("position_ids", lambda: (_qkv(2, 5, 2, 8)[:2],
                                  {"position_ids": np.array(
                                      [[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]],
                                      np.int32)}), {})],
    "fused_bias_act": [
        ("contract", None, {}),
        ("geglu", lambda: ([f32(3, 8), f32(8, seed=1)],
                           {"act_method": "geglu"}), {}),
        ("swiglu", lambda: ([f32(3, 8), f32(8, seed=1)],
                            {"act_method": "swiglu"}), {}),
        ("relu_none", lambda: ([f32(3, 8)], {"act_method": "relu"}), {}),
        ("identity", lambda: ([f32(3, 8), f32(8, seed=1)],
                              {"act_method": "none"}), {})],
    # fused_parity
    "fc": [("contract", None, {}),
           ("bias_gelu", lambda: ([f32(2, 4, 3), f32(3, 5, seed=1),
                                   f32(5, seed=2)],
                                  {"activation_type": "gelu"}), {})],
    "fused_elementwise_add": [("contract", None, {}),
                              ("relu", lambda: ([f32(2, 3), f32(3, seed=1)],
                                                {"act": "relu"}), {})],
    "fused_elementwise_sub": [("tanh", lambda: ([f32(2, 3), f32(2, 3,
                                                               seed=1)],
                                                {"act": "tanh"}), {})],
    "fused_elementwise_mul": [("sigmoid", lambda: ([f32(2, 3),
                                                    f32(2, 3, seed=1)],
                                                   {"act": "sigmoid"}), {})],
    "fused_elementwise_div": [("silu", lambda: ([f32(2, 3),
                                                 _pos(2, 3, seed=1)],
                                                {"act": "silu"}), {})],
    "fused_elemwise_activation": [
        ("contract", None, {}),
        ("mul_tanh", lambda: ([f32(2, 3), f32(2, 3, seed=1)],
                              {"functor_list": ("elementwise_mul", "tanh")}),
         {})],
    "fused_elemwise_add_activation": [
        ("contract", None, {}),
        ("gelu", lambda: ([f32(2, 3), f32(2, 3, seed=1)], {"act": "gelu"}),
         {})],
    "fused_dropout_add": [
        ("eval", lambda: ([f32(2, 3), f32(2, 3, seed=1)],
                          {"training": False}), {}),
        ("p0", lambda: ([f32(2, 3), f32(2, 3, seed=1)], {"p": 0.0}), {})],
    "fused_bias_dropout_residual_layer_norm": [
        ("rate0", lambda: ([f32(2, 4, 6), f32(2, 4, 6, seed=1)],
                           {"bias": f32(6, seed=2), "ln_scale": f32(6, seed=3),
                            "ln_bias": f32(6, seed=4), "dropout_rate": 0.0}),
         {}),
        ("eval", lambda: ([f32(2, 6), f32(2, 6, seed=1)],
                          {"training": False}), {})],
    "fused_bias_residual_layernorm": [
        ("contract", None, {}),
        ("full", lambda: ([f32(2, 6)], {"residual": f32(2, 6, seed=1),
                                        "bias": f32(6, seed=2),
                                        "norm_weight": f32(6, seed=3),
                                        "norm_bias": f32(6, seed=4),
                                        "residual_alpha": 0.5}), {})],
    "skip_layernorm": [("contract", None, {}),
                       ("affine", lambda: ([f32(2, 6), f32(2, 6, seed=1),
                                            f32(6, seed=2), f32(6, seed=3)],
                                           {}), {})],
    "fused_embedding_eltwise_layernorm": [
        ("contract", None, {}),
        ("tables", lambda: ([[np.array([[1, 0, 3], [2, 2, 0]], np.int32),
                              np.array([[0, 1, 1], [4, 0, 2]], np.int32)],
                             [f32(4, 6), f32(5, 6, seed=1)],
                             f32(6, seed=2), f32(6, seed=3)], {}), {})],
    "fused_fc_elementwise_layernorm": [
        ("contract", None, {}),
        ("full", lambda: ([f32(3, 4), f32(4, 6, seed=1), f32(3, 6, seed=2)],
                          {"bias0": f32(6, seed=3), "scale": f32(6, seed=4),
                           "bias1": f32(6, seed=5)}), {})],
    "multihead_matmul": [
        ("heads", lambda: ([f32(2, 5, 8), f32(8, 24, seed=1) * 0.3],
                           {"bias": f32(24, seed=2),
                            "bias_qk": f32(2, 2, 5, 5, seed=3),
                            "head_number": 2}), {})],
    "self_dp_attention": [
        ("packed", lambda: ([f32(2, 5, 3, 2, 4)],
                            {"head_number": 2, "alpha": 0.5}), {})],
    "fused_dot_product_attention": [
        ("mask", lambda: (_qkv(2, 6, 2, 8),
                          {"mask": f32(2, 2, 6, 6, seed=5)}), {}),
        ("causal_scale", lambda: (_qkv(2, 6, 2, 8),
                                  {"causal": True, "scale": 0.3}), {}),
        ("flash_causal", lambda: (_qkv(1, 128, 2, 64, scale=0.5),
                                  {"causal": True}), FLASH)],
    "fused_conv2d_add_act": [
        ("residual", lambda: ([f32(1, 3, 6, 6), f32(4, 3, 3, 3, seed=1)],
                              {"residual": f32(1, 4, 4, 4, seed=2),
                               "bias": f32(4, seed=3)}), {}),
        ("padded_gelu", lambda: ([f32(2, 2, 5, 5), f32(4, 1, 3, 3, seed=1)],
                                 {"strides": (2, 2), "paddings": (1, 1),
                                  "groups": 2, "activation": "gelu"}), {})],
    "fused_scale_bias_add_relu": [
        ("contract", None, {}),
        ("scaled", lambda: ([f32(2, 3), f32(3, seed=1), f32(3, seed=2),
                             f32(2, 3, seed=3), f32(3, seed=4),
                             f32(3, seed=5)], {}), {})],
    "add_group_norm_silu": [
        ("groups", lambda: ([f32(2, 4, 3, 3)],
                            {"residual": f32(2, 4, 3, 3, seed=1),
                             "scale": f32(4, seed=2), "bias": f32(4, seed=3),
                             "groups": 2}), {})],
    "fused_batch_norm_act": [
        ("contract", (0.5, 1.5), {}),
        ("nchw", lambda: ([f32(2, 3, 4, 4)] + _bn(3, 1),
                          {"act_type": "tanh"}), {})],
    "fused_bn_add_activation": [
        ("contract", (0.5, 1.5), {}),
        ("nchw", lambda: ([f32(2, 3, 4, 4), f32(2, 3, 4, 4, seed=9)]
                          + _bn(3, 1), {}), {})],
    "max_pool2d_v2": [
        ("k2", lambda: ([f32(1, 2, 6, 6)], {"kernel_size": 2}), {}),
        ("pad", lambda: ([f32(1, 2, 7, 7)], {"kernel_size": 3, "stride": 2,
                                             "padding": 1}), {})],
    "resnet_unit": [
        ("plain", lambda: ([f32(1, 3, 6, 6), f32(4, 3, 3, 3, seed=1)]
                           + _bn(4, 2), {}), {}),
        ("shortcut", lambda: ([f32(1, 3, 6, 6), f32(4, 3, 3, 3, seed=1)]
                              + _bn(4, 2),
                              {"z": f32(1, 3, 6, 6, seed=7),
                               "filter_z": f32(4, 3, 1, 1, seed=8),
                               "scale_z": f32(4, seed=10),
                               "bias_z": f32(4, seed=11),
                               "mean_z": f32(4, seed=12),
                               "var_z": _pos(4, seed=13), "stride": 2}), {})],
    "resnet_basic_block": [
        ("identity", lambda: ([f32(1, 4, 5, 5), f32(4, 4, 3, 3, seed=1)]
                              + _bn(4, 2) + [f32(4, 4, 3, 3, seed=6)]
                              + _bn(4, 7), {}), {})],
    "squeeze_excitation_block": [
        ("se", lambda: ([f32(2, 4, 3, 3), f32(4, 2, seed=1), f32(2, seed=2),
                         f32(2, 4, seed=3), f32(4, seed=4)], {}), {})],
    "fusion_repeated_fc_relu": [
        ("contract", None, {}),
        ("list", lambda: ([f32(2, 3), [f32(3, 4, seed=1), f32(4, 2, seed=2)],
                           [f32(4, seed=3), f32(2, seed=4)]], {}), {})],
    "fusion_squared_mat_sub": [
        ("contract", None, {}),
        ("scalar", lambda: ([f32(2, 3), f32(3, 4, seed=1)],
                            {"scalar": 0.5}), {})],
    "fusion_transpose_flatten_concat": [
        ("nchw", lambda: ([[f32(2, 3, 4, 5), f32(2, 3, 4, 5, seed=1)],
                           (0, 2, 3, 1)], {"flatten_axis": 1,
                                           "concat_axis": 1}), {})],
    "fused_token_prune": [
        ("contract", None, {}),
        ("heads_mask", lambda: ([f32(2, 2, 6, 6), f32(2, 6, 4, seed=1)],
                                {"new_mask": f32(2, 2, 3, 3, seed=2),
                                 "keep_order": False}), {}),
        ("ties", lambda: ([np.ones((2, 6, 6), np.float32),
                           f32(2, 6, 4, seed=1)],
                          {"keep_first_token": False}), {})],
    "qkv_unpack_mha": [
        ("mask", lambda: (_qkv(2, 5, 2, 4),
                          {"src_mask": f32(2, 2, 5, 5, seed=5)}), {})],
    "blha_get_max_len": [("contract", None, {}),
                         ("ints", lambda: ([i32(3, 9, 2), i32(0, 4, 7)], {}),
                          {})],
    "fused_softmax_mask": [
        ("contract", None, {}),
        ("heads", lambda: ([f32(2, 2, 4, 4), f32(2, 1, 4, 4, seed=1)], {}),
         {})],
    "fused_softmax_mask_upper_triangle": [
        ("contract", None, {}),
        ("rect", lambda: ([f32(2, 2, 4, 6)], {}), {})],
    "fused_scale_bias_relu_conv_bn": [
        ("conv", lambda: ([f32(1, 3, 5, 5), f32(4, 3, 3, 3, seed=1),
                           f32(3, seed=2), f32(3, seed=3)] + _bn(4, 4), {}),
         {})],
}


def _int8(*shape, seed=0):
    return np.clip(np.round(f32(*shape, seed=seed) * 50), -127, 127) \
        .astype(np.int8)


FUNC_CASES = {
    "swiglu": [("split", lambda: ([f32(3, 8)], {}), {}),
               ("pair", lambda: ([f32(3, 4), f32(3, 4, seed=1)], {}), {})],
    "fused_linear": [
        ("plain", lambda: ([f32(3, 4), f32(4, 5, seed=1), f32(5, seed=2)],
                           {}), {}),
        ("transpose", lambda: ([f32(3, 4), f32(5, 4, seed=1)],
                               {"transpose_weight": True}), {})],
    "fused_linear_activation": [
        ("gelu", lambda: ([f32(3, 4), f32(4, 5, seed=1), f32(5, seed=2)], {}),
         {}),
        ("relu_trans", lambda: ([f32(3, 4), f32(5, 4, seed=1),
                                 f32(5, seed=2)],
                                {"trans_y": True, "activation": "relu"}),
         {})],
    "fused_feedforward": [
        ("post_ln", lambda: ([f32(2, 3, 4), f32(4, 8, seed=1),
                              f32(8, 4, seed=2), f32(8, seed=3),
                              f32(4, seed=4), f32(4, seed=5), f32(4, seed=6),
                              f32(4, seed=7), f32(4, seed=8)],
                             {"training": False}), {}),
        ("pre_ln_gelu", lambda: ([f32(2, 3, 4), f32(4, 8, seed=1),
                                  f32(8, 4, seed=2)],
                                 {"ln1_scale": f32(4, seed=6),
                                  "ln1_bias": f32(4, seed=7),
                                  "dropout1_rate": 0.0, "dropout2_rate": 0.0,
                                  "activation": "gelu",
                                  "pre_layer_norm": True}), {})],
    "fused_multi_head_attention": [
        ("post_ln", lambda: ([f32(2, 5, 8), f32(3, 2, 4, 8, seed=1) * 0.4,
                              f32(8, 8, seed=2) * 0.4],
                             {"qkv_bias": f32(3, 2, 4, seed=3),
                              "linear_bias": f32(8, seed=4),
                              "ln_scale": f32(8, seed=5),
                              "ln_bias": f32(8, seed=6), "training": False}),
         {}),
        ("pre_ln_mask", lambda: ([f32(2, 5, 8), f32(3, 2, 4, 8, seed=1) * 0.4,
                                  f32(8, 8, seed=2) * 0.4],
                                 {"pre_layer_norm": True,
                                  "pre_ln_scale": f32(8, seed=5),
                                  "pre_ln_bias": f32(8, seed=6),
                                  "attn_mask": f32(2, 2, 5, 5, seed=7),
                                  "training": False}), {})],
    "memory_efficient_attention": [
        ("bias", lambda: (_qkv(2, 5, 2, 4),
                          {"attn_bias": f32(2, 2, 5, 5, seed=5)}), {}),
        ("flash", lambda: (_qkv(1, 128, 2, 64, scale=0.5), {}), FLASH)],
    "variable_length_memory_efficient_attention": [
        ("plain", lambda: (_qkv(2, 5, 2, 4), {}), {})],
    "masked_multihead_attention": [
        ("lengths", lambda: ([f32(3, 3 * 2 * 8),
                              f32(2, 3, 2, 6, 8, seed=1)],
                             {"sequence_lengths": i32(0, 3, 5)}),
         {"differentiable": False}),
        ("zeros", lambda: ([f32(2, 3 * 2 * 8), f32(2, 2, 2, 4, 8, seed=1)],
                           {}), {"differentiable": False})],
    "weight_quantize": [("w", lambda: ([f32(16, 8)], {}),
                         {"differentiable": False})],
    "weight_dequantize": [("q", lambda: ([_int8(16, 8),
                                          _pos(8) * 0.01], {}),
                           {"differentiable": False})],
    "weight_only_linear": [
        ("bias", lambda: ([f32(4, 16), _int8(16, 8)],
                          {"bias": f32(8, seed=2),
                           "weight_scale": _pos(8) * 0.01}), {})],
    "fused_moe": [
        ("top2", lambda: ([f32(2, 4, 8), f32(8, 4, seed=1),
                           f32(4, 8, 16, seed=2) * 0.3,
                           f32(4, 16, 8, seed=3) * 0.3],
                          {"ffn1_bias": f32(4, 16, seed=4),
                           "ffn2_bias": f32(4, 8, seed=5)}), {})],
}
