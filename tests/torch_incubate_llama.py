"""LLaMA inference written from the incubate functionals, as a Paddle user
writes it (BASELINE.md configuration 5, "LLaMA-2 7B fused inference"):
test code that names no JAX and no torch, only the package it is given
(``paddle_tpu`` or ``paddle_tpu_torch``), so that both run the same
composition. chip_smoke.py's phase ``incubate`` runs it at llama2-7b
on the card; the CPU tests run it at 2 layers in both packages.

Prefill, a layer: ``fused_rms_norm`` (folding the residual add from the
second norm on), the q / k / v products, ``fused_rotary_position_
embedding`` (rotate-half, the model's ``rope_theta``),
``fused_dot_product_attention(causal=True)`` (the flash forward where
its gate holds), the output product, the FFN norm, one gate|up product
and ``fused_bias_act(act_method="swiglu")``, the down product; the
rotated k and v go into the layer's cache [2, B, nH, S, dH]. A decode
step: the same ops on one token a row, the rotated q, k, v packed as
[B, 3 nH dH] into ``masked_multihead_attention`` at each row's position
(``sequence_lengths``). Logits are the head product cast to float32.

The weights are the llama parameter tree's (``init_llama_params`` /
``params_from_jax``: stacked ``blocks.*`` leaves), one dict a layer, the
gate and up weights concatenated; ``quantize=True`` replaces every
linear weight with ``weight_quantize``'s (int8, scales) pair, run
through ``weight_only_linear`` and cast back to the activations' dtype.
Every product goes through ``linear``, so a caller can wrap it (the
card's profile of a decode step does).
"""

_LINEARS = ("wq", "wk", "wv", "wo", "w_gateup", "w_down")


def weights(pkg, params, n_layers, quantize=False):
    """Per-layer weights of a llama parameter tree (leaves the package's
    ``to_tensor`` takes) as the package's Tensors."""
    F = pkg.incubate.nn.functional
    T = pkg.to_tensor
    b = params["blocks"]
    layers = []
    for i in range(n_layers):
        lw = {"attn_norm": T(b["attn_norm"][i]),
              "ffn_norm": T(b["ffn_norm"][i]),
              "wq": T(b["wq"][i]), "wk": T(b["wk"][i]), "wv": T(b["wv"][i]),
              "wo": T(b["wo"][i]), "w_down": T(b["w_down"][i]),
              "w_gateup": pkg.concat([T(b["w_gate"][i]), T(b["w_up"][i])],
                                     axis=-1)}
        if quantize:
            for name in _LINEARS:
                lw[name] = F.weight_quantize(lw[name])
        layers.append(lw)
    head = T(params["head"])
    return {"wte": T(params["wte"]), "final_norm": T(params["final_norm"]),
            "head": F.weight_quantize(head) if quantize else head,
            "layers": layers}


def linear(F, h, w):
    """h @ w, or through ``weight_only_linear`` for an (int8, scales)
    pair, in h's dtype."""
    if isinstance(w, tuple):
        return F.weight_only_linear(h, w[0], weight_scale=w[1]).astype(
            h.dtype)
    return h.matmul(w)


def _ffn(F, h, lw):
    act = F.fused_bias_act(linear(F, h, lw["w_gateup"]), act_method="swiglu")
    return linear(F, act, lw["w_down"])


def caches(pkg, cfg, B, max_seq, dtype, n_layers):
    """One zero cache [2, B, nH, max_seq, dH] a layer."""
    return [pkg.zeros([2, B, cfg.n_heads, max_seq, cfg.head_dim], dtype)
            for _ in range(n_layers)]


def prefill(pkg, w, tokens, cfg, kv):
    """Logits [B, V] float32 of the prompt's last position; the layers'
    rotated k and v written into ``kv`` at positions 0..T-1."""
    F = pkg.incubate.nn.functional
    B, T = tokens.shape
    nH, dH, eps = cfg.n_heads, cfg.head_dim, cfg.rms_eps
    x = pkg.nn.functional.embedding(tokens, w["wte"])
    residual, branch = x, None
    for i, lw in enumerate(w["layers"]):
        if branch is None:
            h = F.fused_rms_norm(x, lw["attn_norm"], epsilon=eps)
        else:
            h, residual = F.fused_rms_norm(branch, lw["attn_norm"],
                                           epsilon=eps, residual=residual)
        q = linear(F, h, lw["wq"]).reshape([B, T, nH, dH])
        k = linear(F, h, lw["wk"]).reshape([B, T, nH, dH])
        v = linear(F, h, lw["wv"]).reshape([B, T, nH, dH])
        q, k, _ = F.fused_rotary_position_embedding(
            q, k, None, use_neox_rotary_style=True,
            rotary_emb_base=cfg.rope_theta)
        o = F.fused_dot_product_attention(q, k, v, causal=True)
        kv[i][0, :, :, :T] = k.transpose([0, 2, 1, 3])
        kv[i][1, :, :, :T] = v.transpose([0, 2, 1, 3])
        attn = linear(F, o.reshape([B, T, nH * dH]), lw["wo"])
        h, residual = F.fused_rms_norm(attn, lw["ffn_norm"], epsilon=eps,
                                       residual=residual)
        branch = _ffn(F, h, lw)
    h, _ = F.fused_rms_norm(branch, w["final_norm"], epsilon=eps,
                            residual=residual)
    return linear(F, h[:, -1], w["head"]).astype("float32")


def decode_step(pkg, w, tok, pos, cfg, kv):
    """Logits [B, V] float32 of one token a row (``tok`` int [B]) at
    position ``pos`` of every row; writes each layer's k and v there."""
    F = pkg.incubate.nn.functional
    B = tok.shape[0]
    nH, dH, eps = cfg.n_heads, cfg.head_dim, cfg.rms_eps
    H = nH * dH
    lens = pkg.full([B], pos, "int32")
    pid = pkg.full([B, 1], pos, "int32")
    x = pkg.nn.functional.embedding(tok, w["wte"])
    residual, branch = x, None
    for i, lw in enumerate(w["layers"]):
        if branch is None:
            h = F.fused_rms_norm(x, lw["attn_norm"], epsilon=eps)
        else:
            h, residual = F.fused_rms_norm(branch, lw["attn_norm"],
                                           epsilon=eps, residual=residual)
        q = linear(F, h, lw["wq"]).reshape([B, 1, nH, dH])
        k = linear(F, h, lw["wk"]).reshape([B, 1, nH, dH])
        v = linear(F, h, lw["wv"])
        q, k, _ = F.fused_rotary_position_embedding(
            q, k, None, position_ids=pid, use_neox_rotary_style=True,
            rotary_emb_base=cfg.rope_theta)
        qkv = pkg.concat([q.reshape([B, H]), k.reshape([B, H]), v], axis=-1)
        o, kv[i] = F.masked_multihead_attention(qkv, cache_kv=kv[i],
                                                sequence_lengths=lens)
        attn = linear(F, o, lw["wo"])
        h, residual = F.fused_rms_norm(attn, lw["ffn_norm"], epsilon=eps,
                                       residual=residual)
        branch = _ffn(F, h, lw)
    h, _ = F.fused_rms_norm(branch, w["final_norm"], epsilon=eps,
                            residual=residual)
    return linear(F, h, w["head"]).astype("float32")


def generate(pkg, w, tokens, cfg, max_new, max_seq, dtype, on_logits=None):
    """Greedy decoding: the prefill's pick, then ``max_new - 1`` decode
    steps. Returns (the picks, ``max_new`` int32 Tensors [B], and the
    caches); ``on_logits(step, logits)`` sees every step's logits before
    its pick."""
    B, T = tokens.shape
    kv = caches(pkg, cfg, B, max_seq, dtype, len(w["layers"]))
    logits = prefill(pkg, w, tokens, cfg, kv)
    picks = []
    for s in range(max_new):
        if s:
            logits = decode_step(pkg, w, picks[-1], T + s - 1, cfg, kv)
        if on_logits is not None:
            on_logits(s, logits)
        picks.append(pkg.argmax(logits, axis=-1).astype("int32"))
    return picks, kv
