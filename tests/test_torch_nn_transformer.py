"""The port's nn/layer/transformer.py against the reference's, on the
CPU, with the reference's state carried across (``pair``) and fp32
outputs and gradients within rtol 1e-5 (``hold``).

``MultiHeadAttention`` at [2, 128, 2 heads of 64] with no mask (the
flash route: the op ``pallas_flash_attention``, K1-sep / K3-sep's plain
versions here, the reference's Pallas kernels in interpret mode), a
bool mask and an additive mask (the op ``scaled_dot_product_attention``
in both packages); the encoder and decoder layers in both
``normalize_before`` settings; the stacks and ``Transformer`` with
masks; both cache kinds (``Cache``, grown one step at a time, and
``StaticCache``); ``generate_square_subsequent_mask``. The stacks
deep-copy their first layer: the copies start equal to it, own their
storage, and in the port have parameter names of their own (the
reference's keep the original's; ROADMAP Queue 3, defect D).
"""

import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)
import copy

import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as port

from torch_eager_common import (freeze_after_case, frozen_heap,  # noqa: F401
                                reference_ops_restored)
from torch_nn_layer_common import _f, close, hold, pair

E, H, FF = 16, 2, 32            # the small stacks: head dim 8
S = 6                           # their sequences, source and target alike
STEPS = 2                       # cache steps


def _bool_mask(S, T=None):
    m = np.tril(np.ones((S, T or S), bool))
    m[:, 0] = True
    return m


def _additive(B, S, T=None, seed=5):
    return _f(B, 1, S, T or S, seed=seed)


def _routes(pkg, fn):
    seen = []
    pkg.core.dispatch.DISPATCH_HOOKS.append(seen.append)
    try:
        fn()
    finally:
        pkg.core.dispatch.DISPATCH_HOOKS.remove(seen.append)
    return [s for s in seen if s in ("pallas_flash_attention",
                                     "scaled_dot_product_attention")]


@pytest.mark.parametrize("mask", [None, "bool", "additive"])
def test_multi_head_attention_routes(mask):
    B, S = 2, 128
    rl, pl = pair("MultiHeadAttention", 128, 2)
    x = _f(B, S, 128)
    m = {None: None, "bool": _bool_mask(S),
         "additive": _additive(B, S)}[mask]
    want = (["pallas_flash_attention"] if mask is None
            else ["scaled_dot_product_attention"])
    for pkg, layer in ((ref, rl), (port, pl)):
        mt = None if m is None else pkg.to_tensor(m)
        assert _routes(pkg, lambda: layer(pkg.to_tensor(x), None, None,
                                          mt)) == want, pkg.__name__
    inputs = [x] if m is None else [x, None, None, m]
    hold(rl, pl, inputs, train=True, what=f"mha mask={mask}")


def test_multi_head_attention_kdim_vdim_cross():
    rl, pl = pair("MultiHeadAttention", E, H, kdim=6, vdim=10)
    hold(rl, pl, [_f(2, S, E), _f(2, S, 6, seed=1), _f(2, S, 10, seed=2),
                  _bool_mask(S)], what="cross attention")


@pytest.mark.parametrize("normalize_before", [False, True])
def test_encoder_and_decoder_layers(normalize_before):
    rl, pl = pair("TransformerEncoderLayer", E, H, FF, dropout=0.0,
                  activation="gelu", normalize_before=normalize_before)
    hold(rl, pl, [_f(2, S, E), _additive(2, S)], train=True,
         what=f"encoder layer nb={normalize_before}")
    rl, pl = pair("TransformerDecoderLayer", E, H, FF, dropout=0.0,
                  normalize_before=normalize_before)
    hold(rl, pl, [_f(2, S, E), _f(2, S, E, seed=1), _bool_mask(S),
                  _additive(2, S)], train=True,
         what=f"decoder layer nb={normalize_before}")


def _nested(x):
    if isinstance(x, (list, tuple)):
        return [y for z in x for y in _nested(z)]
    return [x]


def _hold_nested(r, p, what):
    r, p = _nested(r), _nested(p)
    assert len(p) == len(r), what
    for j, (a, b) in enumerate(zip(p, r)):
        close(a.numpy(), b.numpy(), f"{what} {j}")


def test_encoder_stack_incremental_cache():
    rl, pl = pair("TransformerEncoder", lambda pkg: pkg.nn.
                  TransformerEncoderLayer(E, H, FF, dropout=0.0), 2,
                  norm=lambda pkg: pkg.nn.LayerNorm(E))
    hold(rl, pl, [_f(2, S, E), _bool_mask(S)], train=True,
         what="encoder stack")
    steps = [_f(2, 1, E, seed=s) for s in range(STEPS)]
    outs = []
    for pkg, layer in ((ref, rl), (port, pl)):
        layer.eval()
        cache = layer.gen_cache(pkg.to_tensor(steps[0]))
        got = []
        for x in steps:
            y, cache = layer(pkg.to_tensor(x), None, cache)
            got.append([y, cache])
        outs.append(got)
    _hold_nested(outs[0], outs[1], "encoder cache steps")


@pytest.mark.parametrize("normalize_before", [False, True])
def test_decoder_stack_both_caches(normalize_before):
    rl, pl = pair("TransformerDecoder", lambda pkg: pkg.nn.
                  TransformerDecoderLayer(E, H, FF, dropout=0.0,
                                          normalize_before=normalize_before),
                  2, norm=lambda pkg: pkg.nn.LayerNorm(E))
    memory = _f(2, S, E, seed=9)
    hold(rl, pl, [_f(2, S, E), memory, _bool_mask(S)], train=True,
         what="decoder stack")
    steps = [_f(2, 1, E, seed=s) for s in range(STEPS)]
    outs = []
    for pkg, layer in ((ref, rl), (port, pl)):
        layer.eval()
        mem = pkg.to_tensor(memory)
        cache = layer.gen_cache(mem)
        kinds = [(type(a).__name__, type(b).__name__) for a, b in cache]
        assert kinds == [("Cache", "StaticCache")] * 2
        got = []
        for x in steps:
            y, cache = layer(pkg.to_tensor(x), mem, None, None, cache)
            got.append([y, cache])
        outs.append(got)
        zipped = layer.gen_cache(mem, do_zip=True)
        assert len(zipped) == 2 and len(zipped[0]) == 2
    _hold_nested(outs[0], outs[1], "decoder cache steps")


def test_static_cache_of_multi_head_attention():
    rl, pl = pair("MultiHeadAttention", E, H)
    mem, q = _f(2, S, E, seed=3), _f(2, 1, E, seed=4)
    outs = []
    for pkg, layer in ((ref, rl), (port, pl)):
        c = layer.gen_cache(pkg.to_tensor(mem),
                            type=pkg.nn.MultiHeadAttention.StaticCache)
        outs.append(layer(pkg.to_tensor(q), pkg.to_tensor(mem),
                          pkg.to_tensor(mem), None, c))
    _hold_nested(outs[0], outs[1], "static cache")


@pytest.mark.parametrize("normalize_before", [False, True])
def test_transformer(normalize_before):
    rl, pl = pair("Transformer", E, H, 2, 2, FF, dropout=0.0,
                  normalize_before=normalize_before)
    assert len(pl.state_dict()) == len(rl.state_dict()) == 88
    rm = rl.generate_square_subsequent_mask(S)
    pm = pl.generate_square_subsequent_mask(S)
    close(pm.numpy(), rm.numpy(), "square subsequent mask")
    hold(rl, pl, [_f(2, S, E), _f(2, S, E, seed=1), _bool_mask(S),
                  rm.numpy()], train=True, what="transformer")


def test_stack_copies_start_equal_and_own_their_storage():
    layer = port.nn.TransformerEncoderLayer(E, H, FF)
    enc = port.nn.TransformerEncoder(layer, 3)
    per = len(layer.parameters())
    ps = enc.parameters()
    assert len(ps) == 3 * per
    # fresh names, equal values, distinct storage, the same flags
    assert len({p.name for p in ps}) == len(ps)
    for i in (1, 2):
        for a, b in zip(enc.layers[0].parameters(),
                        enc.layers[i].parameters()):
            assert isinstance(b, port.Parameter)
            np.testing.assert_array_equal(a.numpy(), b.numpy())
            assert a._data.data_ptr() != b._data.data_ptr()
            assert (a.stop_gradient, a.trainable, a.need_clip) == (
                b.stop_gradient, b.trainable, b.need_clip)
    # each copy reaches the optimizer and moves on its own
    opt = port.optimizer.AdamW(learning_rate=1e-2, parameters=ps)
    x = port.to_tensor(_f(2, S, E))
    (enc.layers[1](x) ** 2).mean().backward()
    opt.step()
    assert len(opt.state_dict()["state"]) == per
    assert not np.array_equal(enc.layers[0].linear1.weight.numpy(),
                              enc.layers[1].linear1.weight.numpy())
    # the reference's copies keep the original's names (defect D)
    rlayer = ref.nn.TransformerEncoderLayer(E, H, FF)
    renc = ref.nn.TransformerEncoder(rlayer, 3)
    assert len({p.name for p in renc.parameters()}) == per


def test_deepcopy_of_a_parameter_and_a_tensor():
    p = port.Parameter(torch.randn(3, 2).to(torch.bfloat16), trainable=True)
    p.optimize_attr["learning_rate"] = 0.5
    p.need_clip = False
    q = copy.deepcopy(p)
    assert type(q) is port.Parameter and q.name != p.name
    assert q.dtype == torch.bfloat16 and torch.equal(q._data, p._data)
    assert q._data.data_ptr() != p._data.data_ptr()
    assert (q.optimize_attr, q.need_clip, q.stop_gradient) == (
        {"learning_rate": 0.5}, False, False)
    frozen = port.Parameter(torch.ones(2), trainable=False)
    assert copy.deepcopy(frozen).stop_gradient
    t = port.to_tensor(np.ones(3, np.float32))
    t.name = "buf"
    u = copy.deepcopy(t)
    assert type(u) is port.Tensor and u.name == "buf"
    assert u._data.data_ptr() != t._data.data_ptr()
