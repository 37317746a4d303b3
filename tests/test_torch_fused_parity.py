"""Every op of the port's incubate/nn/functional/fused_parity.py against the
reference's (paddle_tpu/incubate/nn/functional/fused_parity.py), on the
CPU.

The cases are tests/torch_incubate_cases.py's (the op contracts' where
those run on data, else written). The bar: fp32 outputs within rtol 1e-6
of the reference (1e-6 of the largest magnitude for entries that cancel),
integer outputs exact, the vjp of a seeded cotangent within rtol 1e-5;
the flash route (``fused_dot_product_attention`` with no mask at S 128,
d 64: the port's plain version of K1-sep against the reference's flash
path) at 2e-6 of the output's largest magnitude, as ops/parity.py's
packed flash entry (tests/test_torch_ops_parity.py): two fp32 softmaxes
summed in other orders. The dropout ops draw from each package's own
generator and are held by their distribution and by the port's own
draws.
"""

import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu.incubate.nn.functional.fused_parity as ref_fp
import paddle_tpu_torch as port
import paddle_tpu_torch.incubate.nn.functional.fused_parity as port_fp
from paddle_tpu.core.dispatch import OpDef as RefOpDef

from torch_eager_common import freeze_after_case, frozen_heap  # noqa: F401
from torch_incubate_cases import OP_CASES
from torch_ops_cases import contract_case, f32
from torch_ops_common import hold, npy, opdef, reference_op_flags, wrappers

port.set_device("cpu")

REF_OPS = wrappers(ref_fp)
PORT_OPS = wrappers(port_fp)
_PARAMS = [(name, cid) for name in sorted(REF_OPS)
           for cid, _, _ in OP_CASES[name]]


def test_fused_parity_registrations_are_the_references():
    """34 ops: the 31 of ``__all__`` and fused_softmax_mask,
    fused_softmax_mask_upper_triangle, fused_scale_bias_relu_conv_bn;
    each with the reference's ``differentiable`` flag and AMP policy, and
    every one with at least one case."""
    flags = reference_op_flags(
        "paddle_tpu/incubate/nn/functional/fused_parity.py")
    assert len(flags) == 34
    assert set(flags) == set(REF_OPS) == set(PORT_OPS)
    assert port_fp.__all__ == ref_fp.__all__
    assert set(flags) - set(ref_fp.__all__) == {
        "fused_softmax_mask", "fused_softmax_mask_upper_triangle",
        "fused_scale_bias_relu_conv_bn"}
    assert all(OP_CASES[n] for n in flags)
    for name, (diff, amp) in flags.items():
        p = port.OP_REGISTRY[name]
        assert (p.differentiable, p.amp_policy) == (diff, amp), name


@pytest.mark.parametrize("name,cid", _PARAMS)
def test_fused_parity_op_against_reference(name, cid):
    factory, opts = next((f, o) for c, f, o in OP_CASES[name] if c == cid)
    r_def = opdef(REF_OPS[name], RefOpDef)
    if factory is None or isinstance(factory, tuple):
        case = contract_case(name, r_def.impl, domain=factory)
    else:
        case = factory()
    opts = {"differentiable": r_def.differentiable, **opts}
    hold(REF_OPS[name], PORT_OPS[name], case, name=f"{name}[{cid}]", **opts)


def test_fused_dot_product_attention_routes():
    """No mask and a shape the flash gate takes: flash_attention_raw (its
    native layout counted in RAW_ROUTES on any device); a mask or a
    shape the gate refuses: the masked expression."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    q, k, v = (port.to_tensor(f32(1, 128, 2, 64, seed=s)) for s in range(3))
    before = fa.RAW_ROUTES["native"]
    port_fp.fused_dot_product_attention(q, k, v, causal=True)
    assert fa.RAW_ROUTES["native"] == before + 1
    mask = port.to_tensor(f32(1, 2, 128, 128, seed=4))
    port_fp.fused_dot_product_attention(q, k, v, mask=mask)
    small = port.to_tensor(f32(1, 6, 2, 8))
    port_fp.fused_dot_product_attention(small, small, small, causal=True)
    assert fa.RAW_ROUTES["native"] == before + 1


def _dropped_share(pkg, fn, x, y, **kw):
    out = npy(fn(pkg.to_tensor(x), pkg.to_tensor(y), **kw))
    return float(np.mean(out == y))


def test_fused_dropout_add_distribution():
    """Both packages drop a p share of x and scale the rest by 1/(1-p)
    (5 sigma at n 65536); the port's mask is its generator's draw."""
    x = f32(256, 256, lo=1.0, hi=2.0)
    y = f32(256, 256, seed=1)
    p = 0.3
    sigma = np.sqrt(p * (1 - p) / x.size)
    for pkg, fn in ((ref, ref_fp.fused_dropout_add),
                    (port, port_fp.fused_dropout_add)):
        pkg.seed(7)
        share = _dropped_share(pkg, fn, x, y, p=p)
        assert abs(share - p) < 5 * sigma, (pkg.__name__, share)
    port.seed(7)
    out = npy(port_fp.fused_dropout_add(port.to_tensor(x), port.to_tensor(y),
                                        p=p))
    port.seed(7)
    from paddle_tpu_torch.core import random as prandom

    gen = prandom.default_generator().torch_generator("cpu")
    keep = (torch.rand(x.shape, generator=gen) < 1 - p).numpy()
    want = np.where(keep, (torch.from_numpy(x) / (1 - p)).numpy(), 0) + y
    np.testing.assert_array_equal(out, want.astype(np.float32))
    down = npy(port_fp.fused_dropout_add(port.to_tensor(x), port.to_tensor(y),
                                         p=p, mode="downscale_in_infer"))
    kept = down != y
    np.testing.assert_allclose(down[kept], (x + y)[kept], rtol=1e-6)


def test_fused_bias_dropout_residual_layer_norm_draws():
    """With a rate, the port's output is LN(residual + mask(x + bias) /
    (1 - rate)) for its generator's mask; the reference keeps the same
    share of entries (its LN input is checked through the residual: a
    dropped entry contributes residual alone)."""
    x, res = f32(64, 128), f32(64, 128, seed=1)
    b = f32(128, seed=2)
    rate = 0.25
    port.seed(11)
    out = npy(port_fp.fused_bias_dropout_residual_layer_norm(
        port.to_tensor(x), port.to_tensor(res), bias=port.to_tensor(b),
        dropout_rate=rate))
    port.seed(11)
    from paddle_tpu_torch.core import random as prandom

    gen = prandom.default_generator().torch_generator("cpu")
    keep = torch.rand(x.shape, generator=gen) < 1 - rate
    h = torch.from_numpy(x) + torch.from_numpy(b)
    h = torch.where(keep, h / (1 - rate), 0.0) + torch.from_numpy(res)
    mu = h.mean(-1, keepdim=True)
    want = (h - mu) * torch.rsqrt(torch.square(h - mu).mean(-1, keepdim=True)
                                  + 1e-5)
    np.testing.assert_allclose(out, want.numpy(), rtol=1e-6, atol=1e-6)
    share = 1 - keep.float().mean().item()
    assert abs(share - rate) < 5 * np.sqrt(rate * (1 - rate) / x.size)


def test_fused_token_prune_keeps_first_and_order():
    """The first token survives by +inf; kept indices ascend with
    keep_order; ties keep the earlier position (a stable sort)."""
    attn = np.zeros((1, 6, 6), np.float32)
    attn[0, :, 3] = 1.0
    attn[0, :, 5] = 1.0
    x = f32(1, 6, 4)
    new_mask = np.zeros((1, 1, 3, 3), np.float32)
    for pkg, fn in ((ref, ref_fp.fused_token_prune),
                    (port, port_fp.fused_token_prune)):
        kept, idx = fn(pkg.to_tensor(attn), pkg.to_tensor(x),
                       new_mask=pkg.to_tensor(new_mask))
        np.testing.assert_array_equal(npy(idx), [[0, 3, 5]])
        np.testing.assert_array_equal(npy(kept), x[:, [0, 3, 5]])
