"""Shared by the Layer parity tests (tests/test_torch_nn_layers.py,
test_torch_nn_norm.py, test_torch_nn_transformer.py, test_torch_nn_conv.py,
test_torch_nn_pooling.py, test_torch_nn_rnn.py, test_torch_nn_extra.py):
build a layer in both packages with the reference's state carried across, and hold the
port's forward and gradients to the reference's at fp32 rtol 1e-5 (and
1e-5 of the tensor's largest magnitude).

Attention's key-projection bias has a gradient of 0 in exact arithmetic
(the softmax over keys ignores a shift common to every key, and q . b
is one), so both packages return rounding noise there: those gradients
are held to within 1e-5 of the largest gradient of the layer on both
sides, not to each other. ``hold_fn`` holds a functional the same way.
"""

import numpy as np

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu_torch.utils.convert import layer_state_from_jax

port.set_device("cpu")
RTOL = 1e-5


def _f(*shape, seed=0, lo=None, hi=None):
    rng = np.random.default_rng(seed)
    if lo is not None:
        return rng.uniform(lo, hi, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _i(*vals, shape=None):
    a = np.asarray(vals, np.int64)
    return a if shape is None else a.reshape(shape)


def close(a, b, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    atol = RTOL * float(np.max(np.abs(b))) if b.size else 0.0
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=atol, err_msg=what)


def pair(name, *args, **kwargs):
    """The reference's and the port's ``nn.<name>(*args, **kwargs)``;
    an argument that is a function of the package is called with it.
    The port's takes the reference's state."""
    def build(pkg):
        a = [x(pkg) if callable(x) else x for x in args]
        k = {n: (v(pkg) if callable(v) else v) for n, v in kwargs.items()}
        return getattr(pkg.nn, name)(*a, **k)

    rl, pl = build(ref), build(port)
    rsd = rl.state_dict()
    assert list(pl.state_dict()) == list(rsd), name
    pl.set_state_dict(layer_state_from_jax(rsd, "cpu"))
    return rl, pl


def run(pkg, layer, inputs):
    """(outputs, the float inputs and trainable parameters, their
    names)."""
    leaves, names, ts = [], [], []
    for i, x in enumerate(inputs):
        floating = isinstance(x, np.ndarray) and x.dtype.kind == "f"
        t = pkg.to_tensor(x, stop_gradient=not floating) \
            if isinstance(x, np.ndarray) else x
        if floating:
            leaves.append(t)
            names.append(f"input {i}")
        ts.append(t)
    out = layer(*ts)
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    for n, p in layer.named_parameters():
        if not p.stop_gradient:
            leaves.append(p)
            names.append(n)
    return outs, leaves, names


def hold(rl, pl, inputs, train=False, what=""):
    """Outputs and the gradients of a seeded cotangent, port against
    reference."""
    for layer in (rl, pl):
        layer.train() if train else layer.eval()
    r_outs, r_in, _ = run(ref, rl, inputs)
    p_outs, p_in, names = run(port, pl, inputs)
    assert len(p_outs) == len(r_outs)
    for j, (po, ro) in enumerate(zip(p_outs, r_outs)):
        close(po.numpy(), ro.numpy(), f"{what} output {j}")
    pairs = [(po, ro) for po, ro in zip(p_outs, r_outs)
             if not ro.stop_gradient]
    if not pairs or not r_in:
        return
    rng = np.random.default_rng(1)
    cots = [rng.standard_normal(tuple(ro.shape)).astype(np.float32)
            for _, ro in pairs]
    r_g = ref.grad([ro for _, ro in pairs], r_in,
                   [ref.to_tensor(c) for c in cots], allow_unused=True)
    p_g = port.grad([po for po, _ in pairs], p_in,
                    [port.to_tensor(c) for c in cots], allow_unused=True)
    assert len(p_g) == len(r_g)
    # an input the output does not depend on: None or zeros
    p_g = [np.zeros(tuple(x.shape), np.float32) if g is None else g.numpy()
           for g, x in zip(p_g, p_in)]
    r_g = [np.zeros(tuple(x.shape), np.float32) if g is None else g.numpy()
           for g, x in zip(r_g, p_in)]
    top = max(float(np.max(np.abs(g))) for g in r_g if g.size)
    for pg, rg, name in zip(p_g, r_g, names):
        if name.endswith("k_proj.bias"):
            for side, g in (("port", pg), ("reference", rg)):
                assert float(np.max(np.abs(g))) <= RTOL * top, (
                    what, name, side)
        else:
            close(pg, rg, f"{what} grad of {name}")


def hold_fn(fn_name, arrays, kwargs=None, what=""):
    """``nn.functional.<fn_name>(*arrays, **kwargs)`` in both packages:
    numpy arrays become tensors (float ones requiring grad), other
    arguments pass as they are. Float outputs are held by ``close``,
    others exactly (as int64); then the gradients of a seeded cotangent with
    respect to every float input. Returns the port's outputs."""
    kwargs = kwargs or {}
    what = what or fn_name

    def call(pkg):
        ins, ts = [], []
        for a in arrays:
            if isinstance(a, np.ndarray):
                t = pkg.to_tensor(a, stop_gradient=a.dtype.kind != "f")
                if a.dtype.kind == "f":
                    ins.append(t)
                ts.append(t)
            else:
                ts.append(a)
        out = getattr(pkg.nn.functional, fn_name)(*ts, **kwargs)
        return (list(out) if isinstance(out, (tuple, list)) else [out]), ins

    r_outs, r_in = call(ref)
    p_outs, p_in = call(port)
    assert len(p_outs) == len(r_outs), what
    for j, (po, ro) in enumerate(zip(p_outs, r_outs)):
        a, b = po.numpy(), ro.numpy()
        if b.dtype.kind == "f":
            close(a, b, f"{what} output {j}")
        else:
            # the reference's integers are 32-bit (jax without x64)
            assert a.shape == b.shape and a.dtype.kind == b.dtype.kind, (
                what, j, a.shape, b.shape, a.dtype, b.dtype)
            np.testing.assert_array_equal(a.astype(np.int64),
                                          b.astype(np.int64), err_msg=what)
    pairs = [(po, ro) for po, ro in zip(p_outs, r_outs)
             if not ro.stop_gradient]
    if not pairs or not r_in:
        return p_outs
    rng = np.random.default_rng(1)
    cots = [rng.standard_normal(tuple(ro.shape)).astype(np.float32)
            for _, ro in pairs]
    r_g = ref.grad([ro for _, ro in pairs], r_in,
                   [ref.to_tensor(c) for c in cots], allow_unused=True)
    p_g = port.grad([po for po, _ in pairs], p_in,
                    [port.to_tensor(c) for c in cots], allow_unused=True)
    for j, (pg, rg, x) in enumerate(zip(p_g, r_g, p_in)):
        zero = np.zeros(tuple(x.shape), np.float32)
        close(zero if pg is None else pg.numpy(),
              zero if rg is None else rg.numpy(), f"{what} grad {j}")
    return p_outs
