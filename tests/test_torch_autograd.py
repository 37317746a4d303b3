"""``paddle_tpu_torch.autograd`` against ``paddle_tpu.autograd`` on the CPU.

PyLayer: every PyLayer and saved-tensor-hook case of
tests/test_autograd.py and tests/test_autograd_regressions.py, the
reference docstring's ``Tanh``, tensors by keyword, the
``materialize_grads`` rule, padded missing gradients, no double
gradient through a PyLayer (create_graph raises), and a second backward
through a released graph. The hooks pack only what ``save_for_backward`` saves: the tape's
own residuals are not packed (the pack count is held in both packages).
jacobian / hessian / vjp / jvp: the structure (Tensor, tuple, nesting)
and values of the reference's for one and for several ``xs`` and for
one and several outputs, at fp32 rtol 1e-6 (1e-6 of the largest
magnitude)."""

import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as port

from torch_eager_common import (freeze_after_case, frozen_heap,  # noqa: F401
                                reference_ops_restored)

port.set_device("cpu")
RTOL = 1e-6
PKGS = [pytest.param(ref, id="ref"), pytest.param(port, id="port")]


def _close(a, b, what=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    atol = RTOL * float(np.max(np.abs(b))) if b.size else 0.0
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=atol, err_msg=what)


def _layers(pkg):
    """The PyLayers of the reference's tests, written once for either
    package."""
    PyLayer = pkg.autograd.PyLayer

    class Cube(PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * x * x

        @staticmethod
        def backward(ctx, dy):
            (x,) = ctx.saved_tensor
            return dy * 3 * x * x

    class Sq(PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * x

        @staticmethod
        def backward(ctx, dy):
            (x,) = ctx.saved_tensor
            return dy * 2 * x

    class Tanh(PyLayer):
        @staticmethod
        def forward(ctx, x):
            y = pkg.tanh(x)
            ctx.save_for_backward(y)
            return y

        @staticmethod
        def backward(ctx, dy):
            (y,) = ctx.saved_tensor
            return dy * (1 - y * y)

    class ScaleKw(PyLayer):
        """x * w + b, w and b by keyword; no gradient for b (padded)."""

        @staticmethod
        def forward(ctx, x, w=None, b=None):
            ctx.save_for_backward(x, w)
            return x * w + b

        @staticmethod
        def backward(ctx, dy):
            x, w = ctx.saved_tensor
            return dy * w, dy * x

    class Split2(PyLayer):
        """(2x, 3x); with ``materialize`` False an unused output's
        gradient reaches backward as None."""
        seen: list = []

        @staticmethod
        def forward(ctx, x, materialize=True):
            ctx.materialize_grads = materialize
            return x * 2, x * 3

        @staticmethod
        def backward(ctx, da, db):
            Split2.seen.append((da is None, db is None))
            g = da * 2 if da is not None else None
            if db is not None:
                g = db * 3 if g is None else g + db * 3
            return g

    return dict(Cube=Cube, Sq=Sq, Tanh=Tanh, ScaleKw=ScaleKw, Split2=Split2)


@pytest.mark.parametrize("pkg", PKGS)
def test_pylayer_cube(pkg):
    x = pkg.to_tensor([2.0], stop_gradient=False)
    y = _layers(pkg)["Cube"].apply(x)
    y.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [12.0])


def test_pylayer_tanh_matches_autograd_and_reference():
    xs = np.random.default_rng(0).standard_normal((3, 4)).astype(np.float32)
    got = {}
    for pkg in (ref, port):
        x = pkg.to_tensor(xs, stop_gradient=False)
        y = _layers(pkg)["Tanh"].apply(x)
        (y * y).sum().backward()
        got[pkg.__name__] = (y.numpy(), x.grad.numpy())
        x2 = pkg.to_tensor(xs, stop_gradient=False)
        (pkg.tanh(x2) ** 2).sum().backward()
        _close(x.grad.numpy(), x2.grad.numpy(), f"{pkg.__name__} autograd")
    for a, b in zip(got["paddle_tpu_torch"], got["paddle_tpu"]):
        _close(a, b, "tanh port vs reference")


@pytest.mark.parametrize("pkg", PKGS)
def test_saved_tensors_hooks_pack_unpack(pkg):
    """tests/test_autograd_regressions.py's case, and the tape's own
    residuals (the multiply after the PyLayer saves its inputs) are not
    packed."""
    packed, unpacked = [], []

    def pack(t):
        packed.append(t)
        return t.numpy()

    def unpack(a):
        unpacked.append(a)
        return pkg.to_tensor(a)

    x = pkg.to_tensor([3.0], stop_gradient=False)
    with pkg.autograd.saved_tensors_hooks(pack, unpack):
        y = _layers(pkg)["Sq"].apply(x)
        z = y * x
    z.sum().backward()
    assert len(packed) == 1 and len(unpacked) == 1
    np.testing.assert_allclose(x.grad.numpy(), [27.0])


@pytest.mark.parametrize("pkg", PKGS)
def test_pylayer_kwargs_and_padding(pkg):
    x = pkg.to_tensor([2.0, 3.0], stop_gradient=False)
    w = pkg.to_tensor([4.0, 5.0], stop_gradient=False)
    b = pkg.to_tensor([1.0, 1.0], stop_gradient=False)
    y = _layers(pkg)["ScaleKw"].apply(x, w=w, b=b)
    np.testing.assert_allclose(y.numpy(), [9.0, 16.0])
    y.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [4.0, 5.0])
    np.testing.assert_allclose(w.grad.numpy(), [2.0, 3.0])
    assert b.grad is None


@pytest.mark.parametrize("materialize", [True, False])
@pytest.mark.parametrize("pkg", PKGS)
def test_pylayer_materialize_grads(pkg, materialize):
    split2 = _layers(pkg)["Split2"]
    split2.seen.clear()
    x = pkg.to_tensor([1.0, 2.0], stop_gradient=False)
    a, _ = split2.apply(x, materialize=materialize)
    a.sum().backward()
    assert split2.seen == [(False, not materialize)]
    np.testing.assert_allclose(x.grad.numpy(), [2.0, 2.0])


@pytest.mark.parametrize("pkg", PKGS)
def test_pylayer_no_grad_inputs_and_outputs(pkg):
    """No input requires grad, or grad mode is off: the outputs are off
    the tape."""
    cube = _layers(pkg)["Cube"]
    y = cube.apply(pkg.to_tensor([2.0]))
    assert y.stop_gradient
    x = pkg.to_tensor([2.0], stop_gradient=False)
    with pkg.no_grad():
        y = cube.apply(x)
    assert y.stop_gradient
    np.testing.assert_allclose(y.numpy(), [8.0])


@pytest.mark.parametrize("pkg", PKGS)
def test_pylayer_second_backward_raises(pkg):
    x = pkg.to_tensor([2.0], stop_gradient=False)
    y = _layers(pkg)["Cube"].apply(x)
    y.sum().backward(retain_graph=True)
    y.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [24.0])
    with pytest.raises(RuntimeError):
        y.sum().backward()


@pytest.mark.parametrize("pkg", PKGS)
def test_pylayer_gives_no_double_gradient(pkg):
    """The node stores no primal: create_graph through it raises."""
    x = pkg.to_tensor([2.0], stop_gradient=False)
    y = _layers(pkg)["Cube"].apply(x)
    with pytest.raises(NotImplementedError, match="create_graph"):
        pkg.grad(y.sum(), [x], create_graph=True)


# -- jacobian / hessian / vjp / jvp ----------------------------------------

_RNG = np.random.default_rng(3)
X1 = _RNG.standard_normal((3,)).astype(np.float32)
X2 = _RNG.standard_normal((2, 3)).astype(np.float32)
V1 = _RNG.standard_normal((3,)).astype(np.float32)
V2 = _RNG.standard_normal((2, 3)).astype(np.float32)


def _f_one(pkg):
    return lambda x: pkg.tanh(x) * x


def _f_one_two_out(pkg):
    return lambda x: (x * x, pkg.sin(x).sum())


def _f_two(pkg):
    return lambda x, y: pkg.matmul(y, x) + pkg.exp(x).sum()


def _f_two_two_out(pkg):
    return lambda x, y: (pkg.matmul(y, x * x), (y * y).sum() + x[0])


def _f_scalar_two(pkg):
    return lambda x, y: (pkg.matmul(y, x * x) * pkg.sin(y).sum(1)).sum()


def _f_scalar_one(pkg):
    return lambda x: (pkg.exp(x) * x * x).sum()


def _same(got, want, what):
    """The same nesting of tuples and the same values."""
    if isinstance(want, (tuple, list)):
        assert isinstance(got, type(want)), (what, type(got), type(want))
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{what}[{i}]")
        return
    assert isinstance(got, port.Tensor), (what, type(got))
    assert got.stop_gradient, what
    _close(got.numpy(), want.numpy(), what)


def _xs(pkg, which):
    if which == "one":
        return pkg.to_tensor(X1)
    return [pkg.to_tensor(X1), pkg.to_tensor(X2)]


CASES = [("one", _f_one), ("one", _f_one_two_out), ("two", _f_two),
         ("two", _f_two_two_out)]


@pytest.mark.parametrize("which,fn", CASES,
                         ids=[f.__name__ for _, f in CASES])
def test_jacobian(which, fn):
    want = ref.autograd.jacobian(fn(ref), _xs(ref, which))
    got = port.autograd.jacobian(fn(port), _xs(port, which))
    _same(got, want, "jacobian")


@pytest.mark.parametrize("which,fn", [("one", _f_scalar_one),
                                      ("two", _f_scalar_two)],
                         ids=["one", "two"])
def test_hessian(which, fn):
    want = ref.autograd.hessian(fn(ref), _xs(ref, which))
    got = port.autograd.hessian(fn(port), _xs(port, which))
    _same(got, want, "hessian")


def _v(pkg, which, fn, for_outputs):
    """None (ones), or a seeded v over the outputs (vjp) or the inputs
    (jvp)."""
    if for_outputs:
        outs = fn(ref)(*([ref.to_tensor(X1)] if which == "one" else
                         [ref.to_tensor(X1), ref.to_tensor(X2)]))
        outs = outs if isinstance(outs, tuple) else (outs,)
        rng = np.random.default_rng(5)
        vs = [pkg.to_tensor(rng.standard_normal(tuple(o.shape)).astype(
            np.float32)) for o in outs]
        return vs[0] if len(vs) == 1 else vs
    if which == "one":
        return pkg.to_tensor(V1)
    return [pkg.to_tensor(V1), pkg.to_tensor(V2)]


@pytest.mark.parametrize("seeded", [False, True], ids=["ones", "v"])
@pytest.mark.parametrize("which,fn", CASES,
                         ids=[f.__name__ for _, f in CASES])
def test_vjp(which, fn, seeded):
    args = lambda pkg: (fn(pkg), _xs(pkg, which),  # noqa: E731
                        _v(pkg, which, fn, True) if seeded else None)
    want = ref.autograd.vjp(*args(ref))
    got = port.autograd.vjp(*args(port))
    _same(got, want, "vjp")


@pytest.mark.parametrize("seeded", [False, True], ids=["ones", "v"])
@pytest.mark.parametrize("which,fn", CASES,
                         ids=[f.__name__ for _, f in CASES])
def test_jvp(which, fn, seeded):
    args = lambda pkg: (fn(pkg), _xs(pkg, which),  # noqa: E731
                        _v(pkg, which, fn, False) if seeded else None)
    want = ref.autograd.jvp(*args(ref))
    got = port.autograd.jvp(*args(port))
    _same(got, want, "jvp")


def test_reexports():
    for name in ("backward", "grad", "no_grad", "enable_grad",
                 "is_grad_enabled"):
        assert getattr(port.autograd, name) is getattr(port, name)
    assert set(ref.autograd.__all__) == set(port.autograd.__all__)
