"""The op library's long tail, part one: special math, FFT, linalg
extras, indexing, distances, nucleus sampling and the beam backtrace
(port of paddle_tpu/ops/extra.py).

Each op is a torch impl through the funnel with the reference's name,
``differentiable`` flag and AMP policy. ``masked_select``, ``unique``,
``unique_consecutive``, ``nonzero`` and ``broadcast_tensors`` are the
functions of ``ops/manipulation.py``, which the package exports under
those names in both packages. ``top_p_sampling`` with a seed draws
JAX's ``PRNGKey(seed)``, split per row, uniform bits
(``core/jax_random.py``); its sums run in float64, so the card and the
CPU pick the same ids.
"""

from __future__ import annotations

import torch

from ..core import jax_random
from ..core import random as prandom
from ..core.dispatch import op
from ..core.tensor import Tensor, as_torch
from .linalg import _vector_norm
from .manipulation import (broadcast_tensors, masked_select,  # noqa: F401
                           nonzero, unique, unique_consecutive)

__all__ = [
    "polygamma", "nanmedian", "trapezoid", "cumulative_trapezoid",
    "fmod", "fix", "renorm", "logdet", "vdot", "diagonal",
    "index_fill", "masked_scatter", "masked_select", "unique",
    "unique_consecutive", "nonzero", "isreal", "iscomplex", "signbit",
    "fliplr", "flipud", "take", "unflatten", "ravel", "block_diag",
    "broadcast_tensors", "atleast_1d", "atleast_2d", "atleast_3d",
    "poisson_nll_loss", "pdist", "cdist", "fft",
    "top_p_sampling", "gather_tree",
]


def _data(t):
    return t._data if isinstance(t, Tensor) else as_torch(t)


# -- special math -----------------------------------------------------------

@op("polygamma")
def polygamma(x, n: int = 1):
    return torch.special.polygamma(n, x)


def _nanquantile(x, q, axis, keepdim, method):
    """JAX's nanquantile over ``axis`` (None, an int or a tuple): the
    reduced axes moved last and flattened, q's dimensions leading."""
    nd = x.ndim
    axes = tuple(range(nd)) if axis is None else (
        tuple(a % nd for a in axis) if isinstance(axis, (list, tuple))
        else (axis % nd,))
    keep = [d for d in range(nd) if d not in axes]
    flat = x.permute(keep + list(axes)).reshape(
        [x.shape[d] for d in keep] + [-1])
    if not isinstance(q, torch.Tensor):
        q = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    out = torch.nanquantile(flat, q.to(x.dtype), dim=-1,
                            interpolation=method)
    if keepdim:
        shape = [1 if d in axes else x.shape[d] for d in range(nd)]
        out = out.reshape(tuple(q.shape) + tuple(shape))
    return out


@op("nanmedian")
def nanmedian(x, axis=None, keepdim: bool = False):
    return _nanquantile(x, 0.5, axis, keepdim, "midpoint")


@op("trapezoid")
def trapezoid(y, x=None, dx=None, axis: int = -1):
    if x is None:
        d = torch.as_tensor(dx if dx is not None else 1.0, dtype=y.dtype,
                            device=y.device)
    elif x.ndim == 1:
        d = torch.diff(x)
    else:
        d = torch.diff(x, dim=axis).movedim(axis, -1)
    y = y.movedim(axis, -1)
    return 0.5 * (d * (y[..., 1:] + y[..., :-1])).sum(-1)


@op("cumulative_trapezoid")
def cumulative_trapezoid(y, x=None, dx=None, axis: int = -1):
    d = dx if dx is not None else 1.0
    y0 = y.movedim(axis, -1)
    if x is not None:
        xs = x.expand(y0.shape) if x.ndim == 1 else x.movedim(axis, -1)
        widths = xs[..., 1:] - xs[..., :-1]
    else:
        widths = d
    avg = (y0[..., 1:] + y0[..., :-1]) / 2.0
    return torch.cumsum(avg * widths, dim=-1).movedim(-1, axis)


@op("fmod")
def fmod(x, y):
    return torch.fmod(x, y)


@op("fix")
def fix(x):
    return torch.trunc(x)


@op("signbit")
def signbit(x):
    return torch.signbit(x)


# -- norms / linalg ---------------------------------------------------------

@op("renorm")
def renorm(x, p: float, axis: int, max_norm: float):
    moved = x.movedim(axis, 0)
    flat = moved.reshape(moved.shape[0], -1)
    norms = _vector_norm(flat, p, 1, False)
    factor = torch.where(norms > max_norm,
                         max_norm / torch.clamp_min(norms, 1e-12),
                         torch.ones_like(norms))
    return (flat * factor[:, None]).reshape(moved.shape).movedim(0, axis)


@op("logdet")
def logdet(x):
    return torch.linalg.slogdet(x)[1]


@op("vdot")
def vdot(x, y):
    return torch.vdot(x.reshape(-1), y.reshape(-1))


@op("diagonal")
def diagonal(x, offset: int = 0, axis1: int = 0, axis2: int = 1):
    return torch.diagonal(x, offset=offset, dim1=axis1, dim2=axis2).clone()


@op("block_diag")
def block_diag(*inputs):
    return torch.block_diag(*inputs)


# -- indexing / masking -----------------------------------------------------

@op("index_fill")
def index_fill(x, index, axis: int, value: float):
    return x.index_fill(axis, index.reshape(-1).long(), value)


@op("masked_scatter")
def masked_scatter(x, mask, value):
    """True positions of ``mask`` take ``value``'s elements in row-major
    order (the reference's static-shape version)."""
    flat_m = mask.reshape(-1).bool()
    vals = value.reshape(-1)
    take_idx = torch.cumsum(flat_m.long(), 0) - 1
    gathered = vals[take_idx.clamp(0, vals.shape[0] - 1)]
    return torch.where(flat_m, gathered, x.reshape(-1)).reshape(x.shape)


@op("take")
def take(x, index, mode: str = "raise"):
    idx = index.reshape(-1).long()
    n = x.numel()
    if mode == "wrap":
        idx = idx % n
    elif mode == "clip":
        idx = idx.clamp(0, n - 1)
    return x.reshape(-1)[idx].reshape(index.shape)


@op("isreal")
def isreal(x):
    if x.is_complex():
        return x.imag == 0
    return torch.ones(x.shape, dtype=torch.bool, device=x.device)


@op("iscomplex")
def iscomplex(x):
    return torch.full(x.shape, x.is_complex(), dtype=torch.bool,
                      device=x.device)


# -- shape utilities --------------------------------------------------------

@op("fliplr")
def fliplr(x):
    return torch.fliplr(x)


@op("flipud")
def flipud(x):
    return torch.flipud(x)


@op("unflatten")
def unflatten(x, axis: int, shape):
    axis = axis % x.ndim
    return x.reshape(x.shape[:axis] + tuple(shape) + x.shape[axis + 1:])


@op("ravel")
def ravel(x):
    return x.reshape(-1)


def _atleast(n):
    def fn(*inputs):
        outs = []
        for t in inputs:
            a = _data(t)
            while a.ndim < n:
                a = a[None]
            outs.append(Tensor(a))
        return outs[0] if len(outs) == 1 else outs

    return fn


atleast_1d = _atleast(1)
atleast_2d = _atleast(2)
atleast_3d = _atleast(3)


# -- distances / losses -----------------------------------------------------

def poisson_nll_loss(input, label, log_input: bool = True,  # noqa: A002
                     full: bool = False, epsilon: float = 1e-8,
                     reduction: str = "mean"):
    # the one registration is nn/functional/loss.py's, as in the reference
    from ..nn.functional.loss import poisson_nll_loss as _impl

    return _impl(input, label, log_input=log_input, full=full,
                 epsilon=epsilon, reduction=reduction)


@op("pdist")
def pdist(x, p: float = 2.0):
    # the upper-triangle pairs first: the zero diagonal of the full
    # pairwise matrix would make the norm's gradient NaN there
    iu = torch.triu_indices(x.shape[0], x.shape[0], 1, device=x.device)
    return _vector_norm(x[iu[0]] - x[iu[1]] + 1e-30, p, -1, False)


@op("cdist")
def cdist(x, y, p: float = 2.0,
          compute_mode: str = "use_mm_for_euclid_dist_if_necessary"):
    return _vector_norm(x[..., :, None, :] - y[..., None, :, :] + 1e-30, p,
                        -1, False)


# -- fft namespace ----------------------------------------------------------

def _fft_run(name, x, **kw):
    """torch.fft on the tensor's device; no gradient, as in the
    reference, whose FFTs wrap their results outside the funnel."""
    with torch.no_grad():
        return Tensor(getattr(torch.fft, name)(_data(x), **kw)
                      .resolve_conj())


class fft:
    """paddle.fft namespace (reference python/paddle/fft.py), on
    ``torch.fft``."""

    @staticmethod
    def fft(x, n=None, axis=-1, norm="backward", name=None):
        return _fft_run("fft", x, n=n, dim=axis, norm=norm)

    @staticmethod
    def ifft(x, n=None, axis=-1, norm="backward", name=None):
        return _fft_run("ifft", x, n=n, dim=axis, norm=norm)

    @staticmethod
    def rfft(x, n=None, axis=-1, norm="backward", name=None):
        return _fft_run("rfft", x, n=n, dim=axis, norm=norm)

    @staticmethod
    def irfft(x, n=None, axis=-1, norm="backward", name=None):
        return _fft_run("irfft", x, n=n, dim=axis, norm=norm)

    @staticmethod
    def fft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
        return _fft_run("fft2", x, s=s, dim=axes, norm=norm)

    @staticmethod
    def ifft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
        return _fft_run("ifft2", x, s=s, dim=axes, norm=norm)

    @staticmethod
    def fftn(x, s=None, axes=None, norm="backward", name=None):
        return _fft_run("fftn", x, s=s, dim=axes, norm=norm)

    @staticmethod
    def ifftn(x, s=None, axes=None, norm="backward", name=None):
        return _fft_run("ifftn", x, s=s, dim=axes, norm=norm)

    @staticmethod
    def rfft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
        return _fft_run("rfft2", x, s=s, dim=axes, norm=norm)

    @staticmethod
    def irfft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
        return _fft_run("irfft2", x, s=s, dim=axes, norm=norm)

    @staticmethod
    def rfftn(x, s=None, axes=None, norm="backward", name=None):
        return _fft_run("rfftn", x, s=s, dim=axes, norm=norm)

    @staticmethod
    def irfftn(x, s=None, axes=None, norm="backward", name=None):
        return _fft_run("irfftn", x, s=s, dim=axes, norm=norm)

    @staticmethod
    def hfft(x, n=None, axis=-1, norm="backward", name=None):
        return _fft_run("hfft", x, n=n, dim=axis, norm=norm)

    @staticmethod
    def ihfft(x, n=None, axis=-1, norm="backward", name=None):
        return _fft_run("ihfft", x, n=n, dim=axis, norm=norm)

    @staticmethod
    def hfft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
        return fft.hfftn(x, s=s, axes=axes, norm=norm)

    @staticmethod
    def ihfft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
        return fft.ihfftn(x, s=s, axes=axes, norm=norm)

    @staticmethod
    def _axes(x, s, axes):
        if axes is None:
            nd = len(s) if s is not None else _data(x).ndim
            return tuple(range(-nd, 0))
        return tuple(axes)

    @staticmethod
    def hfftn(x, s=None, axes=None, norm="backward", name=None):
        # the reference's composition: complex fft over the leading axes,
        # hfft (complex -> real) over the last
        axes = fft._axes(x, s, axes)
        y = x
        for i, ax in enumerate(axes[:-1]):
            y = fft.fft(y, n=None if s is None else s[i], axis=ax,
                        norm=norm)
        return fft.hfft(y, n=None if s is None else s[-1], axis=axes[-1],
                        norm=norm)

    @staticmethod
    def ihfftn(x, s=None, axes=None, norm="backward", name=None):
        # ihfft of the real input first, then complex ifft
        axes = fft._axes(x, s, axes)
        y = fft.ihfft(x, n=None if s is None else s[-1], axis=axes[-1],
                      norm=norm)
        for i, ax in enumerate(axes[:-1]):
            y = fft.ifft(y, n=None if s is None else s[i], axis=ax,
                         norm=norm)
        return y

    @staticmethod
    def fftfreq(n, d=1.0, dtype=None, name=None):
        from ..core.device import current_device

        return Tensor(torch.fft.fftfreq(n, d=d, device=current_device()))

    @staticmethod
    def rfftfreq(n, d=1.0, dtype=None, name=None):
        from ..core.device import current_device

        return Tensor(torch.fft.rfftfreq(n, d=d, device=current_device()))

    @staticmethod
    def fftshift(x, axes=None, name=None):
        return _fft_run("fftshift", x, dim=axes)

    @staticmethod
    def ifftshift(x, axes=None, name=None):
        return _fft_run("ifftshift", x, dim=axes)


# ---------------------------------------------------------------------------
# generation utilities (reference: top_p_sampling, gather_tree ops)
# ---------------------------------------------------------------------------

@op("top_p_sampling")
def _top_p_sampling(x, ps, u, threshold):
    from .nucleus import nucleus_keep

    sorted_p, sorted_i = torch.sort(x, dim=-1, descending=True, stable=True)
    # the minimal prefix reaching the cumulative threshold, at least one
    # token (ops/nucleus.py)
    keep = nucleus_keep(sorted_p, ps)
    if threshold is not None:
        keep = keep & (sorted_p >= threshold)
        keep[:, 0] = True
    probs = torch.where(keep, sorted_p, torch.zeros_like(sorted_p)).double()
    # jax.random.choice: r = total (1 - u), the first index whose
    # cumulative mass reaches r
    cum = torch.cumsum(probs, dim=-1)
    r = cum[:, -1:] * (1.0 - u.double()[:, None])
    choice = torch.searchsorted(cum, r).clamp_max(x.shape[-1] - 1)
    ids = sorted_i.gather(-1, choice)
    return x.gather(-1, ids), ids.to(torch.int32)


def top_p_sampling(x, ps, threshold=None, seed=None, name=None):
    """Nucleus sampling (the reference's top_p_sampling): one id a row
    of the probabilities ``x`` [B, V], drawn from the smallest prefix of
    the sorted row whose mass reaches ``ps``. With ``seed`` >= 0 the row
    draws are JAX's (``PRNGKey(seed)`` split per row, one uniform each);
    otherwise from the package's generator. Returns (values, ids)."""
    xd = _data(x)
    B = xd.shape[0]
    if seed is not None and seed >= 0:
        keys = jax_random.split(jax_random.prng_key(seed).to(xd.device), B)
        bits = jax_random.random_bits32(keys, 1)[:, 0]
        u = jax_random.uniform_from_bits(bits)
    else:
        gen = prandom.default_generator().torch_generator(xd.device)
        u = torch.rand(B, device=xd.device, generator=gen)
    return _top_p_sampling(x, ps, u, threshold)


@op("gather_tree", differentiable=False)
def gather_tree(ids, parents):
    """Beam-search backtrace (the reference's gather_tree): parent
    pointers walked from the last step. ids / parents: [T, batch, beam]."""
    T = ids.shape[0]
    beams = torch.arange(ids.shape[2], device=ids.device) \
        .expand(ids.shape[1:]).to(ids.dtype)
    outs = []
    for t in range(T - 1, -1, -1):
        b = beams.long()
        outs.append(ids[t].gather(-1, b))
        beams = parents[t].gather(-1, b)
    return torch.stack(outs[::-1])
