"""Linear algebra (port of paddle_tpu/ops/linalg.py).

The decompositions, solves and products are torch's (``torch.linalg``:
LAPACK on the CPU, cuSOLVER / cuBLAS on the card), registered through
the funnel with the reference's names, ``differentiable`` flags and AMP
policies. Where the reference's function is not the library's, the
reference's expression is written out: ``cholesky`` and ``eigh``
symmetrize their input (``symmetrize_input=True``), ``lstsq`` is JAX's
SVD solve, ``histogram`` JAX's edges and scatter, ``householder_product``,
``ormqr`` and ``lu_unpack`` the reference's own loops. ``eig`` and
``eigvals`` return real arrays when every eigenvalue is real, as the
reference's host LAPACK call does.
"""

from __future__ import annotations

import torch

from ..core import random as prandom
from ..core.dispatch import op
from ..core.dtype import convert_dtype
from ..core.tensor import Tensor, as_torch


def _dims(axis):
    if axis is None:
        return None
    return tuple(axis) if isinstance(axis, (list, tuple)) else (axis,)


def _reduce(fn, x, axis, keepdim):
    d = _dims(axis)
    if d is None:
        out = fn(x.reshape(-1), 0)
        return out.reshape((1,) * x.ndim) if keepdim else out
    return fn(x, d, keepdim)


def _sum(x, axis, keepdim):
    return _reduce(lambda t, d, k=False: t.sum(d, keepdim=k), x, axis,
                   keepdim)


def _amax(x, axis, keepdim):
    return _reduce(lambda t, d, k=False: t.amax(d, keepdim=k), x, axis,
                   keepdim)


def _amin(x, axis, keepdim):
    return _reduce(lambda t, d, k=False: t.amin(d, keepdim=k), x, axis,
                   keepdim)


def _sym(x):
    """The reference's ``symmetrize_input``: (x + xᴴ) / 2."""
    return (x + x.mH) / 2


@op("norm")
def norm(x, p=None, axis=None, keepdim=False):
    if p is None:
        p = "fro" if axis is None or isinstance(axis, (list, tuple)) else 2
    if p == "fro":
        return torch.sqrt(_sum(torch.square(torch.abs(x)), axis, keepdim))
    if p == float("inf"):
        return _amax(torch.abs(x), axis, keepdim)
    if p == float("-inf"):
        return _amin(torch.abs(x), axis, keepdim)
    if p == 0:
        return _sum((x != 0).to(x.dtype), axis, keepdim)
    return _sum(torch.abs(x) ** p, axis, keepdim) ** (1.0 / p)


@op("vector_norm")
def vector_norm(x, p=2.0, axis=None, keepdim=False):
    if axis is None:
        out = _vector_norm(x.reshape(-1), p, 0, False)
        return out.reshape((1,) * x.ndim) if keepdim else out
    return _vector_norm(x, p, axis, keepdim)


def _vector_norm(x, p, axis, keepdim):
    if p == 2:
        return torch.sqrt(_sum(torch.real(x * x.conj()), axis, keepdim))
    a = torch.abs(x)
    if p == float("inf"):
        return _amax(a, axis, keepdim)
    if p == float("-inf"):
        return _amin(a, axis, keepdim)
    if p == 0:
        return _sum((x != 0).to(a.dtype), axis, keepdim)
    if p == 1:
        return _sum(a, axis, keepdim)
    return _sum(a ** p, axis, keepdim) ** (1.0 / p)


@op("matrix_norm")
def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False):
    return torch.linalg.matrix_norm(x, ord=p, dim=(-2, -1), keepdim=keepdim)


@op("dist")
def dist(x, y, p=2):
    d = torch.abs(x - y)
    if p == 0:
        return torch.sum((d != 0).to(x.dtype))
    if p == float("inf"):
        return torch.max(d)
    if p == float("-inf"):
        return torch.min(d)
    return torch.sum(d ** p) ** (1.0 / p)


@op("cholesky")
def cholesky(x, upper=False):
    # NaN, not an error, where the matrix is not positive definite (the
    # reference's result); no host sync on the card
    l, info = torch.linalg.cholesky_ex(_sym(x))
    l = torch.where((info == 0)[..., None, None], l, float("nan"))
    return l.mT if upper else l


def _lower(y, upper):
    return (y.mT if upper else y).tril()


@op("cholesky_solve")
def cholesky_solve(x, y, upper=False):
    return torch.cholesky_solve(x, _lower(y, upper))


@op("qr")
def qr(x, mode="reduced"):
    q, r = torch.linalg.qr(x, mode=mode)
    # the reference tuples JAX's result, which for mode "r" is R alone
    return tuple(r.unbind(0)) if mode == "r" else (q, r)


@op("svd")
def svd(x, full_matrices=False):
    u, s, vh = torch.linalg.svd(x, full_matrices=full_matrices)
    return u, s, vh.mT.conj()


@op("svdvals")
def svdvals(x):
    return torch.linalg.svdvals(x)


def _real_if_real(*arrs):
    """The reference's host LAPACK call returns real arrays when every
    eigenvalue's imaginary part is 0 (numpy's rule)."""
    if bool((arrs[0].imag == 0).all()):
        return tuple(a.real.contiguous() for a in arrs)
    return arrs


@op("eig")
def eig(x):
    return _real_if_real(*torch.linalg.eig(x))


@op("eigh")
def eigh(x, UPLO="L"):
    return tuple(torch.linalg.eigh(_sym(x)))


@op("eigvals")
def eigvals(x):
    return _real_if_real(torch.linalg.eigvals(x))[0]


@op("eigvalsh")
def eigvalsh(x, UPLO="L"):
    return torch.linalg.eigvalsh(_sym(x))


@op("inverse")
def inverse(x):
    return torch.linalg.inv(x)


inv = inverse


@op("pinv")
def pinv(x, rcond=1e-15, hermitian=False):
    return torch.linalg.pinv(x, rtol=rcond, hermitian=hermitian)


@op("solve")
def solve(x, y):
    return torch.linalg.solve(x, y)


def _triangular(x, y, lower, trans, unit):
    a = x.tril() if lower else x.triu()
    if unit:
        eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
        a = a - torch.diag_embed(torch.diagonal(a, dim1=-2, dim2=-1)) + eye
    if trans:
        a, lower = a.mT, not lower
    vec = y.ndim == x.ndim - 1
    b = y.unsqueeze(-1) if vec else y
    out = torch.linalg.solve_triangular(a, b, upper=not lower)
    return out.squeeze(-1) if vec else out


@op("triangular_solve")
def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False):
    return _triangular(x, y, not upper, transpose, unitriangular)


@op("lstsq")
def lstsq(x, y, rcond=None):
    """JAX's SVD least squares: singular values under rcond · s₀ dropped,
    residuals always returned."""
    vec = y.ndim == 1
    b = y[:, None] if vec else y
    m, n = x.shape
    eps = torch.finfo(x.dtype).eps
    if rcond is None:
        rcond = eps * max(n, m)
    elif rcond < 0:
        rcond = eps
    u, s, vt = torch.linalg.svd(x, full_matrices=False)
    mask = (s > 0) & (s >= rcond * s[0])
    rank = mask.sum().to(torch.int32)
    safe = torch.where(mask, s, torch.ones_like(s))
    s_inv = torch.where(mask, 1 / safe, torch.zeros_like(s))[:, None]
    sol = vt.conj().mT @ (s_inv * (u.conj().mT @ b))
    resid = torch.linalg.vector_norm(b - x @ sol, dim=0) ** 2
    return (sol.reshape(-1) if vec else sol), resid, rank, s


@op("lu")
def lu(x, pivot=True):
    # LAPACK's 1-based pivots, as the reference returns them
    lu_, piv = torch.linalg.lu_factor(x)
    return lu_, piv.to(torch.int32)


@op("det")
def det(x):
    return torch.linalg.det(x)


@op("slogdet")
def slogdet(x):
    sign, logdet = torch.linalg.slogdet(x)
    return torch.stack([sign, logdet])


@op("matrix_power")
def matrix_power(x, n):
    return torch.linalg.matrix_power(x, n)


@op("matrix_rank", differentiable=False)
def matrix_rank(x, tol=None, hermitian=False):
    return torch.linalg.matrix_rank(x, rtol=tol).to(torch.int32)


@op("cond")
def cond(x, p=None):
    """JAX's cond: the singular-value ratio for p None / ±2, else
    ‖x‖ₚ ‖x⁻¹‖ₚ; NaN becomes inf where x has no NaN."""
    if p is None or p == 2:
        s = torch.linalg.svdvals(x)
        return s[..., 0] / s[..., -1]
    if p == -2:
        s = torch.linalg.svdvals(x)
        r = s[..., -1] / s[..., 0]
    else:
        r = torch.linalg.matrix_norm(x, ord=p) * \
            torch.linalg.matrix_norm(torch.linalg.inv(x), ord=p)
    return torch.where(torch.isnan(r) & ~torch.isnan(x).any(-1).any(-1),
                       float("inf"), r)


@op("multi_dot", amp="cast")
def multi_dot(xs):
    return torch.linalg.multi_dot(list(xs))


@op("einsum", amp="cast")
def einsum(equation, *operands):
    return torch.einsum(equation, *operands)


@op("tensordot", amp="cast")
def tensordot(x, y, axes=2):
    if isinstance(axes, (list, tuple)):
        axes = [list(a) if isinstance(a, (list, tuple)) else [a]
                for a in axes]
    return torch.tensordot(x, y, dims=axes)


def _linspace(lo, hi, num, dtype):
    """JAX's linspace: lo (1 - t) + hi t on t = i / (num - 1), the last
    point hi itself."""
    div = num - 1
    t = torch.arange(div, dtype=dtype, device=lo.device) / div
    return torch.cat([lo * (1 - t) + hi * t, hi.reshape(1)])


def _bin_edges(x, bins, lo=None, hi=None):
    dt = x.dtype if x.dtype.is_floating_point else torch.float32
    if lo is None:
        lo, hi = x.min(), x.max()
    lo = torch.as_tensor(lo, dtype=dt, device=x.device)
    hi = torch.as_tensor(hi, dtype=dt, device=x.device)
    flat = lo == hi
    lo, hi = torch.where(flat, lo - 0.5, lo), torch.where(flat, hi + 0.5, hi)
    return _linspace(lo, hi, bins + 1, dt)


@op("histogram", differentiable=False)
def histogram(x, bins=100, min=0, max=0):  # noqa: A002
    xf = x if x.dtype.is_floating_point else x.to(torch.float32)
    edges = _bin_edges(xf, bins) if min == 0 and max == 0 else \
        _bin_edges(xf, bins, min, max)
    flat = xf.reshape(-1)
    idx = torch.searchsorted(edges, flat, right=True)
    idx = torch.where(flat == edges[-1], edges.numel() - 1, idx)
    counts = torch.zeros(edges.numel() + 1, dtype=xf.dtype, device=x.device)
    # an index past the last edge is dropped, as JAX's scatter drops it
    counts.index_add_(0, idx, torch.ones_like(flat))
    return counts[1:edges.numel()]


@op("bincount", differentiable=False)
def bincount(x, weights=None, minlength=0):
    x = x.reshape(-1).long()
    n = max(int(minlength), int(x.max()) + 1 if x.numel() else 0)
    if weights is None:
        return torch.zeros(n, dtype=torch.int32, device=x.device) \
            .index_add_(0, x, torch.ones_like(x, dtype=torch.int32))
    w = weights.reshape(-1)
    return torch.zeros(n, dtype=w.dtype, device=x.device).index_add_(0, x, w)


def _cov(x, rowvar=True, ddof=1, fweights=None, aweights=None):
    x = x if x.dtype.is_floating_point else x.to(torch.float32)
    if x.ndim < 2:
        x = x.reshape(1, -1)
    if not rowvar and x.shape[0] != 1:
        x = x.mT
    return torch.cov(x, correction=ddof, fweights=fweights,
                     aweights=aweights)


@op("corrcoef")
def corrcoef(x, rowvar=True):
    c = _cov(x, rowvar)
    if c.ndim == 0:
        return c / c
    d = torch.diagonal(c)
    std = torch.sqrt(torch.real(d))
    c = c / std[:, None]
    c = c / std[None, :]
    return torch.clamp(c, -1, 1)


@op("cov")
def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None):
    return _cov(x, rowvar, 1 if ddof else 0, fweights, aweights)


@op("householder_product")
def householder_product(x, tau):
    m, n = x.shape[-2], x.shape[-1]
    q = torch.eye(m, dtype=x.dtype, device=x.device) \
        .expand(x.shape[:-2] + (m, m))
    rows = torch.arange(m, device=x.device)
    for i in range(n):
        col = x[..., :, i]
        col = torch.where(rows == i, torch.ones_like(col), col)
        v = torch.where(rows < i, torch.zeros_like(col), col)[..., :, None]
        t = tau[..., i]
        if t.ndim:
            t = t[..., None, None]
        q = q - t * (q @ v) @ v.mT
    return q[..., :, :n]


def _perm_from_pivots(piv, m):
    """Row order after LAPACK's swaps (0-based pivots [..., k])."""
    batch = piv.shape[:-1]
    p = piv.reshape(-1, piv.shape[-1]).long()
    perm = torch.arange(m, device=piv.device).expand(p.shape[0], m).clone()
    for i in range(p.shape[1]):
        j = p[:, i:i + 1]
        pi = perm[:, i:i + 1].clone()
        perm[:, i:i + 1] = perm.gather(1, j)
        perm.scatter_(1, j, pi)
    return perm.reshape(batch + (m,))


@op("lu_unpack")
def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True):
    """(P, L, U) from packed LU data and 1-based pivots (the reference's
    lu_unpack)."""
    m, n = x.shape[-2], x.shape[-1]
    k = min(m, n)
    L = torch.tril(x, -1)[..., :, :k] + torch.eye(m, k, dtype=x.dtype,
                                                   device=x.device)
    U = torch.triu(x)[..., :k, :]
    perm = _perm_from_pivots(y.long() - 1, m)
    P = torch.nn.functional.one_hot(perm, m).mT.to(x.dtype)
    return P, L, U


@op("cholesky_inverse")
def cholesky_inverse(x, upper=False):
    """(L Lᵀ)⁻¹ from the Cholesky factor (the reference's expression)."""
    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    y = torch.linalg.solve_triangular(_lower(x, upper), eye, upper=False)
    return y.mT @ y


@op("matrix_exp")
def matrix_exp(x):
    return torch.linalg.matrix_exp(x)


@op("ormqr")
def ormqr(x, tau, y, left=True, transpose=False):
    """Multiply by Q of a Householder QR (the reference's ormqr): Q made
    from the reflectors, batch dimensions broadcast."""
    m, k = x.shape[-2], x.shape[-1]
    eye = torch.eye(m, dtype=x.dtype, device=x.device)
    q = eye.expand(x.shape[:-2] + (m, m))
    rows = torch.arange(m, device=x.device)
    for i in range(k):
        col = x[..., :, i]
        v = torch.where(rows < i, torch.zeros_like(col),
                        torch.where(rows == i, torch.ones_like(col), col))
        # a matrix takes tau[i] as it is (a row of a 2-D tau broadcasts
        # over the columns, as in the reference); a batch its scalars
        t = tau[i] if x.ndim == 2 else tau[..., i, None, None]
        h = eye - t * (v[..., :, None] * v[..., None, :])
        q = q @ h
    if transpose:
        q = q.mT
    return q @ y if left else y @ q


def _data(t):
    return t._data if isinstance(t, Tensor) else as_torch(t)


def svd_lowrank(x, q=6, niter=2, M=None, name=None):
    """Randomized low-rank SVD (the reference's svd_lowrank; Halko et
    al.): the range of x Ω, Ω Gaussian from the package's generator,
    refined by ``niter`` power steps."""
    a = _data(x)
    if M is not None:
        a = a - _data(M)
    m, n = a.shape[-2], a.shape[-1]
    q = min(q, m, n)
    gen = prandom.default_generator().torch_generator(a.device)
    omega = torch.randn(a.shape[:-2] + (n, q), dtype=a.dtype,
                        device=a.device, generator=gen)
    y = a @ omega
    for _ in range(niter):
        y = a @ (a.mT @ y)
    qmat, _ = torch.linalg.qr(y)
    u_b, s, vh = torch.linalg.svd(qmat.mT @ a, full_matrices=False)
    return Tensor(qmat @ u_b), Tensor(s), Tensor(vh.mT)


def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    """Randomized PCA (the reference's pca_lowrank): (U, S, V) of the
    centred data matrix."""
    a = _data(x)
    m, n = a.shape[-2], a.shape[-1]
    if q is None:
        q = min(6, m, n)
    if center:
        a = a - a.mean(dim=-2, keepdim=True)
    return svd_lowrank(Tensor(a), q=q, niter=niter)


def fp8_fp8_half_gemm_fused(x, y, bias=None, transpose_x=False,
                            transpose_y=False, output_dtype="float16",
                            scale=1.0, name=None):
    """fp8 × fp8 → half GEMM, as the reference computes it: both operands
    upcast to fp32, an fp32 product times ``scale``, plus bias, cast to
    ``output_dtype``."""
    a, b = _data(x), _data(y)
    if transpose_x:
        a = a.mT
    if transpose_y:
        b = b.mT
    out = torch.matmul(a.float(), b.float()) * scale
    if bias is not None:
        out = out + _data(bias).float()
    return Tensor(out.to(convert_dtype(output_dtype)))


__all__ = [
    "norm", "vector_norm", "matrix_norm", "dist", "cholesky",
    "cholesky_solve", "qr", "svd", "svdvals", "eig", "eigh", "eigvals",
    "eigvalsh", "inverse", "inv", "pinv", "solve", "triangular_solve",
    "lstsq", "lu", "det", "slogdet", "matrix_power", "matrix_rank", "cond",
    "multi_dot", "einsum", "tensordot", "histogram", "bincount", "corrcoef",
    "cov", "householder_product", "lu_unpack", "cholesky_inverse",
    "matrix_exp", "ormqr", "svd_lowrank", "pca_lowrank",
    "fp8_fp8_half_gemm_fused",
]
