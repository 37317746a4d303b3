"""ASP: n:m (default 2:4) structured sparsity training (port of
paddle_tpu/incubate/asp; Paddle's python/paddle/incubate/asp/asp.py and
utils.py).

``prune_model`` prunes the weights of a model's Linear- and Conv-family
sublayers to an n:m pattern and registers their masks; ``decorate``
wraps an optimizer so that every step re-applies them. The masks are
tensors on their parameter's device, computed there (``get_mask_1d``:
the n largest magnitudes of every m consecutive entries, ties to the
earlier entry; ``get_mask_2d_greedy``: each m x m tile greedily, in
descending magnitude, keeping an entry while its row and column hold
fewer than n, all tiles at once), and re-applied in place. The
registry holds each parameter weakly, as the reference's. Given numpy
arrays the mask functions return numpy arrays, as the reference's.
Sparse tensor cores (2:4 ``mma.sp``) are not used: the reference has
no such path, and pruned weights are stored and multiplied dense.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from ...core.tensor import Tensor

__all__ = [
    "calculate_density", "check_sparsity", "get_mask_1d",
    "get_mask_2d_greedy", "prune_model", "decorate",
    "set_excluded_layers", "reset_excluded_layers",
    "OptimizerWithSparsityGuarantee",
]

# layer-name exclusions per model id (reference ASPHelper MASK maps)
_EXCLUDED: dict[int, set] = {}
# id(param) -> (weakref(param), mask Tensor): weak, so that a pruned model
# can be garbage collected
_MASKS: dict[int, tuple] = {}


def _torch(x) -> torch.Tensor:
    if isinstance(x, Tensor):
        return x._data.detach()
    if isinstance(x, torch.Tensor):
        return x.detach()
    return torch.from_numpy(np.array(x))


def _like(mask: torch.Tensor, x):
    """``mask`` in the kind of container ``x`` came in."""
    if isinstance(x, Tensor):
        return Tensor(mask)
    if isinstance(x, torch.Tensor):
        return mask
    return mask.numpy()


def calculate_density(x) -> float:
    """Fraction of nonzeros (reference asp.py calculate_density)."""
    t = _torch(x)
    return float(torch.count_nonzero(t)) / max(t.numel(), 1)


def _mask_1d(w: torch.Tensor, n: int, m: int) -> torch.Tensor:
    if w.numel() % m:
        raise ValueError(f"weight size {w.numel()} not divisible by m={m}")
    flat = w.reshape(-1, m)
    idx = torch.argsort(-flat.abs(), dim=1, stable=True)[:, :n]
    mask = torch.zeros_like(flat)
    mask.scatter_(1, idx, 1)
    return mask.reshape(w.shape)


def get_mask_1d(weight, n: int = 2, m: int = 4):
    """Keep the ``n`` largest-magnitude entries in every group of ``m``
    consecutive elements along the last axis (reference
    incubate/asp/utils.py get_mask_1d)."""
    return _like(_mask_1d(_torch(weight), n, m), weight)


def _mask_2d_greedy(w: torch.Tensor, n: int, m: int) -> torch.Tensor:
    if w.dim() != 2 or w.shape[0] % m or w.shape[1] % m:
        return _mask_1d(w, n, m)
    R, C = w.shape
    tiles = w.abs().reshape(R // m, m, C // m, m).permute(0, 2, 1, 3) \
        .reshape(-1, m * m)
    T = tiles.shape[0]
    order = torch.argsort(-tiles, dim=1, stable=True)
    at = torch.arange(T, device=w.device)
    rows = torch.zeros((T, m), dtype=torch.int64, device=w.device)
    cols = torch.zeros_like(rows)
    keep = torch.zeros((T, m * m), dtype=torch.bool, device=w.device)
    for j in range(m * m):
        f = order[:, j]
        r, c = f // m, f % m
        ok = (rows[at, r] < n) & (cols[at, c] < n)
        keep[at, f] = ok
        rows[at, r] += ok
        cols[at, c] += ok
    return keep.to(w.dtype).reshape(R // m, C // m, m, m) \
        .permute(0, 2, 1, 3).reshape(R, C)


def get_mask_2d_greedy(weight, n: int = 2, m: int = 4):
    """2-D variant: n:m along rows AND columns of each m x m tile, greedy
    (reference get_mask_2d_greedy). Falls back to 1-D for non-2D."""
    return _like(_mask_2d_greedy(_torch(weight), n, m), weight)


_MASK_ALGOS = {
    "mask_1d": _mask_1d,
    "mask_2d_greedy": _mask_2d_greedy,
    "mask_2d_best": _mask_2d_greedy,  # greedy is the deployable subset
}


def check_sparsity(x, n: int = 2, m: int = 4) -> bool:
    """True iff every m-group along the last axis has at most ``n``
    nonzeros (reference check_mask_1d)."""
    t = _torch(x)
    if t.numel() % m:
        return False
    return bool(((t.reshape(-1, m) != 0).sum(1) <= n).all())


def set_excluded_layers(model, layer_names):
    """Skip these sublayer names when pruning (reference
    asp.set_excluded_layers)."""
    _EXCLUDED.setdefault(id(model), set()).update(layer_names)


def reset_excluded_layers(model=None):
    if model is None:
        _EXCLUDED.clear()
    else:
        _EXCLUDED.pop(id(model), None)


def _prunable_params(model):
    """(name, param) pairs eligible for n:m pruning: 2-D+ weights of
    Linear/Conv-family sublayers (reference ASPHelper._is_supported_layer)."""
    excluded = _EXCLUDED.get(id(model), set())
    out = []
    for name, layer in model.named_sublayers(include_self=True):
        if name in excluded:
            continue
        w = getattr(layer, "weight", None)
        if w is not None and isinstance(w, Tensor) and w.ndim >= 2:
            out.append((name or type(layer).__name__, w))
    return out


def _register_mask(w, mask: Tensor) -> None:
    """Register ``mask`` for parameter ``w`` (held weakly) so that a
    decorated optimizer re-applies it."""
    key = id(w)
    _MASKS[key] = (weakref.ref(w, lambda _, k=key: _MASKS.pop(k, None)),
                   mask)


def prune_model(model, n: int = 2, m: int = 4, mask_algo: str = "mask_1d",
                with_mask: bool = True):
    """Prune supported weights to n:m and (with_mask) register masks so a
    decorated optimizer keeps them sparse (reference asp.prune_model).
    Returns {sublayer name: mask Tensor on the weight's device}."""
    algo = _MASK_ALGOS[mask_algo]
    masks = {}
    for name, w in _prunable_params(model):
        mask = algo(w._data.detach(), n, m)
        with torch.no_grad():
            w._data.mul_(mask)
        mask_t = Tensor(mask, stop_gradient=True)
        masks[name] = mask_t
        if with_mask:
            _register_mask(w, mask_t)
    return masks


class OptimizerWithSparsityGuarantee:
    """Re-applies registered masks after every step (reference
    asp.decorate → OptimizerWithSparsityGuarantee), in place."""

    def __init__(self, optimizer):
        self._optimizer = optimizer

    def step(self):
        self._optimizer.step()
        with torch.no_grad():
            for key, (wref, mask) in list(_MASKS.items()):
                w = wref()
                if w is None:
                    del _MASKS[key]
                    continue
                w._data.mul_(mask._data)

    def __getattr__(self, name):
        return getattr(self._optimizer, name)


def decorate(optimizer) -> OptimizerWithSparsityGuarantee:
    return OptimizerWithSparsityGuarantee(optimizer)
