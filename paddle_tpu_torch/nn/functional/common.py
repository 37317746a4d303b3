"""Common functionals: linear, dropout, padding, interpolate, similarity
(port of paddle_tpu/nn/functional/common.py).

``linear`` keeps the reference's weight layout, ``[in, out]``. Dropout
draws its mask from the port's generator (core/random.py) at call time:
the reference's distribution, other bits. ``interpolate`` computes
``jax.image.resize``'s function (half-pixel nearest; linear and Keys
cubic kernels with antialiasing when downsampling), and its own
coordinate map under ``align_corners``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as TF

from ...core import random as prandom
from ...core.dispatch import op, register_split_vjp

__all__ = [
    "linear", "dropout", "dropout2d", "dropout3d", "alpha_dropout",
    "pad", "zeropad2d", "interpolate", "upsample", "cosine_similarity",
    "pixel_shuffle", "pixel_unshuffle", "channel_shuffle", "label_smooth",
    "bilinear", "unfold", "fold", "class_center_sample",
]


@op("linear", amp="cast")
def linear(x, weight, bias=None):
    # weight [in, out], as the reference's
    out = torch.matmul(x, weight)
    if bias is not None:
        out = out + bias
    return out


def _linear_splits(arrays, wslots) -> bool:
    """An activation times a 2-D leaf parameter, with no bias or a leaf
    bias of the output's width."""
    x, w = arrays[0], arrays[1]
    b = arrays[2] if len(arrays) > 2 else None
    return 1 in wslots and w.dim() == 2 and x.dim() >= 2 and (
        b is None or (2 in wslots and tuple(b.shape) == (w.shape[1],)))


@register_split_vjp("linear", _linear_splits)
def _linear_split_vjp(arrays, wslots, kwargs, cots):
    """The zero-bubble split of ``linear``'s backward: dx now, dW and db
    deferred (core/dispatch.py reads it for the zero-bubble pipeline)."""
    x, w = arrays[0], arrays[1]
    b = arrays[2] if len(arrays) > 2 else None
    g = cots[0]
    dx = torch.matmul(g, w.t()).to(x.dtype)
    in_grads = [dx] + [None] * (len(arrays) - 1)

    def wgrad():
        g2 = g.reshape(-1, g.shape[-1])
        x2 = x.reshape(-1, x.shape[-1])
        out = {1: torch.matmul(x2.t(), g2).to(w.dtype)}
        if b is not None:
            out[2] = g2.sum(0).to(b.dtype)
        return out

    return in_grads, wgrad


def _generator(x):
    return prandom.default_generator().torch_generator(x._data.device)


def _keep_mask(gen, shape, keep: float, device):
    """Bernoulli(keep) over ``shape``, drawn from ``gen``."""
    return torch.rand(tuple(shape), generator=gen, device=device) < keep


def _apply_mask(x, mask, keep: float, upscale: bool):
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    kept = x / keep if upscale else x
    return torch.where(mask, kept, zero).to(x.dtype)


@op("dropout_impl")
def _dropout_impl(x, gen, p: float, upscale: bool):
    keep = 1.0 - p
    return _apply_mask(x, _keep_mask(gen, x.shape, keep, x.device), keep,
                       upscale)


def dropout(
    x,
    p: float = 0.5,
    axis=None,
    training: bool = True,
    mode: str = "upscale_in_train",
    name=None,
):
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    if p == 1.0:
        return x * 0.0
    gen = _generator(x)
    upscale = mode == "upscale_in_train"
    if axis is None:
        return _dropout_impl(x, gen, float(p), upscale)

    # a mask over the named axes, broadcast over the others
    axes = [axis] if isinstance(axis, int) else list(axis)
    shape = [d if i in axes else 1 for i, d in enumerate(x.shape)]

    @op("dropout_axis")
    def _dropout_axis(xx):
        keep = 1.0 - p
        return _apply_mask(xx, _keep_mask(gen, shape, keep, xx.device),
                           keep, upscale)

    return _dropout_axis(x)


def _feature_dropout(x, p, training, data_format, spatial_ndim):
    if not training or p == 0.0:
        return x
    gen = _generator(x)
    cf = data_format.startswith("NC")

    @op("feature_dropout")
    def _impl(xx):
        shp = tuple(xx.shape)
        if cf:
            mask_shape = shp[:2] + (1,) * spatial_ndim
        else:
            mask_shape = (shp[0],) + (1,) * spatial_ndim + (shp[-1],)
        keep = 1.0 - p
        return _apply_mask(xx, _keep_mask(gen, mask_shape, keep, xx.device),
                           keep, True)

    return _impl(x)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    return _feature_dropout(x, p, training, data_format, 2)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    return _feature_dropout(x, p, training, data_format, 3)


def alpha_dropout(x, p=0.5, training=True, name=None):
    if not training or p == 0.0:
        return x
    gen = _generator(x)

    @op("alpha_dropout")
    def _impl(xx):
        alpha = 1.6732632423543772848170429916717
        scale = 1.0507009873554804934193349852946
        alpha_p = -alpha * scale
        keep = 1.0 - p
        a = (keep + alpha_p ** 2 * keep * (1 - keep)) ** -0.5
        b = -a * alpha_p * (1 - keep)
        mask = _keep_mask(gen, xx.shape, keep, xx.device)
        fill = torch.as_tensor(alpha_p, dtype=xx.dtype, device=xx.device)
        return (a * torch.where(mask, xx, fill) + b).to(xx.dtype)

    return _impl(x)


def _to_pairs(pad_arg, n):
    p = list(pad_arg)
    if len(p) == 2 * n:
        return [(int(p[2 * i]), int(p[2 * i + 1])) for i in range(n)]
    raise ValueError(f"bad pad length {len(p)} for {n} spatial dims")


_NP_PAD = {"reflect": "reflect", "replicate": "edge", "circular": "wrap"}


@op("pad")
def pad(x, pad, mode: str = "constant", value: float = 0.0,  # noqa: A002
        data_format: str = "NCHW"):
    # a pad of 2 * ndim entries pairs every dim in order; a shorter one
    # pads the spatial dims of ``data_format``
    nd = x.dim()
    pad = [int(v) for v in (pad.tolist() if isinstance(pad, torch.Tensor)
                            else pad)]
    if len(pad) == 2 * nd:
        cfg = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        n_spatial = len(pad) // 2
        pairs = _to_pairs(pad, n_spatial)
        cfg = [(0, 0)] * nd
        first = 2 if data_format.startswith("NC") else 1
        for i in range(n_spatial):
            cfg[first + i] = pairs[i]
    if mode == "constant":
        flat = []
        for lo, hi in reversed(cfg):
            flat += [lo, hi]
        return TF.pad(x, flat, mode="constant", value=value)
    out = x
    for d, (lo, hi) in enumerate(cfg):
        if lo or hi:
            idx = np.pad(np.arange(x.shape[d]), (lo, hi), mode=_NP_PAD[mode])
            out = torch.index_select(out, d, torch.as_tensor(
                idx, device=x.device))
    return out


def zeropad2d(x, padding, data_format="NCHW", name=None):
    return pad(x, padding, mode="constant", value=0.0,
               data_format=data_format)


@op("cosine_similarity")
def cosine_similarity(x1, x2, axis: int = 1, eps: float = 1e-8):
    dot = torch.sum(x1 * x2, dim=axis)
    n1 = torch.sqrt(torch.sum(x1 * x1, dim=axis))
    n2 = torch.sqrt(torch.sum(x2 * x2, dim=axis))
    return dot / torch.clamp_min(n1 * n2, eps)


@op("pixel_shuffle")
def pixel_shuffle(x, upscale_factor: int, data_format: str = "NCHW"):
    r = upscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, c // (r * r), r, r, h, w)
        x = x.permute(0, 1, 4, 2, 5, 3)
        return x.reshape(n, c // (r * r), h * r, w * r)
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, r, r, c // (r * r))
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * r, w * r, c // (r * r))


@op("pixel_unshuffle")
def pixel_unshuffle(x, downscale_factor: int, data_format: str = "NCHW"):
    r = downscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, c, h // r, r, w // r, r)
        x = x.permute(0, 1, 3, 5, 2, 4)
        return x.reshape(n, c * r * r, h // r, w // r)
    n, h, w, c = x.shape
    x = x.reshape(n, h // r, r, w // r, r, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // r, w // r, c * r * r)


@op("channel_shuffle")
def channel_shuffle(x, groups: int, data_format: str = "NCHW"):
    if data_format == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, groups, c // groups, h, w)
        x = x.permute(0, 2, 1, 3, 4)
        return x.reshape(n, c, h, w)
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, groups, c // groups)
    x = x.permute(0, 1, 2, 4, 3)
    return x.reshape(n, h, w, c)


@op("label_smooth")
def label_smooth(label, prior_dist=None, epsilon: float = 0.1):
    n_classes = label.shape[-1]
    if prior_dist is not None:
        return (1.0 - epsilon) * label + epsilon * prior_dist
    return (1.0 - epsilon) * label + epsilon / n_classes


@op("bilinear")
def bilinear(x1, x2, weight, bias=None):
    # weight: [out_features, in1, in2]
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    if bias is not None:
        out = out + bias
    return out


def _triangle(x):
    return torch.clamp_min(1 - torch.abs(x), 0)


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(out), out)


def _resize_weights(n_in: int, n_out: int, kernel, device) -> torch.Tensor:
    """[n_in, n_out] interpolation weights of ``jax.image.resize``
    (scale n_out / n_in, no translation, antialiased): half-pixel
    sample positions, the kernel widened by 1 / scale when downsampling,
    each column normalised to sum 1, zero where the sample falls outside
    the input."""
    scale = n_out / n_in
    inv = 1.0 / scale
    kscale = max(inv, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device)
              + 0.5) * inv - 0.5
    pos = torch.arange(n_in, dtype=torch.float32, device=device)
    w = kernel(torch.abs(sample[None, :] - pos[:, None]) / kscale)
    total = w.sum(0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(torch.abs(total) > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _resize_nearest(x, dims, size):
    for d, n in zip(dims, size):
        m = x.shape[d]
        if m == n:
            continue
        off = (torch.arange(n, dtype=torch.float32) + 0.5) * m / n
        idx = torch.floor(off).to(torch.int64).to(x.device)
        x = torch.index_select(x, d, idx)
    return x


def _resize_kernel(x, dims, size, kernel):
    out = x if x.is_floating_point() else x.float()
    for d, n in zip(dims, size):
        m = out.shape[d]
        if m == n:
            continue
        w = _resize_weights(m, n, kernel, out.device).to(out.dtype)
        out = torch.movedim(torch.tensordot(out, w, dims=([d], [0])), -1, d)
    return out


def _resize_axis_aligned(arr, axis, new_len):
    old_len = arr.shape[axis]
    if new_len == old_len:
        return arr
    if new_len == 1 or old_len == 1:
        idx = torch.zeros((new_len,), dtype=torch.int64, device=arr.device)
        return torch.index_select(arr, axis, idx)
    pos = torch.linspace(0.0, old_len - 1.0, new_len, device=arr.device)
    lo = torch.floor(pos).to(torch.int64)
    hi = torch.clamp(lo + 1, 0, old_len - 1)
    w = (pos - lo).to(arr.dtype)
    shape = [1] * arr.dim()
    shape[axis] = new_len
    w = w.reshape(shape)
    return (torch.index_select(arr, axis, lo) * (1 - w)
            + torch.index_select(arr, axis, hi) * w)


_RESIZE_METHOD = {"nearest": "nearest", "bilinear": "linear",
                  "trilinear": "linear", "linear": "linear",
                  "bicubic": "cubic", "area": "linear"}


@op("interpolate")
def interpolate(
    x,
    size=None,
    scale_factor=None,
    mode: str = "nearest",
    align_corners: bool = False,
    align_mode: int = 0,
    data_format: str = "NCHW",
):
    channel_first = data_format.startswith("NC")
    spatial = x.shape[2:] if channel_first else x.shape[1:-1]
    n_sp = len(spatial)
    if size is None:
        if scale_factor is None:
            raise ValueError("one of size / scale_factor must be set")
        sf = ([scale_factor] * n_sp
              if not isinstance(scale_factor, (list, tuple))
              else list(scale_factor))
        size = [int(math.floor(s * f)) for s, f in zip(spatial, sf)]
    size = [int(s) for s in (size if isinstance(size, (list, tuple))
                             else [size])]
    method = _RESIZE_METHOD[mode.lower()]
    first = 2 if channel_first else 1
    dims = list(range(first, first + n_sp))
    if method == "nearest":
        return _resize_nearest(x, dims, size)
    if not align_corners:
        kernel = _triangle if method == "linear" else _keys_cubic
        return _resize_kernel(x, dims, size, kernel).to(x.dtype)
    out = x
    for ax, s in zip(dims, size):
        out = _resize_axis_aligned(out, ax, s)
    return out.to(x.dtype)


def upsample(
    x, size=None, scale_factor=None, mode="nearest", align_corners=False,
    align_mode=0, data_format="NCHW", name=None,
):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _paddings(p):
    if isinstance(p, int):
        return p, p, p, p
    if len(p) == 2:
        return p[0], p[0], p[1], p[1]
    pt, pl, pb, pr = p
    return pt, pb, pl, pr


@op("unfold")
def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1):
    # im2col: x [N, C, H, W] -> [N, C*kh*kw, L]
    kh, kw = _pair(kernel_sizes)
    sh, sw = _pair(strides)
    dh, dw = _pair(dilations)
    pt, pb, pl, pr = _paddings(paddings)
    n, c, h, w = x.shape
    x = TF.pad(x, [pl, pr, pt, pb])
    oh = (h + pt + pb - dh * (kh - 1) - 1) // sh + 1
    ow = (w + pl + pr - dw * (kw - 1) - 1) // sw + 1
    patches = [x[:, :, i * dh:i * dh + sh * (oh - 1) + 1:sh,
                 j * dw:j * dw + sw * (ow - 1) + 1:sw]
               for i in range(kh) for j in range(kw)]
    out = torch.stack(patches, dim=2)  # [N, C, kh*kw, oh, ow]
    return out.reshape(n, c * kh * kw, oh * ow)


@op("fold")
def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1):
    oh_out, ow_out = _pair(output_sizes)
    kh, kw = _pair(kernel_sizes)
    sh, sw = _pair(strides)
    dh, dw = _pair(dilations)
    pt, pb, pl, pr = _paddings(paddings)
    n, ckk, _ = x.shape
    c = ckk // (kh * kw)
    oh = (oh_out + pt + pb - dh * (kh - 1) - 1) // sh + 1
    ow = (ow_out + pl + pr - dw * (kw - 1) - 1) // sw + 1
    x = x.reshape(n, c, kh, kw, oh, ow)
    out = torch.zeros((n, c, oh_out + pt + pb, ow_out + pl + pr),
                      dtype=x.dtype, device=x.device)
    for i in range(kh):
        for j in range(kw):
            out[:, :, i * dh:i * dh + sh * (oh - 1) + 1:sh,
                j * dw:j * dw + sw * (ow - 1) + 1:sw] += x[:, :, i, j]
    return out[:, :, pt:pt + oh_out, pl:pl + ow_out]


@op("class_center_sample", differentiable=False)
def _class_center_sample_impl(label, noise, *, num_classes, num_samples,
                              rank, world):
    lab = label.to(torch.int64)
    dev = lab.device
    remapped = lab
    my_sampled = None
    for r in range(world):
        lo = r * num_classes
        in_shard = (lab >= lo) & (lab < lo + num_classes)
        local = torch.where(in_shard, lab - lo, torch.zeros_like(lab))
        pos = torch.zeros((num_classes,), dtype=torch.float32, device=dev)
        pos = pos.index_reduce(0, local.reshape(-1),
                               in_shard.reshape(-1).float(), "amax")
        order = torch.argsort(noise[r] - pos, stable=True)  # positives first
        sampled = torch.sort(order[:num_samples]).values
        inv = torch.full((num_classes,), -1, dtype=torch.int64, device=dev)
        inv[sampled] = torch.arange(num_samples, device=dev)
        remapped = torch.where(in_shard, r * num_samples + inv[local],
                               remapped)
        if r == rank:
            my_sampled = sampled + r * num_classes
    return remapped.to(torch.int32), my_sampled.to(torch.int32)


def class_center_sample(label, num_classes, num_samples, group=None):
    """Sample ``num_samples`` class centers containing every positive
    class of the batch; returns (remapped_label, sampled_class_index).

    ``group``: classes sharded over model-parallel ranks; each rank owns
    [rank * num_classes, (rank + 1) * num_classes) and ``label`` is the
    whole batch. The ranks must share the generator's seed: each draws
    every rank's noise and so reproduces every peer's sample without
    exchanging it (the reference's cross-rank positive exchange).
    """
    rank, world = 0, 1
    if group is not None:
        rank = getattr(group, "rank", 0)
        world = getattr(group, "nranks", getattr(group, "world_size", 1))
    arr = np.asarray(label.numpy()).reshape(-1)
    for r in range(world):
        lo = r * num_classes
        n_pos = len(np.unique(arr[(arr >= lo) & (arr < lo + num_classes)]))
        if n_pos > num_samples:
            raise ValueError(
                f"class_center_sample: shard {r} has {n_pos} distinct "
                f"positive classes > num_samples={num_samples}")
    dev = label._data.device
    gen = prandom.default_generator().torch_generator(dev)
    noise = torch.rand((world, num_classes), generator=gen, device=dev)
    return _class_center_sample_impl(
        label, noise, num_classes=num_classes, num_samples=num_samples,
        rank=rank, world=world)
