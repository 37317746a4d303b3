"""The op library's parity tranche (port of paddle_tpu/ops/parity.py):
the fake-quantize and dequantize family, the pooling and detection
extras, the MoE auxiliaries, the misc math and debug ops, and the
packed attention wrappers.

Each op is a torch impl through the funnel with the reference's name,
``differentiable`` flag and AMP policy. ``flash_attn_qkvpacked`` runs
the port's ``flash_attention_raw`` (K1-sep forward, K3-sep backward on
the card); ``flash_attn_varlen_qkvpacked`` runs ``flash_attn_unpadded``;
``flashmask_attention`` the plain masked attention. Two reference
defects are not reproduced (ROADMAP Queue 3): ``random_routing``
compares the uniform draws it is given (``prob``), where the reference
draws its own (defect F), and ``flash_attn_varlen_qkvpacked`` passes
``flash_attn_unpadded`` its maximum lengths and scale, which the
reference leaves out, so that every call of the reference raises
(defect G).
"""

from __future__ import annotations

import math as _math

import numpy as np
import torch
import torch.nn.functional as F

from ..core import random as prandom
from ..core.dispatch import op
from ..core.tensor import Tensor, as_torch

__all__ = [
    # quantization kernels
    "fake_quantize_abs_max", "fake_channel_wise_quantize_abs_max",
    "fake_quantize_dequantize_abs_max",
    "fake_channel_wise_quantize_dequantize_abs_max",
    "fake_quantize_moving_average_abs_max",
    "fake_quantize_dequantize_moving_average_abs_max",
    "fake_quantize_range_abs_max", "fake_channel_wise_dequantize_max_abs",
    "fake_dequantize_max_abs", "dequantize_abs_max", "dequantize_log",
    "quantize_linear", "dequantize_linear", "apply_per_channel_scale",
    "llm_int8_linear", "lookup_table_dequant",
    # pooling / vision extras
    "lp_pool2d", "fractional_max_pool2d", "fractional_max_pool3d",
    "max_unpool2d", "max_unpool3d", "box_clip", "bipartite_match",
    "multiclass_nms3", "collect_fpn_proposals", "correlation",
    # MoE auxiliaries
    "number_count", "assign_pos", "limit_by_capacity",
    "prune_gate_by_capacity", "random_routing",
    # misc
    "affine_channel", "add_position_encoding", "fill_diagonal_tensor",
    "edit_distance", "identity_loss", "kl_div", "huber_loss",
    "truncated_gaussian_random", "read_file", "check_numerics",
    "accuracy_check", "flash_attn_qkvpacked", "flash_attn_varlen_qkvpacked",
    "flashmask_attention", "crf_decoding",
]


def _data(t):
    return t._data if isinstance(t, Tensor) else as_torch(t)


# ---------------------------------------------------------------------------
# quantization kernels
# ---------------------------------------------------------------------------

def _qmax(bit_length: int) -> float:
    return float((1 << (bit_length - 1)) - 1)


def _quant(x, scale, qm):
    return torch.clamp(torch.round(x / torch.clamp_min(scale, 1e-12) * qm),
                       -qm, qm)


@op("fake_quantize_abs_max", differentiable=False)
def fake_quantize_abs_max(x, bit_length: int = 8):
    """Symmetric per-tensor quantize; returns (q, scale)."""
    scale = torch.abs(x).max()
    return _quant(x, scale, _qmax(bit_length)), scale


@op("fake_channel_wise_quantize_abs_max", differentiable=False)
def fake_channel_wise_quantize_abs_max(x, bit_length: int = 8,
                                       quant_axis: int = 0):
    axes = tuple(i for i in range(x.ndim) if i != quant_axis)
    scale = torch.abs(x).amax(dim=axes, keepdim=True)
    return _quant(x, scale, _qmax(bit_length)), scale.reshape(-1)


def _ste(x, fake):
    """Straight-through estimator: the value of ``fake``, the identity
    gradient of ``x``."""
    return x + (fake - x).detach()


@op("fake_quantize_dequantize_abs_max")
def fake_quantize_dequantize_abs_max(x, bit_length: int = 8):
    qm = _qmax(bit_length)
    xs = x.detach()
    scale = torch.abs(xs).max()
    s = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(xs / s * qm), -qm, qm)
    return _ste(x, q * s / qm), scale


@op("fake_channel_wise_quantize_dequantize_abs_max")
def fake_channel_wise_quantize_dequantize_abs_max(x, bit_length: int = 8,
                                                  quant_axis: int = 0):
    qm = _qmax(bit_length)
    axes = tuple(i for i in range(x.ndim) if i != quant_axis)
    xs = x.detach()
    scale = torch.clamp_min(torch.abs(xs).amax(dim=axes, keepdim=True),
                            1e-12)
    q = torch.clamp(torch.round(xs / scale * qm), -qm, qm)
    return _ste(x, q * scale / qm), scale.reshape(-1)


def _ema(x, in_state, in_accum, moving_rate):
    state = moving_rate * in_state + 1.0
    accum = moving_rate * in_accum + torch.abs(x).max()
    return state, accum


@op("fake_quantize_moving_average_abs_max", differentiable=False)
def fake_quantize_moving_average_abs_max(x, in_state, in_accum, in_scale,
                                         moving_rate: float = 0.9,
                                         bit_length: int = 8):
    """Returns (q, scale, state, accum) with EMA scale tracking."""
    state, accum = _ema(x, in_state, in_accum, moving_rate)
    scale = accum / state
    return _quant(x, scale, _qmax(bit_length)), scale, state, accum


@op("fake_quantize_dequantize_moving_average_abs_max")
def fake_quantize_dequantize_moving_average_abs_max(
        x, in_state, in_accum, in_scale, moving_rate: float = 0.9,
        bit_length: int = 8):
    qm = _qmax(bit_length)
    xs = x.detach()
    state, accum = _ema(xs, in_state, in_accum, moving_rate)
    scale = torch.clamp_min(accum / state, 1e-12)
    q = torch.clamp(torch.round(xs / scale * qm), -qm, qm)
    return _ste(x, q * scale / qm), scale, state, accum


@op("fake_quantize_range_abs_max", differentiable=False)
def fake_quantize_range_abs_max(x, in_scale, window_size: int = 10000,
                                bit_length: int = 8):
    scale = torch.maximum(torch.abs(x).max(), torch.as_tensor(
        in_scale, dtype=x.dtype, device=x.device))
    return _quant(x, scale, _qmax(bit_length)), scale


@op("fake_dequantize_max_abs", differentiable=False)
def fake_dequantize_max_abs(x, scale, max_range: float):
    return x * scale / max_range


@op("dequantize_abs_max", differentiable=False)
def dequantize_abs_max(x, scale, max_range: float):
    return x.to(torch.float32) * scale / max_range


@op("fake_channel_wise_dequantize_max_abs", differentiable=False)
def fake_channel_wise_dequantize_max_abs(x, scales, quant_bits=(8,),
                                         quant_axis: int = 0):
    qm = _qmax(int(quant_bits[0]) if hasattr(quant_bits, "__len__")
               else int(quant_bits))
    s = scales[0] if isinstance(scales, (list, tuple)) else scales
    shape = [1] * x.ndim
    shape[quant_axis] = -1
    return x.to(torch.float32) * s.reshape(shape) / qm


@op("dequantize_log", differentiable=False)
def dequantize_log(x, dict_table):
    """Log-quantized codes index a dict table (flattened, the codes
    modulo its first dimension, as the reference takes); negative codes
    mirror."""
    idx = x.to(torch.int64)
    mag = dict_table.reshape(-1)[torch.abs(idx) % dict_table.shape[0]]
    return torch.where(idx < 0, -mag, mag)


def _per_axis(scale, nd, quant_axis):
    if isinstance(scale, torch.Tensor) and scale.ndim and quant_axis >= 0:
        shape = [1] * nd
        shape[quant_axis] = -1
        return scale.reshape(shape)
    return scale


@op("quantize_linear", differentiable=False)
def quantize_linear(x, scale, zero_point=None, quant_axis: int = -1,
                    bit_length: int = 8):
    qm = _qmax(bit_length)
    scale = _per_axis(scale, x.ndim, quant_axis)
    if not isinstance(scale, torch.Tensor):
        scale = torch.as_tensor(scale, dtype=x.dtype, device=x.device)
    q = torch.clamp(torch.round(x / torch.clamp_min(scale, 1e-12)), -qm, qm)
    return q.to(torch.int8)


@op("dequantize_linear", differentiable=False)
def dequantize_linear(q, scale, zero_point=None, quant_axis: int = -1):
    return q.to(torch.float32) * _per_axis(scale, q.ndim, quant_axis)


@op("apply_per_channel_scale")
def apply_per_channel_scale(x, scales):
    """x [*, K] scaled per input channel (the smooth-quant prepass)."""
    return x * scales.reshape((1,) * (x.ndim - 1) + (-1,))


@op("llm_int8_linear")
def llm_int8_linear(x, w_int8, w_scale, threshold: float = 6.0):
    """x @ (int8 W · scale / 127)ᵀ: the weight dequantized per output
    row in x's dtype, one product (the reference's one-pass form)."""
    w = w_int8.to(x.dtype) * (w_scale.to(x.dtype) / 127.0)[:, None]
    return torch.matmul(x, w.mT)


@op("lookup_table_dequant", differentiable=False)
def lookup_table_dequant(w_q, scale, ids):
    """Embedding lookup from an abs-max-quantized table."""
    ids = ids.long()
    return w_q[ids].to(torch.float32) * scale[ids][..., None]


# ---------------------------------------------------------------------------
# pooling / vision extras
# ---------------------------------------------------------------------------

def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


@op("lp_pool2d")
def lp_pool2d(x, norm_type: float = 2.0, kernel_size=2, stride=None,
              padding: int = 0):
    """Power-average pooling: (Σ |x|ᵖ)^(1/p) over each window."""
    k = _pair(kernel_size)
    s = _pair(stride or k)
    p = float(norm_type)
    xp = torch.abs(x) ** p
    if padding:
        xp = F.pad(xp, (padding,) * 4)
    summed = F.avg_pool2d(xp, k, s, divisor_override=1)
    return summed ** (1.0 / p)


def _fractional_pool(x, output_size, spatial, random_u=None):
    """Fractional max pooling with the reference's region boundaries:
    floor(α (i + u)) in float32, α = in / out, u = 0.5 by default."""
    nd = len(spatial)
    out = tuple(output_size if isinstance(output_size, int) else
                output_size[i] for i in range(nd))
    u = np.float32(0.5 if random_u is None else float(random_u))
    res = x
    for i, (dim_in, dim_out) in enumerate(zip(spatial, out)):
        alpha = np.float32(dim_in / dim_out)
        idx = np.floor(alpha * (np.arange(dim_out + 1, dtype=np.float32)
                                + u)).astype(np.int64)
        idx = np.clip(idx, 0, dim_in)
        idx[0], idx[-1] = 0, dim_in
        axis = x.ndim - nd + i
        segs = [res.narrow(axis, int(idx[j]),
                           max(int(idx[j + 1]), int(idx[j]) + 1)
                           - int(idx[j])).amax(dim=axis, keepdim=True)
                for j in range(dim_out)]
        res = torch.cat(segs, dim=axis)
    return res


@op("fractional_max_pool2d", differentiable=False)
def fractional_max_pool2d(x, output_size, random_u=None):
    return _fractional_pool(x, output_size, x.shape[-2:], random_u)


@op("fractional_max_pool3d", differentiable=False)
def fractional_max_pool3d(x, output_size, random_u=None):
    return _fractional_pool(x, output_size, x.shape[-3:], random_u)


def _unpool(x, indices, out_spatial):
    N, C = x.shape[:2]
    flat = torch.zeros((N, C, int(np.prod(out_spatial))), dtype=x.dtype,
                       device=x.device)
    flat.scatter_(2, indices.reshape(N, C, -1).long(), x.reshape(N, C, -1))
    return flat.reshape((N, C) + tuple(out_spatial))


def _unpool_size(x, kernel_size, stride, padding, output_size, nd):
    if output_size is not None:
        return tuple(output_size[-nd:])
    k = kernel_size if isinstance(kernel_size, int) else kernel_size[0]
    s = stride or k
    s = s if isinstance(s, int) else s[0]
    return tuple((d - 1) * s + k - 2 * padding for d in x.shape[-nd:])


@op("unpool", differentiable=False)
def max_unpool2d(x, indices, kernel_size=2, stride=None, padding=0,
                 output_size=None):
    """Scatter pooled values back to their argmax positions."""
    return _unpool(x, indices, _unpool_size(x, kernel_size, stride,
                                            padding, output_size, 2))


@op("unpool3d", differentiable=False)
def max_unpool3d(x, indices, kernel_size=2, stride=None, padding=0,
                 output_size=None):
    return _unpool(x, indices, _unpool_size(x, kernel_size, stride,
                                            padding, output_size, 3))


@op("box_clip", differentiable=False)
def box_clip(boxes, im_info):
    """Clip [N, 4] xyxy boxes to the image bounds."""
    h, w = im_info[0], im_info[1]
    x1 = torch.clamp(boxes[..., 0], torch.zeros_like(w), w - 1)
    y1 = torch.clamp(boxes[..., 1], torch.zeros_like(h), h - 1)
    x2 = torch.clamp(boxes[..., 2], torch.zeros_like(w), w - 1)
    y2 = torch.clamp(boxes[..., 3], torch.zeros_like(h), h - 1)
    return torch.stack([x1, y1, x2, y2], dim=-1)


@op("bipartite_match", differentiable=False)
def bipartite_match(dist):
    """Greedy bipartite matching on a [M, N] similarity matrix: the
    largest entry left pairs its row and column, min(M, N) rounds on the
    device. Returns (match_indices [N], match_dist [N])."""
    M, N = dist.shape
    d = dist.to(torch.float32).clone()
    midx = torch.full((N,), -1, dtype=torch.int32, device=d.device)
    mdst = torch.zeros((N,), dtype=torch.float32, device=d.device)
    cols = torch.arange(N, device=d.device)
    rows = torch.arange(M, device=d.device)
    for _ in range(min(M, N)):
        flat = torch.argmax(d)
        i, j = flat // N, flat % N
        best = d.reshape(-1)[flat]
        ok = best > 0
        hit = ok & (cols == j)
        midx = torch.where(hit, i.to(torch.int32), midx)
        mdst = torch.where(hit, best, mdst)
        wipe = ok & ((rows == i)[:, None] | (cols == j)[None, :])
        d = torch.where(wipe, torch.full_like(d, -1.0), d)
    return midx, mdst


@op("multiclass_nms3", differentiable=False)
def multiclass_nms3(bboxes, scores, score_threshold: float = 0.05,
                    nms_threshold: float = 0.45, keep_top_k: int = 100):
    """Per-class NMS over [N, 4] boxes and [C, N] scores, the top
    ``keep_top_k`` rows of (label, score, x1, y1, x2, y2) over all
    classes, -1 where fewer survive. The classes run their greedy
    loops together (vision/ops.py)."""
    from ..vision.ops import _nms_keep_mask

    C, N = scores.shape
    keep = _nms_keep_mask(bboxes, scores, nms_threshold)        # [C, N]
    s = torch.where(keep & (scores > score_threshold), scores,
                    torch.full_like(scores, -1.0))
    lab = torch.arange(C, dtype=torch.float32, device=scores.device) \
        [:, None].expand(C, N)
    allr = torch.cat([lab[..., None], s[..., None],
                      bboxes[None].expand(C, N, 4)], dim=-1).reshape(-1, 6)
    order = torch.argsort(-allr[:, 1], stable=True)[:keep_top_k]
    out = allr[order]
    return torch.where(out[:, 1:2] > 0, out, torch.full_like(out, -1.0))


@op("collect_fpn_proposals", differentiable=False)
def collect_fpn_proposals(multi_rois, multi_scores, post_nms_top_n: int):
    """Every level's proposals, the top ``post_nms_top_n`` by score."""
    rois = torch.cat(list(multi_rois), dim=0)
    scores = torch.cat(list(multi_scores), dim=0)
    k = min(post_nms_top_n, scores.shape[0])
    order = torch.argsort(-scores, stable=True)[:k]
    return rois[order], scores[order]


@op("correlation")
def correlation(x, y, max_displacement: int = 4, stride: int = 1):
    """Cost volume between two feature maps: one channel a displacement,
    the channel mean of x · shifted y."""
    d = max_displacement
    N, C, H, W = x.shape
    yp = F.pad(y, (d, d, d, d))
    outs = [(x * yp[:, :, dy:dy + H, dx:dx + W]).mean(dim=1)
            for dy in range(0, 2 * d + 1, stride)
            for dx in range(0, 2 * d + 1, stride)]
    return torch.stack(outs, dim=1)


# ---------------------------------------------------------------------------
# MoE auxiliaries
# ---------------------------------------------------------------------------

@op("number_count", differentiable=False)
def number_count(numbers, upper_range: int):
    """Histogram of expert ids in [0, upper_range); other ids count
    nowhere."""
    n = numbers.reshape(-1).long()
    valid = (n >= 0) & (n < upper_range)
    return torch.zeros(upper_range, dtype=torch.int64, device=n.device) \
        .scatter_add_(0, n.clamp(0, upper_range - 1), valid.long())


@op("assign_pos", differentiable=False)
def assign_pos(x, cum_count):
    """Token indices grouped by expert, in token order within each."""
    return torch.argsort(x.reshape(-1), stable=True).to(torch.int64)


@op("limit_by_capacity", differentiable=False)
def limit_by_capacity(expert_count, capacity, n_worker: int = 1):
    ec = expert_count.reshape(n_worker, -1) if n_worker > 1 \
        else expert_count
    return torch.minimum(ec, capacity).reshape(expert_count.shape)


@op("prune_gate_by_capacity", differentiable=False)
def prune_gate_by_capacity(gate_idx, expert_count, n_expert: int,
                           n_worker: int = 1):
    """Gate ids past their expert's capacity become -1."""
    flat = gate_idx.reshape(-1).long()
    valid = (flat >= 0) & (flat < n_expert)
    oh = F.one_hot(flat.clamp(0, n_expert - 1), n_expert) \
        * valid[:, None].long()
    pos_in_e = ((torch.cumsum(oh, dim=0) - 1) * oh).sum(-1)
    cap = expert_count.reshape(-1)[:n_expert][flat]
    out = torch.where(pos_in_e < cap, flat, torch.full_like(flat, -1))
    return out.to(gate_idx.dtype).reshape(gate_idx.shape)


@op("random_routing", differentiable=False)
def random_routing(prob, topk_value, topk_idx):
    """Random drop of routed experts: an entry stays where its uniform
    draw is under twice its gate value. ``prob`` holds the draws, one a
    token ([N]) or one an entry (topk_value's shape)."""
    r = prob.reshape(prob.shape + (1,) * (topk_value.ndim - prob.ndim))
    keep = r < (2.0 * topk_value)
    return torch.where(keep, topk_idx, torch.full_like(topk_idx, -1))


# ---------------------------------------------------------------------------
# misc math / creation / debug
# ---------------------------------------------------------------------------

@op("affine_channel")
def affine_channel(x, scale, bias, data_layout: str = "NCHW"):
    """Per-channel affine."""
    if data_layout == "NCHW":
        shape = (1, -1) + (1,) * (x.ndim - 2)
    else:
        shape = (1,) * (x.ndim - 1) + (-1,)
    return x * scale.reshape(shape) + bias.reshape(shape)


@op("add_position_encoding")
def add_position_encoding(x, alpha: float = 1.0, beta: float = 1.0):
    """Sinusoidal position encoding added to [B, T, H]."""
    B, T, H = x.shape
    pos = torch.arange(T, dtype=torch.float32, device=x.device)[:, None]
    i = torch.arange(H // 2, dtype=torch.float32, device=x.device)[None, :]
    angle = pos / torch.pow(torch.tensor(10000.0, device=x.device),
                            2 * i / H)
    pe = torch.cat([torch.sin(angle), torch.cos(angle)], dim=1)
    return alpha * x + beta * pe[None, :, :H].to(x.dtype)


@op("fill_diagonal_tensor")
def fill_diagonal_tensor(x, y, offset: int = 0, dim1: int = 0,
                         dim2: int = 1):
    """Write y along a diagonal of x."""
    xt = x.movedim((dim1, dim2), (0, 1))
    r0, c0 = max(0, -offset), max(0, offset)
    m = min(xt.shape[0] - r0, xt.shape[1] - c0)
    rows = r0 + torch.arange(m, device=x.device)
    cols = c0 + torch.arange(m, device=x.device)
    yv = y if isinstance(y, torch.Tensor) else torch.as_tensor(
        y, device=x.device)
    vals = yv.movedim(-1, 0)[:m] if yv.ndim else yv.expand(m)
    xt = xt.clone()
    xt[rows, cols] = vals.to(xt.dtype)
    return xt.movedim((0, 1), (dim1, dim2))


@op("edit_distance", differentiable=False)
def edit_distance(hyp, ref, normalized: bool = True):
    """Levenshtein distance between two id sequences, one DP row a step.
    Within a row, cur[j] = min(a[j], cur[j-1] + 1) is a running minimum:
    cur[j] = j + min(first + 1, min_{k<=j} (a[k] - k))."""
    h = hyp.reshape(-1)
    r = ref.reshape(-1)
    m, n = h.shape[0], r.shape[0]
    cols = torch.arange(n, dtype=torch.float32, device=h.device)
    prev = torch.arange(n + 1, dtype=torch.float32, device=h.device)
    for i in range(m):
        first = float(i + 1)
        if n:
            a = torch.minimum(prev[1:] + 1.0,
                              prev[:-1] + (h[i] != r).to(torch.float32))
            cm = torch.cummin(a - cols, dim=0).values
            cur = cols + torch.clamp_max(cm, first + 1.0)
            prev = torch.cat([prev.new_full((1,), first), cur])
        else:
            prev = prev.new_full((1,), first)
    d = prev[n]
    return d / max(n, 1) if normalized and n > 0 else d


@op("identity_loss")
def identity_loss(x, reduction: str = "mean"):
    if reduction in ("mean", 0):
        return x.mean()
    if reduction in ("sum", 1):
        return x.sum()
    return x


def kl_div(input, label, reduction: str = "mean",  # noqa: A002
           log_target: bool = False):
    """KL divergence loss; the one registration is
    nn/functional/loss.py's, as in the reference."""
    from ..nn.functional.loss import kl_div as _impl

    return _impl(input, label, reduction=reduction, log_target=log_target)


@op("huber_loss")
def huber_loss(input, label, delta: float = 1.0):  # noqa: A002
    d = input - label
    ad = torch.abs(d)
    return torch.where(ad <= delta, 0.5 * d * d, delta * (ad - 0.5 * delta))


@op("truncated_gaussian_random", differentiable=False)
def truncated_gaussian_random(shape, mean: float = 0.0, std: float = 1.0,
                              a: float = -2.0, b: float = 2.0):
    """Normal samples truncated to [a, b], by JAX's construction: a
    uniform between the bounds' erf values through erfinv, clamped
    inside the bounds, then scaled; the package's generator draws."""
    from ..core.device import current_device

    dev = current_device()
    gen = prandom.default_generator().torch_generator(dev)
    s2 = _math.sqrt(2.0)
    lo, hi = _math.erf(a / s2), _math.erf(b / s2)
    u = torch.rand(tuple(shape), device=dev, generator=gen) * (hi - lo) + lo
    z = s2 * torch.erfinv(u)
    lo_t = torch.nextafter(torch.tensor(a, dtype=torch.float32),
                           torch.tensor(_math.inf)).item()
    hi_t = torch.nextafter(torch.tensor(b, dtype=torch.float32),
                           torch.tensor(-_math.inf)).item()
    return torch.clamp(z, lo_t, hi_t) * std + mean


def read_file(path: str):
    """A file's bytes as a uint8 tensor on the current device."""
    from ..core.device import current_device

    with open(path, "rb") as f:
        data = np.frombuffer(f.read(), dtype=np.uint8).copy()
    return Tensor(torch.from_numpy(data).to(current_device()))


@op("check_numerics", differentiable=False)
def check_numerics(x, op_type: str = "", var_name: str = ""):
    """(stats [n_nan, n_inf, n_zero], values [max, min, mean] of the
    finite entries, the others counted as 0)."""
    xf = x.to(torch.float32)
    stats = torch.stack([torch.isnan(xf).sum(), torch.isinf(xf).sum(),
                         (xf == 0).sum()]).to(torch.int64)
    finite = torch.where(torch.isfinite(xf), xf, torch.zeros_like(xf))
    return stats, torch.stack([finite.max(), finite.min(), finite.mean()])


@op("accuracy_check", differentiable=False)
def accuracy_check(x, y, fn_name: str = "", rtol: float = 1e-5,
                   atol: float = 1e-8, equal_nan: bool = False):
    return torch.tensor(torch.allclose(x, y.to(x.dtype), rtol=rtol,
                                       atol=atol, equal_nan=equal_nan),
                        device=x.device)


@op("crf_decoding", differentiable=False)
def crf_decoding(emission, transition):
    """Viterbi decode with Paddle's CRF layout: transition[0] / [1] the
    start / stop scores, transition[2:] the [T, T] matrix. Returns the
    best path."""
    start, stop, trans = transition[0], transition[1], transition[2:]
    T = emission.shape[0]
    alpha = start + emission[0]
    bps = []
    for t in range(1, T):
        scores = alpha[:, None] + trans + emission[t][None, :]
        alpha, bp = scores.max(dim=0)
        bps.append(scores.argmax(dim=0))
    alpha = alpha + stop
    cur = alpha.argmax()
    path = [cur]
    for bp in reversed(bps):
        cur = bp[cur]
        path.append(cur)
    return torch.stack(path[::-1])


# ---------------------------------------------------------------------------
# attention packing wrappers
# ---------------------------------------------------------------------------

def _wrap_like(out, like):
    if isinstance(like, Tensor):
        return Tensor(out, stop_gradient=not out.requires_grad)
    return out


def flash_attn_qkvpacked(qkv, dropout: float = 0.0, causal: bool = False,
                         **kw):
    """qkv [B, S, 3, H, D] packed: ``flash_attention_raw`` on its three
    slices (K1-sep forward and K3-sep backward on the card)."""
    from .kernels.flash_attention import flash_attention_raw

    t = _data(qkv)
    out = flash_attention_raw(t[:, :, 0], t[:, :, 1], t[:, :, 2],
                              causal=causal)
    return _wrap_like(out, qkv)


def flash_attn_varlen_qkvpacked(qkv, cu_seqlens_q=None, cu_seqlens_k=None,
                                causal: bool = False, **kw):
    """qkv [total_tokens, 3, H, D] packed sequences:
    ``flash_attn_unpadded`` on its slices, at ``scale`` (default
    1/sqrt(D)); returns (out, None) as ``flash_attn_unpadded`` does."""
    from ..nn.functional.attention import flash_attn_unpadded

    t = qkv if isinstance(qkv, Tensor) else Tensor(as_torch(qkv))
    scale = kw.get("scale", 1.0 / _math.sqrt(t.shape[-1]))
    return flash_attn_unpadded(t[:, 0], t[:, 1], t[:, 2], cu_seqlens_q,
                               cu_seqlens_k, kw.get("max_seqlen_q"),
                               kw.get("max_seqlen_k"), scale, causal=causal)


def flashmask_attention(q, k, v, startend_row_indices=None,
                        causal: bool = False):
    """The sparse-mask attention variant as dense masked attention
    (``startend_row_indices`` unused, as in the reference)."""
    from ..incubate.nn.functional.fused_transformer import _sdpa_fallback

    qd = _data(q)
    scale = 1.0 / _math.sqrt(qd.shape[-1])
    return _wrap_like(_sdpa_fallback(qd, _data(k), _data(v), causal, scale),
                      q)
