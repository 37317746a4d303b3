"""Loss functionals (port of paddle_tpu/nn/functional/loss.py).

``cross_entropy`` is one torch expression (log-softmax in fp32, the
label's log-probability gathered, ignored labels masked), as the
reference's; no kernel of the port computes it. ``ctc_loss`` and
``rnnt_loss`` run the reference's dynamic programs (the CTC alpha
recursion over time; the transducer's (T, U) lattice) as loops of torch
ops.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from ...core.dispatch import op
from .activation import _zero, softmax
from .input import one_hot

__all__ = [
    "cross_entropy", "softmax_with_cross_entropy", "binary_cross_entropy",
    "binary_cross_entropy_with_logits", "mse_loss", "l1_loss",
    "smooth_l1_loss", "nll_loss", "kl_div", "log_loss",
    "margin_ranking_loss", "cosine_embedding_loss", "square_error_cost",
    "sigmoid_focal_loss", "hinge_embedding_loss", "triplet_margin_loss",
    "triplet_margin_with_distance_loss", "soft_margin_loss",
    "multi_label_soft_margin_loss", "poisson_nll_loss", "gaussian_nll_loss",
    "dice_loss", "npair_loss", "ctc_loss", "rnnt_loss",
    "margin_cross_entropy", "hsigmoid_loss",
]


def _reduce(loss, reduction):
    if reduction == "mean":
        return torch.mean(loss)
    if reduction == "sum":
        return torch.sum(loss)
    return loss


def _norm(x, dim):
    return torch.sqrt(torch.sum(x * x, dim=dim))


@op("cross_entropy", amp="keep_fp32")
def cross_entropy(
    input,  # noqa: A002
    label,
    weight=None,
    ignore_index: int = -100,
    reduction: str = "mean",
    soft_label: bool = False,
    axis: int = -1,
    use_softmax: bool = True,
    label_smoothing: float = 0.0,
):
    logits = input.float()
    if use_softmax:
        log_probs = torch.log_softmax(logits, dim=axis)
    else:
        log_probs = torch.log(torch.clamp(logits, 1e-15, 1.0))
    n_classes = log_probs.shape[axis]

    if soft_label or (label.dim() == log_probs.dim()
                      and label.shape == log_probs.shape):
        lbl = label.float()
        if label_smoothing > 0.0:
            lbl = (1.0 - label_smoothing) * lbl + label_smoothing / n_classes
        loss = -torch.sum(lbl * log_probs, dim=axis)
        if weight is not None:
            w = torch.sum(lbl * weight.float(), dim=axis)
            loss = loss * w
            if reduction == "mean":
                return torch.sum(loss) / torch.clamp_min(torch.sum(w), 1e-12)
        return _reduce(loss, reduction)

    lbl = label
    if lbl.dim() == log_probs.dim() and lbl.shape[axis] == 1:
        lbl = torch.squeeze(lbl, dim=axis)
    lbl = lbl.to(torch.int64)
    valid = lbl != ignore_index
    safe_lbl = torch.where(valid, lbl, torch.zeros_like(lbl))
    picked = torch.gather(log_probs, axis if axis >= 0 else log_probs.dim()
                          + axis, safe_lbl.unsqueeze(axis))
    loss = -torch.squeeze(picked, dim=axis)
    if label_smoothing > 0.0:
        smooth = -torch.mean(log_probs, dim=axis)
        loss = (1.0 - label_smoothing) * loss + label_smoothing * smooth
    if weight is not None:
        w = weight.float()[safe_lbl] * valid
        loss = loss * w
        if reduction == "mean":
            return torch.sum(loss) / torch.clamp_min(torch.sum(w), 1e-12)
        loss = torch.where(valid, loss, _zero(loss))
        return _reduce(loss, reduction)
    loss = torch.where(valid, loss, _zero(loss))
    if reduction == "mean":
        return torch.sum(loss) / torch.clamp_min(
            torch.sum(valid.float()), 1.0)
    return _reduce(loss, reduction)


def softmax_with_cross_entropy(
    logits, label, soft_label=False, ignore_index=-100,
    numeric_stable_mode=True, return_softmax=False, axis=-1,
):
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis)
    loss = loss.unsqueeze(axis) if loss.ndim < logits.ndim else loss
    if return_softmax:
        return loss, softmax(logits, axis=axis)
    return loss


@op("binary_cross_entropy", amp="keep_fp32")
def binary_cross_entropy(input, label, weight=None,  # noqa: A002
                         reduction="mean"):
    x = torch.clamp(input.float(), 1e-12, 1.0 - 1e-12)
    loss = -(label * torch.log(x) + (1.0 - label) * torch.log1p(-x))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


@op("binary_cross_entropy_with_logits", amp="keep_fp32")
def binary_cross_entropy_with_logits(
    logit, label, weight=None, reduction="mean", pos_weight=None
):
    x = logit.float()
    lbl = label.float()
    max_val = torch.clamp_min(-x, 0.0)
    soft = torch.log1p(torch.exp(-torch.abs(x)))
    if pos_weight is not None:
        log_w = (pos_weight - 1.0) * lbl + 1.0
        loss = (1.0 - lbl) * x + log_w * (soft + max_val)
    else:
        loss = (1.0 - lbl) * x + soft + max_val
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


@op("mse_loss")
def mse_loss(input, label, reduction="mean"):  # noqa: A002
    return _reduce(torch.square(input - label), reduction)


@op("l1_loss")
def l1_loss(input, label, reduction="mean"):  # noqa: A002
    return _reduce(torch.abs(input - label), reduction)


@op("smooth_l1_loss")
def smooth_l1_loss(input, label, reduction="mean", delta=1.0):  # noqa: A002
    diff = torch.abs(input - label)
    loss = torch.where(diff < delta, 0.5 * torch.square(diff) / delta,
                       diff - 0.5 * delta)
    return _reduce(loss, reduction)


@op("nll_loss", amp="keep_fp32")
def nll_loss(input, label, weight=None, ignore_index=-100,  # noqa: A002
             reduction="mean"):
    lbl = label.to(torch.int64)
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, torch.zeros_like(lbl))
    picked = torch.gather(input, 1, safe.unsqueeze(1))
    loss = -torch.squeeze(picked, dim=1)
    if weight is not None:
        w = weight[safe] * valid
        loss = loss * w
        if reduction == "mean":
            return torch.sum(loss) / torch.clamp_min(torch.sum(w), 1e-12)
        return _reduce(torch.where(valid, loss, _zero(loss)), reduction)
    loss = torch.where(valid, loss, _zero(loss))
    if reduction == "mean":
        return torch.sum(loss) / torch.clamp_min(
            torch.sum(valid.float()), 1.0)
    return _reduce(loss, reduction)


@op("kl_div")
def kl_div(input, label, reduction="mean", log_target=False):  # noqa: A002
    if log_target:
        loss = torch.exp(label) * (label - input)
    else:
        safe_label = torch.clamp_min(label, 1e-12)
        loss = label * (torch.log(safe_label) - input)
        loss = torch.where(label > 0, loss, _zero(loss))
    if reduction == "batchmean":
        return torch.sum(loss) / input.shape[0]
    return _reduce(loss, reduction)


@op("log_loss")
def log_loss(input, label, epsilon=1e-4):  # noqa: A002
    return (-label * torch.log(input + epsilon)
            - (1.0 - label) * torch.log(1.0 - input + epsilon))


@op("margin_ranking_loss")
def margin_ranking_loss(input, other, label, margin=0.0,  # noqa: A002
                        reduction="mean"):
    loss = torch.clamp_min(-label * (input - other) + margin, 0.0)
    return _reduce(loss, reduction)


@op("cosine_embedding_loss")
def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean"):
    dot = torch.sum(input1 * input2, dim=-1)
    cos = dot / torch.clamp_min(_norm(input1, -1) * _norm(input2, -1),
                                1e-12)
    loss = torch.where(label == 1, 1.0 - cos,
                       torch.clamp_min(cos - margin, 0.0))
    return _reduce(loss, reduction)


@op("square_error_cost")
def square_error_cost(input, label):  # noqa: A002
    return torch.square(input - label)


@op("sigmoid_focal_loss", amp="keep_fp32")
def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum"):
    x = logit.float()
    p = torch.sigmoid(x)
    ce = (torch.clamp_min(x, 0.0) - x * label
          + torch.log1p(torch.exp(-torch.abs(x))))
    p_t = p * label + (1.0 - p) * (1.0 - label)
    loss = ce * torch.pow(1.0 - p_t, gamma)
    if alpha >= 0:
        alpha_t = alpha * label + (1.0 - alpha) * (1.0 - label)
        loss = alpha_t * loss
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


@op("hinge_embedding_loss")
def hinge_embedding_loss(input, label, margin=1.0,  # noqa: A002
                         reduction="mean"):
    loss = torch.where(label == 1.0, input,
                       torch.clamp_min(margin - input, 0.0))
    return _reduce(loss, reduction)


@op("triplet_margin_loss")
def triplet_margin_loss(input, positive, negative, margin=1.0,  # noqa: A002
                        p=2.0, epsilon=1e-6, swap=False, reduction="mean"):
    def dist(a, b):
        return torch.pow(torch.sum(torch.pow(torch.abs(a - b) + epsilon, p),
                                   dim=-1), 1.0 / p)

    d_pos = dist(input, positive)
    d_neg = dist(input, negative)
    if swap:
        d_neg = torch.minimum(d_neg, dist(positive, negative))
    loss = torch.clamp_min(d_pos - d_neg + margin, 0.0)
    return _reduce(loss, reduction)


def triplet_margin_with_distance_loss(input, positive, negative,  # noqa: A002
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    if distance_function is None:
        return triplet_margin_loss(input, positive, negative, margin=margin,
                                   swap=swap, reduction=reduction)
    d_pos = distance_function(input, positive)
    d_neg = distance_function(input, negative)
    if swap:
        d_neg = d_neg.minimum(distance_function(positive, negative))
    loss = (d_pos - d_neg + margin).clip(0.0)
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


@op("soft_margin_loss")
def soft_margin_loss(input, label, reduction="mean"):  # noqa: A002
    return _reduce(torch.log1p(torch.exp(-label * input)), reduction)


@op("multi_label_soft_margin_loss")
def multi_label_soft_margin_loss(input, label, weight=None,  # noqa: A002
                                 reduction="mean"):
    loss = -(label * TF.logsigmoid(input)
             + (1.0 - label) * TF.logsigmoid(-input))
    loss = torch.mean(loss, dim=-1)
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


@op("poisson_nll_loss")
def poisson_nll_loss(input, label, log_input=True, full=False,  # noqa: A002
                     epsilon=1e-8, reduction="mean"):
    if log_input:
        loss = torch.exp(input) - label * input
    else:
        loss = input - label * torch.log(input + epsilon)
    if full:
        stirling = (label * torch.log(label + epsilon) - label
                    + 0.5 * torch.log(2.0 * math.pi * (label + epsilon)))
        loss = loss + torch.where(label > 1, stirling, _zero(stirling))
    return _reduce(loss, reduction)


@op("gaussian_nll_loss")
def gaussian_nll_loss(input, label, variance, full=False,  # noqa: A002
                      epsilon=1e-6, reduction="mean"):
    var = torch.clamp_min(variance, epsilon)
    loss = 0.5 * (torch.log(var) + torch.square(input - label) / var)
    if full:
        loss = loss + 0.5 * math.log(2.0 * math.pi)
    return _reduce(loss, reduction)


@op("dice_loss")
def dice_loss(input, label, epsilon=1e-5):  # noqa: A002
    lbl = torch.squeeze(label, dim=-1)
    # an op's impl calling another op's wrapper runs it raw
    onehot = one_hot(lbl, input.shape[-1]).to(input.dtype)
    dims = tuple(range(1, input.dim()))
    inse = torch.sum(input * onehot, dim=dims)
    denom = torch.sum(input, dim=dims) + torch.sum(onehot, dim=dims)
    return torch.mean(1.0 - 2.0 * inse / (denom + epsilon))


@op("npair_loss")
def npair_loss(anchor, positive, labels, l2_reg=0.002):
    reg = l2_reg * (torch.mean(torch.sum(torch.square(anchor), dim=1))
                    + torch.mean(torch.sum(torch.square(positive), dim=1))
                    ) * 0.25
    sim = torch.matmul(anchor, positive.t())
    lbl = labels.reshape(-1, 1)
    target = (lbl == lbl.t()).float()
    target = target / torch.sum(target, dim=1, keepdim=True)
    ce = torch.mean(torch.sum(-target * torch.log_softmax(sim, dim=1),
                              dim=1))
    return ce + reg


_NEG_INF = -1e30


@op("ctc_loss", amp="keep_fp32")
def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC by the alpha recursion over time. log_probs: [T, B, C]
    logits (log-softmax taken here, as the reference's); labels: [B, L]
    (padded)."""
    logp = torch.log_softmax(log_probs.float(), dim=-1)
    T, B, _ = logp.shape
    L = labels.shape[1]
    S = 2 * L + 1
    dev = logp.device
    labels = labels.to(torch.int64)
    # the extended sequence: blank l1 blank l2 ... blank
    ext = torch.full((B, S), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = labels
    ext_prev2 = torch.cat([torch.full((B, 2), -1, dtype=torch.int64,
                                      device=dev), ext[:, :-2]], dim=1)
    can_skip = (ext != blank) & (ext != ext_prev2)
    bidx = torch.arange(B, device=dev)
    neg = torch.full((B, 1), _NEG_INF, device=dev)
    first = [logp[0, bidx, ext[:, 0]][:, None]]
    if S > 1:
        first.append(logp[0, bidx, ext[:, 1]][:, None] if L > 0 else neg)
    if S > 2:
        first.append(torch.full((B, S - 2), _NEG_INF, device=dev))
    alpha = torch.cat(first, dim=1)
    alphas = [alpha]
    for t in range(1, T):
        a1 = torch.cat([neg, alpha[:, :-1]], dim=1)
        a2 = torch.cat([neg, neg, alpha[:, :-2]], dim=1)
        a2 = torch.where(can_skip, a2, torch.full_like(a2, _NEG_INF))
        merged = torch.logaddexp(torch.logaddexp(alpha, a1), a2)
        alpha = merged + torch.gather(logp[t], 1, ext)
        alphas.append(alpha)
    alphas = torch.stack(alphas, dim=0)  # [T, B, S]
    t_idx = torch.clamp(input_lengths.to(torch.int64) - 1, 0, T - 1)
    s_last = 2 * label_lengths.to(torch.int64)
    s_prev = torch.clamp(s_last - 1, 0, S - 1)
    ll = torch.logaddexp(alphas[t_idx, bidx, s_last],
                         alphas[t_idx, bidx, s_prev])
    loss = -ll
    if norm_by_times:
        loss = loss / torch.clamp_min(input_lengths.float(), 1.0)
    if reduction == "mean":
        return torch.mean(loss / torch.clamp_min(label_lengths.float(), 1.0))
    return _reduce(loss, reduction)


@op("rnnt_loss", amp="keep_fp32")
def rnnt_loss(logits, labels, logit_lengths, label_lengths, blank=0,
              fastemit_lambda=0.001, reduction="mean"):
    """RNN-Transducer loss by the forward algorithm over the (T, U)
    lattice. logits: [B, T, U+1, V]; labels: [B, U]; lengths a
    sample."""
    x = logits.float()
    B, T, U1, _ = x.shape
    lp = torch.log_softmax(x, dim=-1)
    dev = lp.device
    lab = labels.to(torch.int64)
    blank_lp = lp[..., blank]                                  # [B, T, U+1]
    lab_ids = torch.cat([lab, torch.zeros((B, 1), dtype=torch.int64,
                                          device=dev)], dim=1)
    emit_lp = torch.gather(lp, -1, lab_ids[:, None, :, None].expand(
        B, T, U1, 1))[..., 0]                                  # [B, T, U+1]
    if fastemit_lambda:
        # FastEmit: the label-emission gradient scaled by (1 + lambda),
        # the forward value unchanged
        emit_lp = ((1.0 + fastemit_lambda) * emit_lp
                   - fastemit_lambda * emit_lp.detach())
    alpha = torch.cat([torch.zeros((B, 1), device=dev),
                       torch.cumsum(emit_lp[:, 0, :-1], dim=-1)], dim=1)
    alphas = [alpha]
    for t in range(1, T):
        horiz = alpha + blank_lp[:, t - 1]
        emit_t = emit_lp[:, t]
        cols = [horiz[:, 0]]
        for u in range(1, U1):
            cols.append(torch.logaddexp(horiz[:, u],
                                        cols[-1] + emit_t[:, u - 1]))
        alpha = torch.stack(cols, dim=1)
        alphas.append(alpha)
    all_alphas = torch.stack(alphas, dim=1)                    # [B, T, U+1]
    tl = logit_lengths.to(torch.int64).reshape(-1)
    ul = label_lengths.to(torch.int64).reshape(-1)
    bidx = torch.arange(B, device=dev)
    nll = -(all_alphas[bidx, tl - 1, ul] + blank_lp[bidx, tl - 1, ul])
    if reduction == "mean":
        return nll.mean()
    if reduction == "sum":
        return nll.sum()
    return nll


@op("margin_cross_entropy", amp="keep_fp32")
def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean"):
    """The ArcFace / CosFace margin softmax cross-entropy: the target
    logit becomes cos(m1 theta + m2) - m3, then the scaled softmax CE."""
    x = logits.float()
    _, C = x.shape
    onehot = one_hot(label.reshape(-1), C)
    target = torch.sum(x * onehot, dim=-1)
    theta = torch.arccos(torch.clamp(target, -1.0, 1.0))
    target_m = torch.cos(margin1 * theta + margin2) - margin3
    adj = (x + onehot * (target_m - target)[:, None]) * scale
    lse = torch.logsumexp(adj, dim=-1)
    loss = lse - torch.sum(adj * onehot, dim=-1)
    if reduction == "mean":
        loss = loss.mean()
    elif reduction == "sum":
        loss = loss.sum()
    if return_softmax:
        return loss, torch.softmax(adj, dim=-1)
    return loss


@op("hsigmoid_loss", amp="keep_fp32")
def hsigmoid_loss(input, label, num_classes, weight, bias=None,  # noqa: A002
                  path_table=None, path_code=None, is_sparse=False):
    """Hierarchical sigmoid loss over the complete binary tree of
    ``num_classes`` leaves, or over ``path_table`` / ``path_code``."""
    x = input.float()
    if path_table is None:
        code_len = max(1, int(math.ceil(math.log2(max(num_classes, 2)))))
        lab = label.reshape(-1).to(torch.int64) + num_classes
        shifts = torch.arange(code_len, device=lab.device)
        nodes = (lab[:, None] >> (shifts + 1)) - 1              # [N, L]
        bits = (lab[:, None] >> shifts) & 1
    else:
        nodes, bits = path_table, path_code
    valid = nodes >= 0
    nodes = torch.clamp(nodes.to(torch.int64), 0, weight.shape[0] - 1)
    w = weight[nodes]                                           # [N, L, D]
    logit = torch.einsum("nld,nd->nl", w.float(), x)
    if bias is not None:
        logit = logit + bias.reshape(-1)[nodes]
    t = bits.float()
    bce = (torch.clamp_min(logit, 0) - logit * t
           + torch.log1p(torch.exp(-torch.abs(logit))))
    return torch.sum(torch.where(valid, bce, _zero(bce)), dim=-1,
                     keepdim=True)
