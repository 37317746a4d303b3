"""Remaining nn layer surface: padding/pooling/loss/decoding extras (port
of paddle_tpu/nn/layer/extra.py).

The random layers (FeatureAlphaDropout, FractionalMaxPool*'s default
``random_u``) draw from the port's generator (core/random.py): the
reference's distributions, other bits. Reference files: python/paddle/nn/layer/{common.py (Unflatten, ZeroPad*),
activation.py (Softmax2D), distance.py (PairwiseDistance), loss.py
(MultiMarginLoss, HSigmoidLoss, RNNTLoss, AdaptiveLogSoftmaxWithLoss),
pooling.py (LPPool*, MaxUnPool*, FractionalMaxPool*), rnn.py
(RNNCellBase), and nn/decode.py (BeamSearchDecoder, dynamic_decode).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...core import random as prandom
from ...core.dispatch import op
from ...core.tensor import Tensor
from .. import functional as F
from .layers import Layer
from .rnn import _CellBase as RNNCellBase

__all__ = [
    "Softmax2D", "Unflatten", "ZeroPad1D", "ZeroPad3D", "PairwiseDistance",
    "MultiMarginLoss", "HSigmoidLoss", "FeatureAlphaDropout",
    "LPPool1D", "LPPool2D", "MaxUnPool1D", "MaxUnPool2D", "MaxUnPool3D",
    "FractionalMaxPool2D", "FractionalMaxPool3D",
    "AdaptiveLogSoftmaxWithLoss", "RNNTLoss", "RNNCellBase",
    "BeamSearchDecoder", "dynamic_decode",
]


class Softmax2D(Layer):
    """Softmax over the channel dim of NCHW input (reference
    activation.py Softmax2D)."""

    def forward(self, x):
        if x.ndim not in (3, 4):
            raise ValueError(f"Softmax2D expects 3D/4D input, got {x.ndim}D")
        return F.softmax(x, axis=-3)


class Unflatten(Layer):
    """reference common.py Unflatten: expand dim ``axis`` into ``shape``."""

    def __init__(self, axis, shape, name=None):
        super().__init__()
        self.axis = axis
        self.shape = list(shape)

    def forward(self, x):
        cur = list(x.shape)
        ax = self.axis % len(cur)
        new = cur[:ax] + list(self.shape) + cur[ax + 1:]
        return x.reshape(new)

    def extra_repr(self):
        return f"axis={self.axis}, shape={self.shape}"


class _ZeroPadND(Layer):
    def __init__(self, padding, n_spatial, data_format):
        super().__init__()
        if isinstance(padding, int):
            padding = [padding, padding] * n_spatial
        self._padding = list(padding)
        self._fmt = data_format

    def forward(self, x):
        return F.pad(x, self._padding, mode="constant", value=0.0,
                     data_format=self._fmt)

    def extra_repr(self):
        return f"padding={self._padding}, data_format={self._fmt}"


class ZeroPad1D(_ZeroPadND):
    def __init__(self, padding, data_format="NCL", name=None):
        super().__init__(padding, 1, data_format)


class ZeroPad3D(_ZeroPadND):
    def __init__(self, padding, data_format="NCDHW", name=None):
        super().__init__(padding, 3, data_format)


class PairwiseDistance(Layer):
    """reference distance.py: p-norm of x - y along the last dim."""

    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p = p
        self.epsilon = epsilon
        self.keepdim = keepdim

    def forward(self, x, y):
        @op("pairwise_distance")
        def _impl(x, y):
            d = x - y + self.epsilon
            return torch.sum(torch.abs(d) ** self.p, dim=-1,
                             keepdim=self.keepdim) ** (1.0 / self.p)

        return _impl(x, y)


@op("multi_margin_loss", amp="keep_fp32")
def _multi_margin_loss(input, label, weight, *, p, margin, reduction):
    x = input.float()
    N, C = x.shape
    lab = label.reshape(-1).long()
    gold = torch.take_along_dim(x, lab[:, None], dim=1)
    viol = torch.clamp_min(margin - gold + x, 0.0) ** p
    mask = 1.0 - torch.nn.functional.one_hot(lab, C).to(x.dtype)
    if weight is not None:
        # reference weights each sample's terms by weight[label]
        mask = mask * weight.reshape(-1)[lab][:, None]
    loss = (viol * mask).sum(-1) / C
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


class MultiMarginLoss(Layer):
    """reference loss.py MultiMarginLoss (hinge on the gold-vs-other
    logit margins)."""

    def __init__(self, p: int = 1, margin: float = 1.0, weight=None,
                 reduction: str = "mean", name=None):
        super().__init__()
        self.p = p
        self.margin = margin
        self.weight = weight
        self.reduction = reduction

    def forward(self, input, label):
        return _multi_margin_loss(input, label, self.weight, p=self.p,
                                  margin=self.margin,
                                  reduction=self.reduction)


class HSigmoidLoss(Layer):
    """reference loss.py HSigmoidLoss over functional hsigmoid_loss."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None):
        super().__init__()
        from .. import initializer as I

        self.num_classes = num_classes
        n_nodes = num_classes - 1 if not is_custom else num_classes
        std = 1.0 / math.sqrt(feature_size)
        self.weight = self.create_parameter(
            [max(n_nodes, 1), feature_size], attr=weight_attr,
            default_initializer=I.Uniform(-std, std))
        self.bias = None if bias_attr is False else self.create_parameter(
            [max(n_nodes, 1)], attr=bias_attr, is_bias=True)

    def forward(self, input, label, path_table=None, path_code=None):
        return F.hsigmoid_loss(input, label, self.num_classes, self.weight,
                               self.bias, path_table=path_table,
                               path_code=path_code)


class FeatureAlphaDropout(Layer):
    """reference common.py FeatureAlphaDropout: alpha dropout over whole
    channels (SELU-preserving statistics)."""

    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        gen = prandom.default_generator().torch_generator(x._data.device)

        @op("feature_alpha_dropout")
        def _impl(xx):
            alpha = 1.6732632423543772
            scale = 1.0507009873554805
            alpha_p = -alpha * scale
            keep = 1.0 - self.p
            shp = tuple(xx.shape)
            mask_shape = shp[:2] + (1,) * (len(shp) - 2)
            a = (keep + alpha_p ** 2 * keep * (1 - keep)) ** -0.5
            b = -a * alpha_p * (1 - keep)
            mask = torch.rand(mask_shape, generator=gen,
                              device=xx.device) < keep
            return (a * torch.where(mask, xx, alpha_p) + b).to(xx.dtype)

        return _impl(x)


class _LPPoolND(Layer):
    def __init__(self, norm_type, kernel_size, stride, padding, ceil_mode,
                 nd, data_format):
        super().__init__()
        self.p = float(norm_type)
        self.kernel_size = kernel_size
        self.stride = stride if stride is not None else kernel_size
        self.padding = padding
        self.ceil_mode = ceil_mode
        self.nd = nd
        self.fmt = data_format

    def forward(self, x):
        p = self.p

        @op("lp_pool")
        def _impl(x):
            ap = F.avg_pool1d if self.nd == 1 else F.avg_pool2d
            # (sum |x|^p)^(1/p) = (avg * count)^(1/p)
            powed = torch.abs(x) ** p
            # exclusive=False: avg includes zero padding, so avg * count
            # equals the window sum even at padded borders (a nested op
            # call: torch tensors in and out)
            avg = ap(powed, self.kernel_size, self.stride, self.padding,
                     ceil_mode=self.ceil_mode, exclusive=False)
            ks = self.kernel_size
            count = ks if isinstance(ks, int) else int(np.prod(ks))
            if self.nd == 2 and isinstance(ks, int):
                count = ks * ks
            return (avg * count) ** (1.0 / p)

        return _impl(x)


class LPPool1D(_LPPoolND):
    """reference pooling.py LPPool1D: p-norm pooling."""

    def __init__(self, norm_type, kernel_size, stride=None, padding=0,
                 ceil_mode=False, data_format="NCL", name=None):
        super().__init__(norm_type, kernel_size, stride, padding, ceil_mode,
                         1, data_format)


class LPPool2D(_LPPoolND):
    def __init__(self, norm_type, kernel_size, stride=None, padding=0,
                 ceil_mode=False, data_format="NCHW", name=None):
        super().__init__(norm_type, kernel_size, stride, padding, ceil_mode,
                         2, data_format)


def _unpool(x, indices, spatial_out, nd):
    @op("max_unpool")
    def _impl(x, indices):
        lead = tuple(x.shape[:2])
        n_spatial_in = int(np.prod(x.shape[2:]))
        n_out = int(np.prod(spatial_out))
        flat_x = x.reshape(lead + (n_spatial_in,))
        flat_i = indices.reshape(lead + (n_spatial_in,)).long()
        out = torch.zeros(lead + (n_out,), dtype=x.dtype, device=x.device)
        out = out.scatter(2, flat_i, flat_x)
        return out.reshape(lead + tuple(spatial_out))

    return _impl(x, indices)


class _MaxUnPoolND(Layer):
    def __init__(self, kernel_size, stride, padding, nd, data_format):
        super().__init__()
        ks = (kernel_size,) * nd if isinstance(kernel_size, int) else \
            tuple(kernel_size)
        st = ks if stride is None else (
            (stride,) * nd if isinstance(stride, int) else tuple(stride))
        pd = (padding,) * nd if isinstance(padding, int) else tuple(padding)
        self.ks, self.st, self.pd = ks, st, pd
        self.nd = nd

    def _out_spatial(self, in_spatial, output_size):
        if output_size is not None:
            out = list(output_size)
            return out[-self.nd:]
        return [(n - 1) * s - 2 * p + k for n, s, p, k in
                zip(in_spatial, self.st, self.pd, self.ks)]

    def forward(self, x, indices, output_size=None):
        spatial = self._out_spatial(list(x.shape[2:]), output_size)
        return _unpool(x, indices, spatial, self.nd)


class MaxUnPool1D(_MaxUnPoolND):
    """reference pooling.py MaxUnPool1D: scatter pooled values back to
    their argmax positions."""

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
        super().__init__(kernel_size, stride, padding, 1, data_format)
        self._output_size = output_size

    def forward(self, x, indices, output_size=None):
        return super().forward(x, indices,
                               output_size or self._output_size)


class MaxUnPool2D(_MaxUnPoolND):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
        super().__init__(kernel_size, stride, padding, 2, data_format)
        self._output_size = output_size

    def forward(self, x, indices, output_size=None):
        return super().forward(x, indices,
                               output_size or self._output_size)


class MaxUnPool3D(_MaxUnPoolND):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
        super().__init__(kernel_size, stride, padding, 3, data_format)
        self._output_size = output_size

    def forward(self, x, indices, output_size=None):
        return super().forward(x, indices,
                               output_size or self._output_size)


class _FractionalMaxPoolND(Layer):
    """Pseudo-random pooling regions (Graham 2014; reference
    fractional_max_pool2d/3d kernels). Region boundaries come from the
    random_u sequence (or a fixed one for determinism)."""

    def __init__(self, output_size, kernel_size=None, random_u=None,
                 nd=2, name=None):
        super().__init__()
        self.output_size = (output_size,) * nd if isinstance(
            output_size, int) else tuple(output_size)
        self.random_u = random_u
        self.nd = nd

    def _edges(self, n_in, n_out, u):
        # pseudo-random increment sequence: alpha = n_in/n_out,
        # edge_i = ceil(alpha * (i + u)) (Graham's pseudorandom variant);
        # monotone repair keeps every segment non-empty even when a large
        # u saturates the ceil at n_in before the last bin
        alpha = n_in / n_out
        idx = np.arange(n_out + 1, dtype=np.float64)
        edges = np.ceil(alpha * (idx + u)).astype(np.int64)
        edges[0] = 0
        edges[-1] = n_in
        edges = np.clip(edges, 0, n_in)
        for i in range(1, n_out):                 # forward: strictly grow
            edges[i] = max(edges[i], edges[i - 1] + 1)
        for i in range(n_out - 1, 0, -1):         # backward: leave room
            edges[i] = min(edges[i], edges[i + 1] - 1)
        return edges

    def forward(self, x):
        u = self.random_u
        if u is None:
            gen = prandom.default_generator().torch_generator(
                x._data.device)
            u = float(torch.rand((), generator=gen, device=x._data.device))
        spatial_in = list(x.shape[-self.nd:])
        all_edges = [self._edges(n, o, u) for n, o in
                     zip(spatial_in, self.output_size)]

        @op("fractional_max_pool")
        def _impl(x):
            out = x
            # reduce one spatial axis at a time with segment maxima
            for d, edges in enumerate(all_edges):
                axis = out.dim() - self.nd + d
                pieces = []
                for i in range(len(edges) - 1):
                    lo, hi = int(edges[i]), int(edges[i + 1])
                    hi = max(hi, lo + 1)
                    seg = out.narrow(axis, lo, min(hi, out.shape[axis]) - lo)
                    pieces.append(seg.amax(dim=axis, keepdim=True))
                out = torch.cat(pieces, dim=axis)
            return out

        return _impl(x)


class FractionalMaxPool2D(_FractionalMaxPoolND):
    def __init__(self, output_size, kernel_size=None, random_u=None,
                 return_mask=False, name=None):
        super().__init__(output_size, kernel_size, random_u, nd=2)


class FractionalMaxPool3D(_FractionalMaxPoolND):
    def __init__(self, output_size, kernel_size=None, random_u=None,
                 return_mask=False, name=None):
        super().__init__(output_size, kernel_size, random_u, nd=3)


class AdaptiveLogSoftmaxWithLoss(Layer):
    """reference loss.py AdaptiveLogSoftmaxWithLoss (Grave et al.):
    frequent classes in the head, rare classes in down-projected tail
    clusters. Returns (per-sample log-prob of the target, mean nll)."""

    def __init__(self, in_features, n_classes, cutoffs, div_value=4.0,
                 head_bias=False, weight_attr=None, bias_attr=None,
                 name=None):
        super().__init__()
        from .. import initializer as I

        cutoffs = list(cutoffs)
        if any(c <= 0 or c >= n_classes for c in cutoffs) or \
                sorted(set(cutoffs)) != cutoffs:
            raise ValueError("cutoffs must be increasing, in (0, n_classes)")
        self.in_features = in_features
        self.n_classes = n_classes
        self.cutoffs = cutoffs + [n_classes]
        self.div_value = div_value
        self.n_clusters = len(self.cutoffs) - 1
        self.head_size = self.cutoffs[0] + self.n_clusters
        self.head_weight = self.create_parameter(
            [in_features, self.head_size], attr=weight_attr,
            default_initializer=I.XavierUniform())
        self.head_bias = self.create_parameter(
            [self.head_size], is_bias=True) if head_bias else None
        self.tail_weights = []
        for i in range(self.n_clusters):
            hsz = max(1, int(in_features // (div_value ** (i + 1))))
            osz = self.cutoffs[i + 1] - self.cutoffs[i]
            w1 = self.create_parameter(
                [in_features, hsz], default_initializer=I.XavierUniform())
            w2 = self.create_parameter(
                [hsz, osz], default_initializer=I.XavierUniform())
            self.add_parameter(f"tail_{i}_proj", w1)
            self.add_parameter(f"tail_{i}_out", w2)
            self.tail_weights.append((w1, w2))

    def forward(self, input, label):
        head = F.linear(input, self.head_weight, self.head_bias)
        head_lsm = F.log_softmax(head, axis=-1)

        @op("adaptive_lsm_gather", amp="keep_fp32")
        def _gather(head_lsm, label, *tails):
            lab = label.reshape(-1).long()
            zero = torch.zeros((), dtype=head_lsm.dtype,
                               device=head_lsm.device)
            # in-head targets
            out = torch.where(
                lab < self.cutoffs[0],
                torch.take_along_dim(
                    head_lsm, torch.clamp(lab, 0, self.cutoffs[0] - 1)
                    [:, None], dim=1)[:, 0],
                zero)
            for i in range(self.n_clusters):
                lo, hi = self.cutoffs[i], self.cutoffs[i + 1]
                in_cluster = (lab >= lo) & (lab < hi)
                cluster_lp = head_lsm[:, self.cutoffs[0] + i]
                tail_lsm = tails[i]
                rel = torch.clamp(lab - lo, 0, hi - lo - 1)
                lp = cluster_lp + torch.take_along_dim(
                    tail_lsm, rel[:, None], dim=1)[:, 0]
                out = torch.where(in_cluster, lp, out)
            return out

        tails = []
        for w1, w2 in self.tail_weights:
            h = F.linear(F.linear(input, w1), w2)
            tails.append(F.log_softmax(h, axis=-1))
        lp = _gather(head_lsm, label, *tails)
        loss = -lp.mean()
        return lp, loss

    def log_prob(self, input):
        """Full [N, n_classes] log distribution."""
        from ...ops.manipulation import concat

        head_lsm = F.log_softmax(
            F.linear(input, self.head_weight, self.head_bias), axis=-1)
        parts = [head_lsm[:, :self.cutoffs[0]]]
        for i, (w1, w2) in enumerate(self.tail_weights):
            tail_lsm = F.log_softmax(F.linear(F.linear(input, w1), w2),
                                     axis=-1)
            cluster_lp = head_lsm[:, self.cutoffs[0] + i:self.cutoffs[0]
                                  + i + 1]
            parts.append(cluster_lp + tail_lsm)
        return concat(parts, axis=-1)

    def predict(self, input):
        return self.log_prob(input).argmax(axis=-1)


class RNNTLoss(Layer):
    """reference loss.py RNNTLoss over functional rnnt_loss."""

    def __init__(self, blank=0, fastemit_lambda=0.001, reduction="mean",
                 name=None):
        super().__init__()
        self.blank = blank
        self.fastemit_lambda = fastemit_lambda
        self.reduction = reduction

    def forward(self, logits, labels, logit_lengths, label_lengths):
        return F.rnnt_loss(logits, labels, logit_lengths, label_lengths,
                           blank=self.blank,
                           fastemit_lambda=self.fastemit_lambda,
                           reduction=self.reduction)


class BeamSearchDecoder:
    """reference nn/decode.py BeamSearchDecoder: beam search over an RNN
    cell + embedding fn + output layer. Host-driven loop (eager), used
    through :func:`dynamic_decode`."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    def _logits(self, token_ids, states):
        from ...ops.creation import to_tensor

        inp = to_tensor(token_ids)
        if self.embedding_fn is not None:
            inp = self.embedding_fn(inp)
        out, new_states = self.cell(inp, states)
        if self.output_fn is not None:
            out = self.output_fn(out)
        return out, new_states


def _tree_map(fn, *trees):
    """``fn`` over the leaves of same-shaped tuples / lists / dicts."""
    t0 = trees[0]
    if isinstance(t0, (tuple, list)):
        return type(t0)(_tree_map(fn, *kids) for kids in zip(*trees))
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *[t[k] for t in trees]) for k in t0}
    return fn(*trees)


def _reindex_states(all_states, src_beam, B):
    """Per-sample beam-state gather: beam k of sample b continues from
    sample b's row of state all_states[src_beam[b, k]]. State leaves are
    batched arrays (leading dim B), so each new beam state mixes rows
    from the parent beams' states."""
    beam = src_beam.shape[1]
    out = []
    for k in range(beam):
        parents = src_beam[:, k]                     # [B] parent beam ids
        if all(int(p) == int(parents[0]) for p in parents):
            out.append(all_states[int(parents[0])])
            continue

        def mix(*leaves):
            arrs = [leaf._data if isinstance(leaf, Tensor) else
                    torch.as_tensor(np.asarray(leaf)) for leaf in leaves]
            rows = torch.as_tensor(np.asarray(parents), device=arrs[0].device)
            mixed = torch.stack(arrs)[rows, torch.arange(
                B, device=arrs[0].device)]
            return Tensor(mixed) if isinstance(leaves[0], Tensor) else \
                mixed.cpu().numpy()

        out.append(_tree_map(mix, *[all_states[j] for j in range(beam)]))
    return out


def dynamic_decode(decoder, inits=None, max_step_num=32, batch_size=1,
                   **kwargs):
    """reference nn/decode.py dynamic_decode: run beam search until all
    beams emit the end token or ``max_step_num``. Returns (ids [B, beam,
    T], scores [B, beam])."""
    from ...ops.creation import to_tensor

    beam = decoder.beam_size
    B = batch_size
    tokens = np.full((B, 1), decoder.start_token, np.int64)
    # first step: expand to beams
    logits, states = decoder._logits(tokens, inits)
    logp = np.asarray(F.log_softmax(logits, axis=-1).numpy()).reshape(B, -1)
    V = logp.shape[-1]
    top = np.argsort(-logp, axis=-1)[:, :beam]                 # [B, beam]
    scores = np.take_along_axis(logp, top, axis=-1)            # [B, beam]
    seqs = top[:, :, None]                                     # [B, beam, 1]
    beam_states = [states] * beam
    finished = top == decoder.end_token
    for _ in range(max_step_num - 1):
        if finished.all():
            break
        all_scores = []
        all_states = []
        for k in range(beam):
            logits, st = decoder._logits(seqs[:, k, -1:].astype(np.int64),
                                         beam_states[k])
            lp = np.asarray(F.log_softmax(logits, axis=-1).numpy()) \
                .reshape(B, V)
            # finished beams only extend with end_token at zero cost
            lp_fin = np.full_like(lp, -1e9)
            lp_fin[:, decoder.end_token] = 0.0
            lp = np.where(finished[:, k:k + 1], lp_fin, lp)
            all_scores.append(scores[:, k:k + 1] + lp)
            all_states.append(st)
        flat = np.concatenate(all_scores, axis=1)              # [B, beam*V]
        top = np.argsort(-flat, axis=-1)[:, :beam]
        scores = np.take_along_axis(flat, top, axis=-1)
        src_beam = top // V
        tok = top % V
        seqs = np.concatenate([
            np.take_along_axis(seqs, src_beam[:, :, None], axis=1),
            tok[:, :, None]], axis=2)
        beam_states = _reindex_states(all_states, src_beam, B)
        finished = np.take_along_axis(finished, src_beam, axis=1) | \
            (tok == decoder.end_token)
    return to_tensor(seqs), to_tensor(scores.astype(np.float32))
