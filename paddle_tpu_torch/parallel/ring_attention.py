"""Ring attention: exact context parallelism for long sequences (port of
paddle_tpu/parallel/ring_attention.py).

The sequence is split over a mesh axis of ``cp`` ranks: each rank holds
the [B, S / cp, H, D] chunk of q, k and v that its coordinate selects.
Each step of the ring computes the local q chunk's block attention
against the k / v chunk the rank holds, merges it into the running
online-softmax state (m, l, acc) in fp32, and passes k and v one hop on
(``distributed.autograd_collectives.ppermute``, rank i to rank i + 1).
Under ``causal`` a hop whose k chunk lies wholly after the q chunk is
skipped. The full S x S score matrix never exists: a rank holds one
[B, H, S / cp, S / cp] score block at a time.

The backward (``_Ring``) is the ring again: each hop's block is
recomputed from q, the travelling k / v, the forward's log-sum-exp and
its fp32 output (the reference's ``jax.checkpoint(hop)``), dq
accumulates on the rank, and dk / dv travel with their k / v until one
last hop brings them home to the rank that owns the chunk. Both products
of a hop are fp32 matmuls of the widened operands, as the reference's
einsums with ``preferred_element_type=float32`` (the probabilities cast
to v's dtype first); they are not a kernel of the port, since the
reference computes them in XLA, outside any Pallas kernel.
"""

from __future__ import annotations

import math

import torch

from ..distributed.autograd_collectives import _send_recv

__all__ = ["ring_attention"]

_FILL = -1e30


def _scores(q, k, scale, mask):
    """fp32 scores [B, H, Sq, Sk] of q [B, Sq, H, D] against k."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        s = torch.where(mask, s, _FILL)
    return s


def _block_attn(q, k, v, scale, mask=None):
    """One (q chunk, kv chunk) pair: the partial state (m, l, acc) in
    fp32, m and l [B, H, Sq], acc [B, H, Sq, D]."""
    s = _scores(q, k, scale, mask)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    acc = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    return m, l, acc


def _merge(m1, l1, a1, m2, l2, a2):
    """Two online-softmax partial states as one."""
    m = torch.maximum(m1, m2)
    c1 = torch.exp(m1 - m)
    c2 = torch.exp(m2 - m)
    return m, l1 * c1 + l2 * c2, a1 * c1[..., None] + a2 * c2[..., None]


def _hop_mask(my: int, src: int, sq: int, sk: int, device):
    """The causal mask of q chunk ``my`` against k chunk ``src`` (None:
    every pair is allowed); the caller skips the hop when src > my."""
    if src < my:
        return None
    q_pos = my * sq + torch.arange(sq, device=device)
    k_pos = src * sk + torch.arange(sk, device=device)
    return (q_pos[:, None] >= k_pos[None, :])[None, None]


def _ring_perm(cp: int) -> list:
    return [(i, (i + 1) % cp) for i in range(cp)]


class _Ring(torch.autograd.Function):
    """The ring over ``group`` (cp ranks, this one ``my``)."""

    @staticmethod
    def forward(ctx, q, k, v, group, my, cp, causal, scale):
        B, Sq, H, D = q.shape
        m = torch.full((B, H, Sq), _FILL, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
        a = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=q.device)
        kc, vc = k, v
        for step in range(cp):
            src = (my - step) % cp
            if not causal or src <= my:
                mask = (_hop_mask(my, src, Sq, kc.shape[1], q.device)
                        if causal else None)
                m, l, a = _merge(m, l, a, *_block_attn(q, kc, vc, scale,
                                                       mask))
            if step < cp - 1:
                kc = _send_recv(kc, group, _ring_perm(cp))
                vc = _send_recv(vc, group, _ring_perm(cp))
        l = torch.clamp_min(l, 1e-30)
        out32 = (a / l[..., None]).permute(0, 2, 1, 3)
        ctx.save_for_backward(q, k, v, out32, m + torch.log(l))
        ctx.args = (group, my, cp, causal, scale)
        return out32.to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, out32, lse = ctx.saved_tensors
        group, my, cp, causal, scale = ctx.args
        Sq = q.shape[1]
        do32 = do.float()
        # rowsum(do * o) [B, H, Sq], the softmax's adjoint term, from the
        # fp32 output, as the reference's autodiff of a / l sees it: the
        # output rounded to bf16 would move it by 2^-9 of do . o, which
        # dp - delta then cancels against
        delta = (do32 * out32).sum(-1).permute(0, 2, 1)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        kc, vc = k, v
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for step in range(cp):
            src = (my - step) % cp
            if not causal or src <= my:
                mask = (_hop_mask(my, src, Sq, kc.shape[1], q.device)
                        if causal else None)
                p = torch.exp(_scores(q, kc, scale, mask) - lse[..., None])
                dv += torch.einsum("bhqk,bqhd->bkhd", p.to(v.dtype).float(),
                                   do32)
                dp = torch.einsum("bqhd,bkhd->bhqk", do32, vc.float())
                ds = p * (dp - delta[..., None]) * scale
                dq += torch.einsum("bhqk,bkhd->bqhd", ds, kc.float())
                dk += torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
                del p, dp, ds
            # dk / dv travel with their chunk; the last hop brings them
            # back to its owner
            if step < cp - 1:
                kc = _send_recv(kc, group, _ring_perm(cp))
                vc = _send_recv(vc, group, _ring_perm(cp))
            dk = _send_recv(dk, group, _ring_perm(cp))
            dv = _send_recv(dv, group, _ring_perm(cp))
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None)


def ring_attention(q, k, v, mesh, axis: str = "sep", causal: bool = True,
                   sm_scale=None):
    """Context-parallel exact attention over the ``axis`` ring of
    ``mesh`` (the port's ``Mesh``; ``HybridCommunicateGroup.mesh`` has
    the axis "sep"). q, k, v are this rank's [B, S / cp, H, D] chunks
    (the rank at coordinate i of the axis holds positions i S / cp ..);
    the output is this rank's chunk of the attention. Differentiable.
    With cp == 1 it is the plain block attention on the whole
    sequence."""
    cp = mesh.shape.get(axis, 1)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(
        q.shape[-1])
    if cp == 1:
        mask = None
        if causal:
            mask = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool,
                              device=q.device).tril()[None, None]
        m, l, a = _block_attn(q, k, v, scale, mask)
        return (a / torch.clamp_min(l, 1e-30)[..., None]).permute(
            0, 2, 1, 3).to(q.dtype)
    return _Ring.apply(q, k, v, mesh.group(axis), mesh.axis_index(axis), cp,
                       bool(causal), float(scale))
