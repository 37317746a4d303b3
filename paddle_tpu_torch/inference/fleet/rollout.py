"""Zero-downtime weight rollout primitives (the port's copy of
paddle_tpu/inference/fleet/rollout.py).

- :class:`WeightCatalog`: content-hashed parameter versions. Publishing
  the same bytes twice gives one version id, so "is engine X on version
  V" is a string compare, and A/B versions coexist as dict entries. The
  id is the reference's for the same bytes: sha1 fed the same way
  (sorted keys, ``[i]`` tags on tuple positions, then dtype name, shape
  and raw bytes of each leaf; a bf16 leaf hashes as ``bfloat16`` over
  its 16-bit patterns). The router stamps every request's
  ``param_version`` at placement, and an admitted stream only ever
  resumes on an engine of its version: KV pages are a function of
  (params, prefix), so pages of two versions never mix in a stream.
- :class:`RolloutState`: the router's in-flight rollout cursor (target,
  fallback version, the engine mid-episode). A rollback is a rollout to
  the prior version with canary failures ignored, so it always
  converges to one version.
- :func:`run_canary`: the post-swap health check, a lone greedy decode
  on the drained, freshly swapped engine.

The state machine lives in ``FleetRouter._rollout_tick``.
"""

from __future__ import annotations

import hashlib
import weakref
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..serving import Request

__all__ = ["WeightCatalog", "RolloutState", "run_canary"]

# 16-bit types numpy cannot name on a host without ml_dtypes: hashed
# through a same-width integer view, under the reference's dtype name
_VIEW_AS = {torch.bfloat16: torch.int16}


def _leaf_bytes(w) -> tuple[str, tuple, np.ndarray]:
    """(numpy dtype name, shape, contiguous host bytes) of one leaf,
    a tensor on any device or anything ``np.asarray`` takes."""
    if isinstance(w, torch.Tensor):
        t = w.detach()
        name = str(t.dtype).removeprefix("torch.")
        shape = tuple(t.shape)
        if t.dtype in _VIEW_AS:
            t = t.view(_VIEW_AS[t.dtype])
        a = t.contiguous().cpu().numpy()
    else:
        a = np.ascontiguousarray(np.asarray(w))
        name, shape = str(a.dtype), a.shape
    return name, shape, a.reshape(-1).view(np.uint8)


def _hash_leaves(h, tree) -> None:
    """Feed every leaf of a params tree into ``h`` deterministically:
    dict keys sorted, tuple/list positions tagged, each leaf tagged with
    dtype and shape before its bytes (int8 ``(weights, scales)`` tuples:
    both legs join the digest)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            h.update(repr(k).encode())
            _hash_leaves(h, tree[k])
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            h.update(b"[%d]" % i)
            _hash_leaves(h, v)
    else:
        name, shape, raw = _leaf_bytes(tree)
        h.update(name.encode() + repr(shape).encode())
        h.update(raw)


def _leaf_marks(tree, path=(), out=None) -> Optional[list]:
    """(path, weak reference, in-place version counter) of every leaf, or
    None when a leaf is not a tensor (nothing tells whether it changed)."""
    out = [] if out is None else out
    if isinstance(tree, dict):
        for k in sorted(tree):
            if _leaf_marks(tree[k], path + (repr(k),), out) is None:
                return None
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            if _leaf_marks(v, path + (i,), out) is None:
                return None
    elif isinstance(tree, torch.Tensor):
        out.append((path, weakref.ref(tree), tree._version))
    else:
        return None
    return out


def _unchanged(marks, now) -> bool:
    return now is not None and len(marks) == len(now) and all(
        p == q and r() is not None and r() is s() and v == w
        for (p, r, v), (q, s, w) in zip(marks, now))


class WeightCatalog:
    """Content-hashed parameter versions: ``put`` digests every leaf and
    returns the version id, identical bytes dedupe to one entry, and
    A/B versions coexist."""

    def __init__(self):
        self._params: dict[str, object] = {}
        # id(tree) -> (leaf marks, version): a tree put again with the
        # same tensor objects, none written in place since (torch counts
        # in-place writes in ``_version``), has the same bytes
        self._memo: dict[int, tuple[list, str]] = {}

    def put(self, params) -> str:
        """Publish a params tree; returns its content-hash version id
        (re-publishing the same bytes is a no-op). Leaves on the card
        are copied to the host one at a time to be hashed; a tree of
        tensors put before, whose leaves are the same objects and none
        written since, is not hashed again."""
        marks = _leaf_marks(params)
        hit = self._memo.get(id(params))
        if hit is not None and _unchanged(hit[0], marks):
            return hit[1]
        h = hashlib.sha1(b"pt-weights")
        _hash_leaves(h, params)
        version = h.hexdigest()[:12]
        self._params.setdefault(version, params)
        if marks is not None:
            self._memo[id(params)] = (marks, version)
        return version

    def get(self, version: str):
        return self._params[version]

    def __contains__(self, version) -> bool:
        return version in self._params

    def versions(self) -> list[str]:
        return sorted(self._params)


@dataclass
class RolloutState:
    """The router's in-flight rollout cursor (one engine at a time)."""

    target: str                        # version every engine should reach
    prior: str                         # rollback destination
    is_rollback: bool = False          # canary failures ignored: converge
    t0: float = 0.0                    # monotonic at rollout start
    current_eid: Optional[int] = None  # engine mid-episode, None = pick next
    episode_t0: float = 0.0            # monotonic at current drain start


def run_canary(engine, n_tokens: int, now: float = 0.0) -> bool:
    """Post-swap health check: a lone greedy decode of ``n_tokens`` on
    the drained engine, through the normal submit / step path (the
    program a real request runs). The prompt spans less than a page, so
    nothing lands in the prefix cache. True iff the decode produced
    every token without aborting."""
    if n_tokens <= 0:
        return True
    vocab = int(engine.cfg.vocab_size)
    prompt = np.arange(1, 1 + min(8, max(1, vocab - 1)),
                       dtype=np.int32) % vocab
    req = Request(rid=-(1 << 30) - engine.engine_id, prompt=prompt,
                  max_new_tokens=int(n_tokens))
    was_prefill_only = engine.prefill_only
    engine.prefill_only = False        # a canary must DECODE, not export
    try:
        engine.submit(req)
        for _ in range(64 + 16 * int(n_tokens)):
            if not engine.step(now=now):
                break
    finally:
        engine.prefill_only = was_prefill_only
        if len(req.out_tokens) < n_tokens and not req.aborted:
            engine.abort(req.rid)      # never leave a stuck canary resident
    return not req.aborted and len(req.out_tokens) >= n_tokens
