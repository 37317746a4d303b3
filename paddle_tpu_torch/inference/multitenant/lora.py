"""Per-request LoRA adapter residency on the serving page pool (port of
paddle_tpu/inference/multitenant/lora.py).

Loading an adapter charges ``ceil(adapter_bytes / kv_page_bytes)`` page
ids out of the free list the KV cache allocates from, so adapter
residency and KV capacity trade off in one ledger (``page_accounting``'s
``adapter`` class). The lifecycle mirrors the prefix cache:

- content-hashed: residency is keyed by the sha1 of the weight bytes, so
  identical weights registered under two ids share one resident copy;
- refcounted: a request's admission increfs its adapter, slot teardown
  (finish, abort, preemption) decrefs; refcount-0 adapters stay resident
  in an idle LRU;
- evicted under pressure: when allocation would fail, or every device
  slot is taken, idle adapters are evicted LRU first and their pages go
  back to the free list. Adapter pages never enter a block table, so
  eviction needs no deferred-free cycle.

On the device, resident adapters live in four stacks ``[L, n_slots + 1,
...]`` in the model's dtype, slot 0 the all-zero identity for rows
without an adapter. A load writes its slot in place, on the engine's
stream, so a step already dispatched reads the slot as it was.
"""

from __future__ import annotations

import hashlib
from typing import Optional

import numpy as np
import torch

__all__ = ["AdapterStore", "make_lora"]

# the q and v projections carry the adapters
_PARTS = ("a_q", "b_q", "a_v", "b_v")


def make_lora(cfg, rank: int, seed: int, scale: float = 0.05) -> dict:
    """Random LoRA weights (numpy fp32), the reference's draws: A ~ N(0,
    scale), B ~ N(0, scale) per layer for the q and v projections."""
    rng = np.random.RandomState(seed)
    L, H, dH = cfg.n_layers, cfg.hidden, cfg.head_dim
    nq, nv = cfg.n_heads * dH, cfg.n_kv_heads * dH
    f = lambda *s: (rng.randn(*s) * scale).astype(np.float32)  # noqa: E731
    return {"a_q": f(L, H, rank), "b_q": f(L, rank, nq),
            "a_v": f(L, H, rank), "b_v": f(L, rank, nv)}


class AdapterStore:
    """Refcounted, content-hashed adapter residency: the host weight
    library, the device slot stacks and the pool's page accounting.
    ``alloc_pages`` is the engine's allocator (which reclaims idle
    prefix-cache pages on demand); ``release_pages`` takes back an
    evicted adapter's pages."""

    def __init__(self, cfg, rank: int, n_slots: int, page_bytes: float,
                 alloc_pages, release_pages, device="cpu"):
        self.cfg = cfg
        self.rank = int(rank)
        self.n_slots = int(n_slots)
        self._alloc_pages = alloc_pages
        self._release_pages = release_pages
        L, H, dH = cfg.n_layers, cfg.hidden, cfg.head_dim
        nq, nv = cfg.n_heads * dH, cfg.n_kv_heads * dH

        def zeros(*shape):
            return torch.zeros(shape, dtype=cfg.dtype, device=device)

        self._aq = zeros(L, n_slots + 1, H, rank)
        self._bq = zeros(L, n_slots + 1, rank, nq)
        self._av = zeros(L, n_slots + 1, H, rank)
        self._bv = zeros(L, n_slots + 1, rank, nv)
        bytes_per = sum(t[:, 0].numel() * t.element_size()
                        for t in (self._aq, self._bq, self._av, self._bv))
        self.pages_per_adapter = max(1, -(-bytes_per // int(page_bytes)))
        self._weights: dict[bytes, dict] = {}      # hash -> host weights
        self._hash_of_id: dict = {}                # adapter id -> hash
        self._resident: dict[bytes, int] = {}      # hash -> device slot
        self._ref: dict[bytes, int] = {}           # hash -> live requests
        self._pages: dict[bytes, list[int]] = {}   # hash -> pool page ids
        self._idle: dict[bytes, None] = {}         # refcount-0 LRU
        self._free_slots = list(range(n_slots, 0, -1))
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def register(self, adapter_id, weights: dict) -> None:
        """Add ``weights`` (``make_lora``'s layout) to the host library
        under ``adapter_id``; it becomes resident at its first acquire.
        Identical bytes under another id share one content hash."""
        h = hashlib.sha1(b"pt-lora:%d" % self.rank)
        for part in _PARTS:
            h.update(np.ascontiguousarray(weights[part],
                                          dtype=np.float32).tobytes())
        digest = h.digest()
        self._hash_of_id[adapter_id] = digest
        if digest not in self._weights:
            self._weights[digest] = {part: np.asarray(weights[part],
                                                      np.float32)
                                     for part in _PARTS}

    def known(self, adapter_id) -> bool:
        return adapter_id in self._hash_of_id

    def digest_of(self, adapter_id) -> bytes:
        """Content digest of a registered adapter: the engine salts its
        prefix-cache page hashes with it (the v delta changes the KV
        pages' bytes)."""
        return self._hash_of_id[adapter_id]

    def acquire(self, adapter_id) -> Optional[int]:
        """Incref the adapter, loading it (device slot + pool pages) on a
        miss; returns its device slot, or None when the pool or the slots
        cannot hold it even after evicting every idle adapter (the caller
        treats that as a pool-blocked admission)."""
        digest = self._hash_of_id[adapter_id]
        slot = self._resident.get(digest)
        if slot is not None:
            if self._ref[digest] == 0:
                self._idle.pop(digest, None)
            self._ref[digest] += 1
            self.hits += 1
            return slot
        self.misses += 1
        while not self._free_slots:
            if not self._evict_idle():
                return None
        pages = self._alloc_pages(self.pages_per_adapter)
        while pages is None:
            if not self._evict_idle():
                return None
            pages = self._alloc_pages(self.pages_per_adapter)
        slot = self._free_slots.pop()
        w = self._weights[digest]
        for dst, part in ((self._aq, "a_q"), (self._bq, "b_q"),
                          (self._av, "a_v"), (self._bv, "b_v")):
            dst[:, slot] = torch.from_numpy(w[part]).to(dst.device,
                                                        dst.dtype)
        self._resident[digest] = slot
        self._ref[digest] = 1
        self._pages[digest] = pages
        return slot

    def decref(self, adapter_id) -> None:
        digest = self._hash_of_id[adapter_id]
        self._ref[digest] -= 1
        if self._ref[digest] == 0:
            self._idle[digest] = None      # warm: evicted only on pressure

    def _evict_idle(self) -> bool:
        """Drop the LRU idle adapter and return its pages to the pool;
        False when every resident adapter is in use."""
        if not self._idle:
            return False
        digest = next(iter(self._idle))
        del self._idle[digest]
        slot = self._resident.pop(digest)
        del self._ref[digest]
        self._release_pages(self._pages.pop(digest))
        self._free_slots.append(slot)
        self.evictions += 1
        return True

    def slot_of(self, adapter_id) -> int:
        """Device slot of an acquired adapter (never 0, the identity)."""
        return self._resident[self._hash_of_id[adapter_id]]

    def ref_of(self, adapter_id) -> int:
        return self._ref.get(self._hash_of_id[adapter_id], 0)

    def pages_of(self, adapter_id) -> list[int]:
        return list(self._pages.get(self._hash_of_id[adapter_id], []))

    def stacks(self) -> dict:
        """The four device stacks, ``[L, n_slots + 1, ...]``."""
        return {"aq": self._aq, "bq": self._bq,
                "av": self._av, "bv": self._bv}

    def n_pages_held(self) -> int:
        """Pool pages charged to resident adapters (the ledger's
        ``adapter`` class)."""
        return sum(len(p) for p in self._pages.values())

    def n_resident(self) -> int:
        return len(self._resident)

    def stats(self) -> dict:
        return {"adapter_hits": self.hits, "adapter_misses": self.misses,
                "adapter_evictions": self.evictions,
                "adapters_resident": len(self._resident),
                "adapter_pages": self.n_pages_held()}
