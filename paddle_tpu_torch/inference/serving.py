"""Continuous-batching LLaMA serving over a paged KV cache (port of
paddle_tpu/inference/serving.py, base path).

One engine step dispatches ONE ``[n_rows, qb]`` unified ragged-paged-
attention program: every row is a chunk of one request (a decode row is
a chunk with one valid token, a prefill slice fills up to ``qb``), and
per-request state (block tables, start positions, valid counts, sampling
parameters) is data, never shape. Around it:

- paged KV: per-layer page arrays, pages handed out from a free list;
  page 0 is the write sink for idle rows and padding tokens. k pages are
  d-major, the attention kernel's layout;
- prefix caching: full prompt pages are content-hashed (a cumulative
  chain) and refcounted, so a shared prefix is prefilled once;
- continuous batching: admission every step, bounded only by the page
  pool, with an aging barrier against starvation;
- a 1-deep pipeline: the next step is dispatched before the previous
  step's tokens are read, chained on the device through the previous
  output rows.

- int8 KV pages (``serving_kv_quant``): per-page, per-kv-head fp32
  scale planes kept as a running absmax; the attention reads the pages
  through K8q (``_write_attend_q``);
- speculative decode (``serving_speculative_k``): an n-gram proposer
  drafts up to k tokens per decode row from the request's own history,
  the step verifies them as one (k+1)-token chunk, greedy accept keeps
  the stream equal to the non-speculative one;
- multi-tenancy (``inference/multitenant/``): per-request LoRA adapters
  resident on the page pool and applied by the grouped BGMV kernel (K13,
  the q and v projections), priority classes with preemption, and
  schema-constrained decoding by a per-row vocabulary mask.

- the fleet surface (``inference/fleet/``): an ``engine_id``, the
  ``prefill_only`` role of a disaggregated prefill pool (prefill and the
  first token, then the prompt's full pages go to ``outbox`` and the
  slot is released), and the KV page wire, version 2: export (blocking,
  or staged behind the in-flight step on ``wire_overlap``), crc'd
  two-phase adoption into the prefix cache, and int8 <-> fp conversion
  at a mixed-mode edge. Chaos probes and observability spans sit on the
  host paths, each behind one global load when disarmed.

Token streams, page ledgers, counters and wire shipments equal the
reference engine's for the same weights and requests.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import time
import warnings
import zlib
from typing import Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.flags import GLOBAL_FLAGS
from ..core.jax_random import fold_in, gumbel, prng_key
from ..models.llama import (LlamaConfig, _mm, apply_rope, init_llama_params,
                            quantize_weights_int8, rms_norm, rope_angles)
from .. import obs as _obs
from ..obs import clock as _clock
from ..ops.kernels.lora_matmul import lora_matmul
from ..ops.kernels.ragged_paged_attention import ragged_paged_attention
from ..ops.nucleus import nucleus_keep
from ..ops.quant import (SCALE_EPS, kv_scale_update, quantize_to_scale,
                         rescale_int8)
from ..testing import chaos as _chaos
from .multitenant.lora import AdapterStore
from .speculative import NgramProposer

__all__ = ["Request", "ServingEngine", "wire_gather_pages",
           "wire_scatter_pages"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # [T] int32
    max_new_tokens: int
    arrival: float = 0.0               # seconds from engine start
    # temperature 0 -> greedy, > 0 -> top-p sampling keyed on
    # (seed, position); per-row data, so mixed batches share one step
    temperature: float = 0.0
    top_p: float = 1.0
    seed: int = 0
    # multi-tenancy: tenant is telemetry; priority orders admission and
    # preemption (serving_priorities); adapter_id names a registered
    # LoRA adapter (serving_lora); schema_id binds a registered schema at
    # admission, constraint is a live ConstraintState
    # (serving_constrained)
    tenant: int = 0
    priority: int = 0
    adapter_id: Optional[object] = None
    schema_id: Optional[object] = None
    constraint: Optional[object] = None
    # the fleet's (inference/fleet/), never read by the engine:
    # deadline_* are budgets in seconds from arrival (0 = none), which
    # the load generator's driver enforces and the router uses to send a
    # tight request to the least-loaded replica; session is an affinity
    # key; param_version pins an accepted stream to the weight version it
    # was admitted under (stamped by the router; None = unpinned)
    deadline_ttft: float = 0.0
    deadline_e2e: float = 0.0
    session: Optional[object] = None
    param_version: Optional[str] = None
    # filled by the engine:
    out_tokens: list = dataclasses.field(default_factory=list)
    t_first: Optional[float] = None    # first-token time
    t_done: Optional[float] = None
    aborted: bool = False
    age: int = 0                       # pool-blocked admission skips
    n_preempted: int = 0               # KV evictions survived


def _pick_tokens(logits, temps, topps, seeds, positions,
                 any_sampled: Optional[bool] = None):
    """Next token per row: greedy argmax at temperature 0, else top-p
    sampling at that temperature with Gumbel noise keyed on
    (seed, position of the input token), bit for bit the reference's
    keys. logits [N, V] fp32; temps/topps [N] fp32; seeds/positions [N]
    int32. ``any_sampled`` is the host's knowledge of ``temps > 0``, so a
    greedy-only step skips the sort without reading the device."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if any_sampled is None:
        any_sampled = bool((temps > 0).any())
    if not any_sampled:
        return greedy
    lt = logits / torch.clamp_min(temps, 1e-6)[:, None]
    srt = torch.sort(lt, dim=-1, descending=True).values
    p = torch.softmax(srt, dim=-1)
    keep = nucleus_keep(p, topps)              # always keeps >= 1
    kth = torch.where(keep, srt, math.inf).amin(dim=-1)
    masked = torch.where(lt >= kth[:, None], lt, -math.inf)
    keys = fold_in(prng_key(seeds), positions)
    noisy = masked + gumbel(keys, logits.shape[-1])
    samp = torch.argmax(noisy, dim=-1).to(torch.int32)
    return torch.where(temps > 0, samp, greedy)


def wire_gather_pages(pages: torch.Tensor, pg: torch.Tensor) -> torch.Tensor:
    """The wire's donor half: the per-layer pages at indices ``pg`` of
    ``pages`` [L, P, ...] in shipment layout [n, L, ...], a new
    contiguous tensor. On a CUDA tensor these are torch ops on the
    current stream, ordered behind the steps already enqueued there."""
    return torch.index_select(pages, 1, pg).movedim(1, 0).contiguous()


def wire_scatter_pages(pages: torch.Tensor, pg: torch.Tensor,
                       payload: torch.Tensor) -> torch.Tensor:
    """The wire's adopter half: write ``payload`` [L, n, ...] into
    ``pages`` [L, P, ...] at page indices ``pg``, in place."""
    return pages.index_copy_(1, pg, payload)


# the wire names dtypes as the reference does (``str`` of a jnp dtype)
_DTYPE_NAME = {torch.float32: "float32", torch.bfloat16: "bfloat16",
               torch.float16: "float16", torch.int8: "int8"}


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as a numpy payload with the same bytes: bf16, which
    numpy lacks, as a uint16 view."""
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_host(a, dtype: torch.dtype) -> torch.Tensor:
    """A numpy payload as a CPU tensor of ``dtype``: a 2-byte payload of a
    bf16 pool (uint16 here, ``ml_dtypes.bfloat16`` from the reference) is
    viewed, never converted."""
    a = np.ascontiguousarray(a)
    if dtype == torch.bfloat16:
        if a.dtype.itemsize != 2:
            raise ValueError(f"bfloat16 payload of itemsize "
                             f"{a.dtype.itemsize}")
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _page_crc(k, v, ks, vs, j: int) -> int:
    """crc32 of shipment page j: its k and v bytes (+ both scale planes
    when the payload is int8), the reference's crc32 of their
    concatenation, chained over each array's own bytes without copying
    them."""
    crc = 0
    for a in (k, v) if ks is None else (k, v, ks, vs):
        crc = zlib.crc32(np.ascontiguousarray(a[j]).reshape(-1).view(
            np.uint8), crc)
    return crc


class _PagePool:
    """Refcounted free-list page allocator with a content-addressed
    prefix cache. Page 0 is the idle-slot write sink and never handed
    out.

    A cached page is inserted at refcount 1 (the inserting request's own
    mapping); ``lookup`` increfs every hit; ``decref`` moves refcount-0
    pages to a pending list, and ``commit_evictable`` (called once no
    in-flight step can still read them) makes them LRU-evictable, where
    ``evict`` reclaims them for allocation."""

    def __init__(self, n_pages: int, cache_limit: int = 0):
        self.n_pages = n_pages
        self.free = list(range(n_pages - 1, 0, -1))
        self.cache: dict[bytes, int] = {}      # prefix hash -> page
        self.ref: dict[int, int] = {}          # cached page -> refcount
        self.hash_of: dict[int, bytes] = {}
        self.evictable: dict[int, None] = {}   # insertion-ordered = LRU
        self.pending_evict: list[int] = []
        self.cache_limit = cache_limit
        self.hits = 0
        self.misses = 0

    def alloc(self, n: int) -> Optional[list[int]]:
        if len(self.free) < n:
            return None
        return [self.free.pop() for _ in range(n)]

    def release(self, pages: list[int]) -> None:
        self.free.extend(pages)

    def lookup(self, hashes: list[bytes]) -> list[int]:
        """Longest cached prefix of ``hashes``; increfs each hit."""
        out: list[int] = []
        for h in hashes:
            p = self.cache.get(h)
            if p is None:
                break
            self.ref[p] += 1
            self.evictable.pop(p, None)
            if p in self.pending_evict:
                self.pending_evict.remove(p)
            out.append(p)
        self.hits += len(out)
        self.misses += len(hashes) - len(out)
        return out

    def insert(self, h: bytes, page: int) -> bool:
        """Register a written page under its prefix hash at refcount 1;
        False if the hash is already cached."""
        if h in self.cache:
            return False
        self.cache[h] = page
        self.ref[page] = 1
        self.hash_of[page] = h
        return True

    def decref(self, pages: list[int]) -> None:
        for p in pages:
            self.ref[p] -= 1
            if self.ref[p] == 0:
                self.pending_evict.append(p)

    def commit_evictable(self) -> None:
        for p in self.pending_evict:
            self.evictable[p] = None
        self.pending_evict = []
        if self.cache_limit and len(self.evictable) > self.cache_limit:
            self.evict(len(self.evictable) - self.cache_limit)

    def evict(self, n: int) -> int:
        """Reclaim up to ``n`` LRU evictable pages into the free list."""
        done = 0
        while done < n and self.evictable:
            p = next(iter(self.evictable))
            del self.evictable[p]
            del self.cache[self.hash_of.pop(p)]
            del self.ref[p]
            self.free.append(p)
            done += 1
        return done




class ServingEngine:
    """Continuous-batching LLaMA serving over paged KV.

    ``step()`` = admissions + ONE unified dispatch + harvest of the
    previous dispatch; ``run(requests)`` drives wall-clock arrivals to
    completion and returns latency/throughput/occupancy stats. Runs on
    ``cuda`` unless ``device`` says otherwise. Each of ``speculative_k``,
    ``spec_ngram``, ``kv_quant``, ``lora``, ``priorities`` and
    ``constrained`` falls back to its ``serving_*`` flag when None, and
    ``wire_overlap`` to ``serving_wire_overlap``. ``engine_id``,
    ``prefill_only`` and ``wire_overlap`` are the fleet's; a lone engine
    keeps their defaults and never exports or adopts. On a card every
    step, export and adoption of an engine runs on the current CUDA
    stream; the overlapped wire's host copies alone use a side stream."""

    def __init__(self, cfg: LlamaConfig, params: Optional[dict] = None,
                 seed: int = 0, max_batch: int = 8, page_size: int = 128,
                 max_seq: Optional[int] = None, n_pages: Optional[int] = None,
                 prefill_budget: Optional[int] = None,
                 prefix_cache: Optional[bool] = None,
                 prefix_cache_pages: Optional[int] = None,
                 admit_aging: int = 64,
                 weight_only_int8: Optional[bool] = None,
                 qb: Optional[int] = None,
                 speculative_k: Optional[int] = None,
                 spec_ngram: Optional[int] = None,
                 kv_quant: Optional[bool] = None,
                 lora: Optional[bool] = None,
                 lora_rank: int = 8,
                 lora_slots: int = 4,
                 priorities: Optional[bool] = None,
                 constrained: Optional[bool] = None,
                 decode_quantum: Optional[int] = None,
                 engine_id: int = 0,
                 prefill_only: bool = False,
                 wire_overlap: Optional[bool] = None,
                 device=None):
        if decode_quantum is not None:
            warnings.warn(
                "ServingEngine(decode_quantum=...) is deprecated and has "
                "no effect: the unified ragged-paged-attention step has "
                "no decode-quantum boundary", DeprecationWarning,
                stacklevel=2)
        self.decode_quantum = max(1, decode_quantum or 8)  # legacy attr
        # fleet identity: names this replica in the router's health and
        # stats and targets chaos specs (ctx {"engine": id})
        self.engine_id = int(engine_id)
        # disaggregated pool role, set by the router (constructor or
        # attribute flip): a prefill-only engine prefills through the
        # first token, puts (request, shipment) on ``outbox`` and
        # releases the slot; it never dispatches a decode row.
        # ``pool_role`` tags its chaos probes
        self.prefill_only = bool(prefill_only)
        self.pool_role: Optional[str] = None
        self.outbox: list = []
        # the weight version loaded (set_params); None on a lone engine
        self.param_version: Optional[str] = None
        self.device = resolve_device(device)
        self.cfg = cfg
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_llama_params(cfg, gen, self.device)
        self.params = params
        if weight_only_int8 is None:
            weight_only_int8 = bool(GLOBAL_FLAGS.get("decode_weight_quant"))
        if (weight_only_int8 or cfg.weight_only_int8) and not isinstance(
                self.params["blocks"]["wq"], tuple):
            # per-column absmax int8 + bf16 scales; every matmul of the
            # step goes through the tuple-aware _mm
            self.params = quantize_weights_int8(self.params)
        # set_params lands new weights in the format the constructor chose
        self._weight_only_int8 = bool(weight_only_int8)

        def flag(value, name):
            return GLOBAL_FLAGS.get(name) if value is None else value

        self.B = max_batch
        self.bs = page_size
        self.max_seq = max_seq or cfg.max_seq_len
        self.max_blocks = (self.max_seq + page_size - 1) // page_size
        self.n_pages = n_pages or (1 + max_batch * self.max_blocks)
        prefill_budget = flag(prefill_budget, "serving_prefill_budget")
        prefix_cache = flag(prefix_cache, "serving_prefix_cache")
        prefix_cache_pages = flag(prefix_cache_pages,
                                  "serving_prefix_cache_pages")
        qb = flag(qb, "serving_unified_qb")
        # unified grid: n_rows chunks of qb tokens; every decoding slot
        # gets one row per step, so n_rows >= max_batch
        self.qb = max(1, qb)
        self.n_rows = max(1, prefill_budget // self.qb, max_batch)
        self.prefill_budget = self.n_rows * self.qb
        # a decode row holds its input token + up to qb - 1 drafts
        self.spec_k = max(0, min(int(flag(speculative_k,
                                          "serving_speculative_k")),
                                 self.qb - 1))
        self._proposer = (NgramProposer(max(1, flag(spec_ngram,
                                                    "serving_spec_ngram")))
                          if self.spec_k else None)
        self._kv_quant = bool(flag(kv_quant, "serving_kv_quant"))
        # overlapped wire: export stages a gather and an asynchronous
        # device-to-host copy behind the in-flight step instead of
        # blocking on it, and adoption's page writes wait for the next
        # dispatch. Off: the synchronous wire
        self._wire_overlap = bool(flag(wire_overlap, "serving_wire_overlap"))
        self._wire_stream = None      # the side stream of staged copies
        self._lora_on = bool(flag(lora, "serving_lora"))
        self._prio_on = bool(flag(priorities, "serving_priorities"))
        self._constr_on = bool(flag(constrained, "serving_constrained"))
        if self._constr_on and self.spec_k:
            raise ValueError(
                "serving_constrained is incompatible with "
                "serving_speculative_k: a constraint mask covers one "
                "sampling position per row, not a k-token draft ladder")
        self._cache_on = bool(prefix_cache)
        self.admit_aging = admit_aging
        L, nKV, d = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        # updated in place by each step (the reference donates them).
        # serving_kv_quant: symmetric int8 pages with a [L, P, nKV] fp32
        # scale plane each, a page's running absmax per kv head
        page_dtype = torch.int8 if self._kv_quant else cfg.dtype
        self.k_pages = torch.zeros((L, self.n_pages, nKV, d, self.bs),
                                   dtype=page_dtype, device=self.device)
        self.v_pages = torch.zeros((L, self.n_pages, nKV, self.bs, d),
                                   dtype=page_dtype, device=self.device)
        if self._kv_quant:
            self.k_scales = torch.zeros((L, self.n_pages, nKV),
                                        dtype=torch.float32,
                                        device=self.device)
            self.v_scales = torch.zeros_like(self.k_scales)
        else:
            self.k_scales = self.v_scales = None
        self.seq_lens = np.zeros((self.B,), np.int32)
        self.cur_tok = np.zeros((self.B,), np.int32)
        self.slots: list[Optional[Request]] = [None] * self.B
        # owned pages return to the free list at teardown; shared pages
        # are prefix-cache mappings and only lose a refcount. _full_rows
        # is the request's block-table row
        self._slot_owned: list[list[int]] = [[] for _ in range(self.B)]
        self._slot_shared: list[list[int]] = [[] for _ in range(self.B)]
        self._slot_hashes: list[list[bytes]] = [[] for _ in range(self.B)]
        self._slot_offered: list[int] = [0] * self.B
        self._full_rows = np.zeros((self.B, self.max_blocks), np.int32)
        # per-slot multi-tenant state: the adapter id (refcount handle)
        # and its device slot (0 = identity), and the effective prompt:
        # the prompt plus the tokens emitted before a preemption, so a
        # resumed request re-prefills its history and its next pick has
        # the uninterrupted stream's (seed, position) key
        self._slot_adapter_id: list = [None] * self.B
        self._slot_aslot: list[int] = [0] * self.B
        self._slot_prompt: list = [None] * self.B
        # slot -> next prompt position to prefill; dict order = admission
        # order, so chunk packing stays FIFO across requests
        self._prefilling: dict[int, int] = {}
        self.pool = _PagePool(self.n_pages, cache_limit=prefix_cache_pages)
        self.queue: list[Request] = []
        self.adapters = (AdapterStore(cfg, lora_rank, lora_slots,
                                      self.kv_bytes_per_page(),
                                      self._alloc_pages, self.pool.release,
                                      device=self.device)
                         if self._lora_on else None)
        self._schemas: dict = {}        # schema id -> ConstraintState factory
        # pipelining: _inflight holds the dispatched-but-unharvested
        # step's (output tokens, row snapshot); _prev_out_dev chains row
        # outputs into the next dispatch; _deferred_free holds page ids
        # for one harvest cycle (an in-flight step may still write them)
        self._inflight = None
        self._prev_out_dev = None
        self._deferred_free: list[int] = []
        # adoption staged by begin_adopt, not yet committed: the ledger's
        # in_flight class
        self._adopting: list[dict] = []
        # overlapped-wire commits: published in the prefix cache (ledger
        # class cache_idle), their bytes written at the next dispatch
        self._commit_pending: list[dict] = []
        self.stats = {
            "unified_steps": 0, "decode_steps": 0, "prefills": 0,
            "prefill_tokens": 0, "prefill_grid_tokens": 0,
            "prefill_cached_tokens": 0,
            "decode_slot_tokens": 0, "decode_active_tokens": 0,
            # active + the six waste buckets == decode_slot_tokens
            "waste_prefill_slot_tokens": 0,        # slot mid-prefill
            "waste_queue_empty_slot_tokens": 0,    # idle, nothing arrived
            "waste_admission_blocked_slot_tokens": 0,  # idle, pool-blocked
            "waste_overrun_slot_tokens": 0,        # aborted/over-produced
            "waste_spec_rejected_slot_tokens": 0,  # rejected drafts
            "waste_preempted_slot_tokens": 0,      # re-prefill after preempt
            "spec_proposed_tokens": 0, "spec_accepted_tokens": 0,
            "preemptions": 0,
            # donor-side host ms spent materializing wire payloads
            "wire_export_ms": 0.0,
        }
        # FLAGS_obs_trace=1 arms the observability plane from any entry
        _obs.arm_from_flags()

    # -- the step program -------------------------------------------------

    def _unified_step_impl(self, tokens, prev_out, chain_mask, chain_row,
                           ptable, row_slot, pos0, n_valid, temps, topps,
                           seeds, any_sampled: bool, aid=None, stacks=None,
                           vmask=None):
        """THE engine step: one ``[n_rows, qb]`` program over an arbitrary
        prefill/decode mix. Row c holds n_valid[c] tokens of request
        row_slot[c] from position pos0[c] (a decode row holds its input
        token and its drafts); an idle row targets the sink block-table
        row (row_slot == B). ``chain_mask``/``chain_row`` splice the
        previous dispatch's outputs into this dispatch's first-token
        column on the device. Valid tokens write their k/v to their own
        (page, offset), padding tokens to the sink page, before each layer
        attends. ``aid``/``stacks``: each row's adapter slot and the
        adapter stacks (serving_lora); ``vmask``: each row's [V] legality
        mask (serving_constrained). Returns out [C, 1], each row's pick
        after its last valid token, or [C, qb], the pick after every
        position, when speculating."""
        cfg, p = self.cfg, self.params
        C, qb = tokens.shape
        nH, nKV, dH = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        dev = tokens.device
        tok0 = torch.where(chain_mask, prev_out[chain_row.long(), 0],
                           tokens[:, 0])
        tokens = torch.cat([tok0[:, None], tokens[:, 1:]], dim=1)
        rows = ptable[row_slot.long()]               # [C, max_blocks]
        ar = torch.arange(qb, dtype=torch.int32, device=dev)
        positions = pos0[:, None] + ar
        valid = ar[None, :] < n_valid[:, None]
        # padding positions can run past the block table; the reference's
        # gather fills those with garbage that the mask then sends to the
        # sink page, so clamping first changes nothing
        blk = torch.clamp(positions // self.bs, max=self.max_blocks - 1)
        offs = (positions % self.bs).reshape(-1).long()
        pages = torch.where(valid, torch.gather(rows, 1, blk.long()),
                            0).reshape(-1).long()    # padding -> sink
        if self._kv_quant:
            # every page a row's span may straddle: its first page and
            # the ones a qb-token span can spill into; entries past the
            # span hit the row's future pages or the sink, where the
            # rescale is an exact no-op
            npw = (qb - 1) // self.bs + 2
            blk_rw = torch.clamp(
                pos0[:, None] // self.bs
                + torch.arange(npw, dtype=torch.int32, device=dev), 0,
                self.max_blocks - 1)
            pages_rw = torch.gather(rows, 1, blk_rw.long()).reshape(
                -1).long()
        x = p["wte"][tokens.long()].to(cfg.dtype)    # [C, qb, H]
        cos, sin = rope_angles(cfg, positions)       # [C, qb, dH/2]
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
        sm_scale = 1.0 / math.sqrt(dH)
        blocks = p["blocks"]
        for layer in range(cfg.n_layers):
            bp = {k: (v[0][layer], v[1][layer]) if isinstance(v, tuple)
                  else v[layer] for k, v in blocks.items()}
            h = rms_norm(x, bp["attn_norm"], cfg.rms_eps)
            q = _mm(h, bp["wq"], cfg)
            k = _mm(h, bp["wk"], cfg).reshape(C, qb, nKV, dH)
            v = _mm(h, bp["wv"], cfg)
            if stacks is not None:
                # grouped BGMV: each row through its adapter's q and v
                # deltas (slot 0 adds exactly +0.0)
                q = q + lora_matmul(h, stacks["aq"][layer],
                                    stacks["bq"][layer], aid).to(q.dtype)
                v = v + lora_matmul(h, stacks["av"][layer],
                                    stacks["bv"][layer], aid).to(v.dtype)
            q = apply_rope(q.reshape(C, qb, nH, dH), cos, sin)
            k = apply_rope(k, cos, sin)
            v = v.reshape(C, qb, nKV, dH)
            if self._kv_quant:
                o = self._write_attend_q(layer, q, k, v, pages, offs,
                                         pages_rw, rows, pos0, n_valid,
                                         sm_scale)
            else:
                kp, vp = self.k_pages[layer], self.v_pages[layer]
                # in place: k pages [P, nKV, d, bs] take token n at
                # [pages[n], :, :, offs[n]], v pages [P, nKV, bs, d] at
                # [pages[n], :, offs[n]]; both index pairs put the token
                # axis first, so the values are [C*qb, nKV, dH]
                kp[pages, :, :, offs] = k.reshape(C * qb, nKV, dH)
                vp[pages, :, offs] = v.reshape(C * qb, nKV, dH)
                o = ragged_paged_attention(q, kp, vp, rows, pos0, n_valid,
                                           sm_scale)
            x = x + _mm(o.reshape(C, qb, nH * dH), bp["wo"], cfg)
            h = rms_norm(x, bp["ffn_norm"], cfg.rms_eps)
            g = torch.nn.functional.silu(
                _mm(h, bp["w_gate"], cfg).float()).to(cfg.dtype)
            x = x + _mm(g * _mm(h, bp["w_up"], cfg), bp["w_down"], cfg)
        x = rms_norm(x, p["final_norm"], cfg.rms_eps)
        if self.spec_k:
            # the verify ladder: the pick after every input position, each
            # keyed on its own position, so an accepted draft is the token
            # one-at-a-time decoding picks there. The head runs once per
            # position at the one-token step's shape [C, 1, H]: on the
            # card a GEMM's sums follow its shape, and so each position
            # gets the logits the non-speculative step computes there
            logits = torch.cat([_mm(x[:, j].contiguous()[:, None],
                                    p["head"], cfg) for j in range(qb)],
                               dim=1).float().reshape(C * qb, -1)
            picks = _pick_tokens(logits, temps.repeat_interleave(qb),
                                 topps.repeat_interleave(qb),
                                 seeds.repeat_interleave(qb),
                                 positions.reshape(-1), any_sampled)
            return picks.reshape(C, qb)
        last = x[torch.arange(C, device=dev), (n_valid - 1).long()]
        logits = _mm(last[:, None], p["head"], cfg).float()[:, 0]
        if vmask is not None:
            # unconstrained rows carry an all-True mask: logits unchanged
            logits = torch.where(vmask, logits, -1e30)
        # keyed on the last valid input position: sampled streams do not
        # depend on chunking, budget or packing
        return _pick_tokens(logits, temps, topps, seeds, pos0 + n_valid - 1,
                            any_sampled)[:, None]

    def _write_attend_q(self, layer, q, k, v, pages, offs, pages_rw, rows,
                        pos0, n_valid, sm_scale):
        """serving_kv_quant: write this layer's k/v into its int8 pages and
        attend through K8q. A page fills incrementally, so its scale is a
        running absmax:

        1. scatter-max the plane with the tokens' absmax / 127 (max does
           not depend on order: duplicate page ids are deterministic);
        2. rescale the int8 content of every page a row may straddle
           (``pages_rw``) from its old scale onto the new one, an exact
           no-op where the scale did not grow; duplicates in ``pages_rw``
           write identical bytes;
        3. quantize the new tokens against the updated scale and scatter
           them per (page, offset), as the fp path does.

        In place, where the reference is functional: the old plane
        entries and page bytes at ``pages_rw`` are gathered before the
        plane and the pages are overwritten. A rejected draft's or reused
        page's content is overwritten before it can be attended, and
        ``_alloc_pages`` zeroes a page's scales when it is handed out."""
        C, qb, nKV, dH = k.shape
        kp, vp = self.k_pages[layer], self.v_pages[layer]
        ksc, vsc = self.k_scales[layer], self.v_scales[layer]
        kf = k.reshape(C * qb, nKV, dH).float()
        vf = v.reshape(C * qb, nKV, dH).float()
        k_old, v_old = ksc[pages_rw], vsc[pages_rw]
        kv_scale_update(ksc, pages, kf.abs().amax(-1) / 127.0)
        kv_scale_update(vsc, pages, vf.abs().amax(-1) / 127.0)
        kp[pages_rw] = rescale_int8(kp[pages_rw], k_old[:, :, None, None],
                                    ksc[pages_rw][:, :, None, None])
        vp[pages_rw] = rescale_int8(vp[pages_rw], v_old[:, :, None, None],
                                    vsc[pages_rw][:, :, None, None])
        kp[pages, :, :, offs] = quantize_to_scale(kf, ksc[pages][:, :, None])
        vp[pages, :, offs] = quantize_to_scale(vf, vsc[pages][:, :, None])
        return ragged_paged_attention(q, kp, vp, rows, pos0, n_valid,
                                      sm_scale, k_scales=ksc, v_scales=vsc)

    # -- scheduler ---------------------------------------------------------

    def set_params(self, params, version=None) -> None:
        """Swap the weights in place: the next step reads them. Cached
        pages of other weights stay in the pool but no longer match a
        lookup: the prefix-cache salt carries ``version``. An engine
        built with weight-only int8 gets its new weights quantized as its
        constructor did."""
        self.params = params
        if ((self._weight_only_int8 or self.cfg.weight_only_int8)
                and not isinstance(self.params["blocks"]["wq"], tuple)):
            self.params = quantize_weights_int8(self.params)
        self.param_version = version

    def register_adapter(self, adapter_id, weights: dict) -> None:
        """Add a LoRA adapter (``multitenant.make_lora``'s layout) to the
        host library; requests name it by ``adapter_id``. It becomes
        resident on pool pages at its first admission."""
        if not self._lora_on:
            raise RuntimeError("register_adapter requires serving_lora")
        self.adapters.register(adapter_id, weights)

    def register_schema(self, schema_id, factory) -> None:
        """Bind ``schema_id`` to a zero-argument ConstraintState factory
        (e.g. ``json_schema_dfa(...).fresh``); a request naming it gets a
        fresh constraint at admission."""
        if not self._constr_on:
            raise RuntimeError(
                "register_schema requires serving_constrained")
        self._schemas[schema_id] = factory

    def submit(self, req: Request) -> None:
        if len(req.prompt) + req.max_new_tokens > self.max_seq:
            raise ValueError(
                f"request {req.rid}: prompt {len(req.prompt)} + "
                f"{req.max_new_tokens} new tokens exceeds max_seq "
                f"{self.max_seq}")
        n_blk = -(-(len(req.prompt) + req.max_new_tokens) // self.bs)
        if n_blk > self.n_pages - 1:       # page 0 is the sink
            raise ValueError(
                f"request {req.rid}: needs {n_blk} pages but the pool "
                f"holds {self.n_pages - 1} — it could never be admitted")
        if req.adapter_id is not None:
            if not self._lora_on:
                raise ValueError(
                    f"request {req.rid}: adapter_id set but serving_lora "
                    "is off")
            if not self.adapters.known(req.adapter_id):
                raise ValueError(
                    f"request {req.rid}: unknown adapter "
                    f"{req.adapter_id!r} — register_adapter it first")
        if req.schema_id is not None or req.constraint is not None:
            if not self._constr_on:
                raise ValueError(
                    f"request {req.rid}: constrained-decoding fields set "
                    "but serving_constrained is off")
            if (req.schema_id is not None
                    and req.schema_id not in self._schemas):
                raise ValueError(
                    f"request {req.rid}: unknown schema "
                    f"{req.schema_id!r} — register_schema it first")
            if (req.constraint is not None
                    and req.constraint.dfa.vocab_size
                    != self.cfg.vocab_size):
                raise ValueError(
                    f"request {req.rid}: constraint vocab "
                    f"{req.constraint.dfa.vocab_size} != model vocab "
                    f"{self.cfg.vocab_size}")
        self.queue.append(req)
        # lifecycle: the first submission opens the request's trace flow;
        # a resume (preemption, migration, handoff) is an instant on it
        _obs.lifecycle(req.rid,
                       "arrival" if (req.t_first is None
                                     and not req.out_tokens)
                       else "resubmit",
                       engine=self.engine_id)

    def abort(self, rid: int) -> bool:
        """Cancel a request by rid, queued or slot-resident (its pages go
        through the deferred-free path; tokens an in-flight step makes
        for it are dropped at harvest). False if the rid is unknown or
        already done."""
        now = _clock.now()
        for i, r in enumerate(self.queue):
            if r.rid == rid:
                self.queue.pop(i)
                r.aborted = True
                r.t_done = now
                return True
        for s in range(self.B):
            req = self.slots[s]
            if req is not None and req.rid == rid:
                req.aborted = True
                req.t_done = now
                self._release_slot_pages(s, defer=True)
                self._prefilling.pop(s, None)
                self._clear_slot(s)
                return True
        return False

    def _page_hashes(self, prompt: np.ndarray,
                     salt: bytes = b"") -> list[bytes]:
        """Cumulative content hash per FULL prompt page: hash j covers
        pages 0..j, so an equal hash j means the whole prefix matches.
        The preimage holds everything that fixes a cached page's bytes:
        the tokens, the page size, the KV representation (``:kvq8`` for
        int8 pages, so int8 and fp pages never alias) and ``salt`` (a
        LoRA adapter's digest: its v delta changes the pages). The
        reference engine's preimage, byte for byte."""
        n_full = len(prompt) // self.bs
        out: list[bytes] = []
        seed = b"pt-prefix:%d" % self.bs
        if self._kv_quant:
            seed += b":kvq8"
        h = hashlib.sha1(seed + salt)
        for j in range(n_full):
            h.update(np.ascontiguousarray(
                prompt[j * self.bs:(j + 1) * self.bs],
                dtype=np.int32).tobytes())
            out.append(h.digest())
        return out

    def _cache_salt(self, req: Request) -> bytes:
        """The request's prefix-cache salt: its adapter's content digest
        when one is bound (KV written under adapter X must never serve a
        request under another adapter or none), then the engine's weight
        version once a rollout has named one (KV written under weights V
        must never serve a request after a swap to other weights); empty
        for a plain engine. The reference salts by adapter only, so its
        prefix cache serves pages of the old weights after a swap (ROADMAP
        Queue 3)."""
        salt = b""
        if self._lora_on and req.adapter_id is not None:
            salt = b"lora:" + self.adapters.digest_of(req.adapter_id)
        if self.param_version is not None:
            salt += b"|w:" + str(self.param_version).encode()
        return salt

    def _alloc_pages(self, n: int) -> Optional[list[int]]:
        """Free-list alloc, reclaiming idle prefix-cache pages on demand,
        then idle LoRA adapters, in that order. Chaos ``pool.alloc``
        ``fail`` reports an empty pool."""
        if _chaos.active():               # disarmed: one global load
            spec = _chaos.fire("pool.alloc", ctx={"engine": self.engine_id})
            if spec is not None and spec.kind == "fail":
                return None
        if len(self.pool.free) < n:
            self.pool.evict(n - len(self.pool.free))
        while (len(self.pool.free) < n and self.adapters is not None
               and self.adapters._evict_idle()):
            pass
        pages = self.pool.alloc(n)
        if self._kv_quant and pages:
            # a reused page's stale running absmax would quantize the new
            # tenant's tokens against a wrong scale: zero its planes so the
            # first write sets a fresh one. An in-place op on the engine's
            # stream, so a step already dispatched reads the old values
            pg = torch.tensor(pages, dtype=torch.long, device=self.device)
            self.k_scales[:, pg] = 0.0
            self.v_scales[:, pg] = 0.0
        return pages

    def _admit(self, now: float) -> None:
        """Admit arrived requests into free slots, FIFO with skip (highest
        priority first under serving_priorities): a pool-blocked request
        is stepped over, but once its ``age`` passes ``admit_aging``
        nothing behind it is admitted. A pool-blocked request may preempt
        one strictly lower-priority resident per pass. Cached prefix
        pages are mapped into the block table, the rest allocated."""
        free_slots = [s for s in range(self.B) if self.slots[s] is None]
        cand = list(self.queue)
        if self._prio_on:
            # stable: all-0 priorities keep the FIFO order
            cand.sort(key=lambda r: (-r.priority, r.arrival))
        preempted = False
        for req in cand:
            if not free_slots:
                break
            if req.out_tokens and len(req.out_tokens) >= req.max_new_tokens:
                # a preempted request completed by its in-flight row's
                # token: nothing is left to decode
                self._dequeue(req)
                continue
            if req.arrival > now:
                continue
            P = (np.concatenate([np.asarray(req.prompt, np.int32),
                                 np.asarray(req.out_tokens, np.int32)])
                 if req.out_tokens else req.prompt)
            T = len(P)
            n_blk = -(-(len(req.prompt) + req.max_new_tokens) // self.bs)
            # the adapter increfs before the KV alloc, so a shared hit
            # cannot be evicted while we evict for pages
            aslot = 0
            if self._lora_on and req.adapter_id is not None:
                aslot = self.adapters.acquire(req.adapter_id)
            if aslot is None:              # adapter-blocked: pool-blocked
                shared, pages = [], None
            else:
                # never look up the page holding the last prompt token:
                # its chunk must run to produce the first-token logits
                hashes = (self._page_hashes(P, self._cache_salt(req))
                          if self._cache_on else [])
                shared = self.pool.lookup(hashes[:(T - 1) // self.bs])
                pages = self._alloc_pages(n_blk - len(shared))
            if pages is None:
                self.pool.decref(shared)
                if aslot:
                    self.adapters.decref(req.adapter_id)
                if (self._prio_on and not preempted
                        and self._preempt_for(req)):
                    # the victim's pages settle through deferred-free;
                    # the retry is next step
                    preempted = True
                req.age += 1
                if req.age > self.admit_aging:
                    break                  # aged request becomes a barrier
                continue
            self._dequeue(req)
            slot = free_slots.pop(0)
            n_shared = len(shared)
            self.slots[slot] = req
            _obs.lifecycle(req.rid, "admit", engine=self.engine_id,
                           slot=slot)
            self._slot_shared[slot] = shared
            self._slot_owned[slot] = pages
            self._slot_hashes[slot] = hashes
            self._slot_offered[slot] = n_shared
            self._slot_prompt[slot] = P
            if aslot:
                self._slot_adapter_id[slot] = req.adapter_id
                self._slot_aslot[slot] = aslot
            if (self._constr_on and req.constraint is None
                    and req.schema_id is not None):
                # a fresh DFA at first admission only: a resumed request
                # keeps its advanced state
                req.constraint = self._schemas[req.schema_id]()
            row = np.zeros((self.max_blocks,), np.int32)
            row[:n_shared] = shared
            row[n_shared:n_blk] = pages
            self._full_rows[slot] = row
            self.seq_lens[slot] = 0
            self.cur_tok[slot] = 0
            # prefill resumes after the cached prefix
            self._prefilling[slot] = n_shared * self.bs
            self.stats["prefill_cached_tokens"] += n_shared * self.bs

    def _dequeue(self, req: Request) -> None:
        for j, r in enumerate(self.queue):
            if r is req:
                self.queue.pop(j)
                return

    def _preempt_for(self, req: Request) -> bool:
        """Evict the weakest strictly-lower-priority resident so ``req``
        can admit once the pages settle: lowest priority first, latest
        arrival within a class. False when nobody ranks below ``req``."""
        best = None
        for s in range(self.B):
            r = self.slots[s]
            if r is None or r.priority >= req.priority:
                continue
            key = (r.priority, -r.arrival)
            if best is None or key < best[0]:
                best = (key, s)
        if best is None:
            return False
        self._preempt(best[1])
        return True

    def _preempt(self, slot: int) -> None:
        """Evict a resident's KV pages and requeue it; its emitted tokens
        stand, and re-admission re-prefills prompt + emitted history
        (mostly through the prefix cache). A token an in-flight step
        holds for it lands at harvest, before it can re-admit."""
        req = self.slots[slot]
        req.n_preempted += 1
        req.age = 0
        self.stats["preemptions"] += 1
        _obs.lifecycle(req.rid, "preempt", engine=self.engine_id)
        self._release_slot_pages(slot, defer=True)
        self._prefilling.pop(slot, None)
        self._clear_slot(slot)
        self.queue.append(req)

    def _clear_slot(self, slot: int) -> None:
        self.seq_lens[slot] = 0
        self.cur_tok[slot] = 0
        self.slots[slot] = None

    def _release_slot_pages(self, slot: int, defer: bool) -> None:
        """Owned pages to the free list (via _deferred_free while a step
        may be in flight), shared pages decref'd back to the cache; the
        slot's adapter loses its reference (every teardown path comes
        here once)."""
        owned, shared = self._slot_owned[slot], self._slot_shared[slot]
        self._slot_owned[slot] = []
        self._slot_shared[slot] = []
        self.pool.decref(shared)
        if defer:
            self._deferred_free.extend(owned)
        else:
            self.pool.release(owned)
            self.pool.commit_evictable()
        self._full_rows[slot] = 0
        aid = self._slot_adapter_id[slot]
        if aid is not None:
            self.adapters.decref(aid)
            self._slot_adapter_id[slot] = None
        self._slot_aslot[slot] = 0
        self._slot_prompt[slot] = None

    def _finish_if_done(self, slot: int, defer_free: bool = False) -> None:
        req = self.slots[slot]
        if req is not None and len(req.out_tokens) >= req.max_new_tokens:
            req.t_done = _clock.now()
            _obs.lifecycle(req.rid, "done", engine=self.engine_id)
            self._release_slot_pages(slot, defer=defer_free)
            self._clear_slot(slot)

    def _chaos_step(self) -> None:
        """Armed-only ``engine.step`` probe: ``raise`` (the router sees a
        dead replica) or ``hang`` (sleep ``seconds``; the router's step
        budget catches it)."""
        ctx = {"engine": self.engine_id}
        if self.pool_role is not None:
            ctx["pool"] = self.pool_role
        spec = _chaos.fire("engine.step", ctx=ctx)
        if spec is None:
            return
        if spec.kind == "hang":
            time.sleep(float(spec.args.get("seconds", 0.05)))
        else:
            raise _chaos.ChaosInjected(
                f"chaos: engine {self.engine_id} step failure")

    def step(self, now: Optional[float] = None) -> bool:
        """Admissions + ONE unified dispatch + harvest. Returns True while
        work remains.

        Pipelined: the next step is dispatched before the previous
        step's tokens are read, chained on the device. A request whose
        finish is predicted at dispatch (each row yields exactly one
        token) gives up its slot at once, while its pages wait one
        harvest cycle in ``_deferred_free``. Speculative and constrained
        engines are synchronous: drafts and masks are host state made
        from the previous step's tokens, so each step is harvested before
        the next dispatch. A prefill-only engine exports its finished
        prefills after the harvest (``_export_completed``)."""
        if _chaos.active():               # disarmed: one global load
            self._chaos_step()
        if _obs.active():                 # the same for the tracer
            with _obs.span("engine.step", engine=self.engine_id):
                return self._step_impl(now, traced=True)
        return self._step_impl(now, traced=False)

    def _step_impl(self, now: Optional[float], traced: bool) -> bool:
        def phase(name, fn, *args):
            if traced:
                with _obs.span(name, engine=self.engine_id):
                    return fn(*args)
            return fn(*args)

        now = _clock.now() if now is None else now
        phase("engine.admit", self._admit, now)
        prev = self._inflight
        phase("engine.dispatch", self._dispatch_unified, now)
        if self.spec_k or self._constr_on:
            if self._inflight is not None:
                phase("engine.harvest", self._harvest, self._inflight)
        elif prev is not None:
            phase("engine.harvest", self._harvest, prev)
        if self.prefill_only:
            self._export_completed()
        if self._inflight is None and (self._deferred_free
                                       or self.pool.pending_evict):
            # nothing in flight: deferred and pending pages can be
            # reclaimed now, or pool-bound admission would wait forever
            self.pool.release(self._deferred_free)
            self._deferred_free = []
            self.pool.commit_evictable()
        if not self.spec_k and self._inflight is not None:
            for idx, s, req, kind, m, _dr in self._inflight[1]:
                if (kind != "mid" and self.slots[s] is req
                        and req.max_new_tokens - len(req.out_tokens) <= 1):
                    self._release_slot_pages(s, defer=True)
                    self.seq_lens[s] = 0
                    self.slots[s] = None
        return (self._inflight is not None or bool(self.queue)
                or any(s is not None for s in self.slots))

    def _export_completed(self) -> None:
        """Prefill-only sweep, after the harvest: a resident past its
        prefill flip with its first token landed is done here. Its full
        prompt pages are exported (None when no full page is covered),
        ``(request, shipment)`` goes on ``outbox`` for the router, and
        the slot is released at once. A decode engine re-admits the
        request with prompt + out_tokens, its cache lookup covers the
        shipped pages and it re-prefills the tail: the resume path of
        preemption and engine loss, so the stream is unchanged. The same
        sweep moves a mid-decode resident off an engine returning to the
        prefill role. A slot the in-flight step references is never
        swept: a resumed request would export before its prefill-final
        token is harvested, and that token would enter the stream twice.

        The pages are released with ``defer=False``: no dispatched step
        references them, and on a card every later write to them is
        enqueued on this engine's stream behind the export's gather."""
        inflight = ({s for _i, s, _r, _k, _m, _d in self._inflight[1]}
                    if self._inflight is not None else set())
        for s in range(self.B):
            req = self.slots[s]
            if (req is None or s in self._prefilling or s in inflight
                    or not req.out_tokens):
                continue
            t0 = _clock.now()
            with _obs.span("wire.stage", engine=self.engine_id,
                           rid=req.rid):
                shipment = (self.stage_request_pages(req.rid)
                            if self._wire_overlap
                            else self.export_request_pages(req.rid))
            self.stats["wire_export_ms"] += (_clock.now() - t0) * 1e3
            self.outbox.append((req, shipment))
            _obs.lifecycle(req.rid, "ship", engine=self.engine_id)
            self._release_slot_pages(s, defer=False)
            self._clear_slot(s)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _dispatch_unified(self, now: float = 0.0) -> None:
        """Build and dispatch one unified step for the current slot
        state; does not wait for the device. Every decoding slot gets one
        row (its input token + up to spec_k drafts), remaining rows carry
        qb-token prefill slices in admission order, the rest idle against
        the sink. Charges the occupancy ledger one slot-token per engaged
        slot (m for a speculative row); harvest classifies them. Deferred
        adoption commits land first; a prefill-only engine dispatches no
        decode row (a slot past its flip waits for the export sweep)."""
        if self._commit_pending:
            self._flush_commits()
        C, qb = self.n_rows, self.qb
        pref_entry = set(self._prefilling)
        decoding = [s for s in range(self.B) if self.slots[s] is not None
                    and s not in pref_entry]
        if self.prefill_only:
            decoding = []
        prev_rows: dict[int, int] = {}
        if self._inflight is not None:
            for idx, s, req, kind, m, _dr in self._inflight[1]:
                if kind != "mid" and self.slots[s] is req:
                    prev_rows[s] = idx
        sched = []                          # (slot, kind, pos0, m, drafts)
        for s in decoding:
            req = self.slots[s]
            pending = 1 if s in prev_rows else 0
            remaining = req.max_new_tokens - len(req.out_tokens) - pending
            drafts: list = []
            if self.spec_k and remaining > 1:
                hist = req.prompt.tolist() + req.out_tokens
                drafts = self._proposer.propose(
                    hist, min(self.spec_k, remaining - 1))
            sched.append((s, "dec", int(self.seq_lens[s]), 1 + len(drafts),
                          drafts))
        fin_slots = set()
        pref_touched: dict[int, int] = {}
        for slot in list(self._prefilling):
            if len(sched) >= C:
                break
            T = len(self._slot_prompt[slot])   # prompt (+ resumed history)
            pos = self._prefilling[slot]
            while pos < T and len(sched) < C:
                n = min(qb, T - pos)
                sched.append((slot, "fin" if pos + n >= T else "mid", pos,
                              n, None))
                pos += n
            self._prefilling[slot] = pos
            pref_touched[slot] = pos
        if not sched:
            return
        tokens = np.zeros((C, qb), np.int32)
        rs = np.full((C,), self.B, np.int32)       # idle rows -> sink row
        p0 = np.zeros((C,), np.int32)
        nv = np.ones((C,), np.int32)
        tt = np.zeros((C,), np.float32)
        tp = np.ones((C,), np.float32)
        tsd = np.zeros((C,), np.int32)
        cmask = np.zeros((C,), bool)
        crow = np.zeros((C,), np.int32)
        aidv = np.zeros((C,), np.int32)            # idle rows -> identity
        vm = (np.ones((C, self.cfg.vocab_size), bool) if self._constr_on
              else None)
        snap = []
        n_pf_rows = 0
        for idx, (s, kind, pos, m, drafts) in enumerate(sched):
            req = self.slots[s]
            rs[idx] = s
            p0[idx] = pos
            nv[idx] = m
            aidv[idx] = self._slot_aslot[s]
            if kind == "dec":
                if s in prev_rows:
                    cmask[idx] = True
                    crow[idx] = prev_rows[s]
                else:
                    tokens[idx, 0] = self.cur_tok[s]
                if drafts:
                    tokens[idx, 1:m] = drafts
            else:
                n_pf_rows += 1
                tokens[idx, :m] = self._slot_prompt[s][pos:pos + m]
                if kind == "fin":
                    fin_slots.add(s)
            if kind != "mid":
                tt[idx] = req.temperature
                tp[idx] = req.top_p
                tsd[idx] = req.seed
                if vm is not None and req.constraint is not None:
                    vm[idx] = req.constraint.mask()
            snap.append((idx, s, req, kind, m, drafts))
        ptab = np.concatenate(
            [self._full_rows, np.zeros((1, self.max_blocks), np.int32)])
        prev_out = self._prev_out_dev
        if prev_out is None:
            prev_out = torch.zeros((C, qb if self.spec_k else 1),
                                   dtype=torch.int32, device=self.device)
        out = self._unified_step_impl(
            self._dev(tokens), prev_out, self._dev(cmask), self._dev(crow),
            self._dev(ptab), self._dev(rs), self._dev(p0), self._dev(nv),
            self._dev(tt), self._dev(tp), self._dev(tsd),
            bool((tt > 0).any()),
            aid=self._dev(aidv) if self._lora_on else None,
            stacks=self.adapters.stacks() if self._lora_on else None,
            vmask=self._dev(vm) if vm is not None else None)
        self._inflight = (out, snap)
        self._prev_out_dev = out
        # prefix-cache offers for full prompt pages this step completed,
        # prefill flips, decode position advance
        for slot, pos_new in pref_touched.items():
            hashes = self._slot_hashes[slot]
            j1 = min(pos_new // self.bs, len(hashes))
            for j in range(self._slot_offered[slot], j1):
                page = int(self._full_rows[slot][j])
                if self.pool.insert(hashes[j], page):
                    self._slot_owned[slot].remove(page)
                    self._slot_shared[slot].append(page)
            self._slot_offered[slot] = max(self._slot_offered[slot], j1)
        for idx, s, req, kind, m, drafts in snap:
            if kind == "fin":
                del self._prefilling[s]
                self.seq_lens[s] = len(self._slot_prompt[s])
            if kind != "dec":
                self.stats["prefill_tokens"] += m
        if not self.spec_k:
            # speculating, harvest advances by the accepted count
            for s in decoding:
                self.seq_lens[s] += 1
        # occupancy ledger: one slot-token per engaged slot this step (m
        # for a speculative row)
        n_idle = self.B - len(decoding) - len(pref_entry)
        if n_idle:
            blocked = any(r.arrival <= now for r in self.queue)
            self.stats["waste_admission_blocked_slot_tokens" if blocked
                       else "waste_queue_empty_slot_tokens"] += n_idle
        # a resumed request's mid-prefill slot-tokens are the price of
        # preemption: their own bucket
        mid_slots = [s for s in pref_entry if s not in fin_slots]
        n_mid_pre = sum(1 for s in mid_slots
                        if self.slots[s] is not None
                        and self.slots[s].n_preempted)
        self.stats["waste_preempted_slot_tokens"] += n_mid_pre
        self.stats["waste_prefill_slot_tokens"] += len(mid_slots) - n_mid_pre
        self.stats["decode_slot_tokens"] += (
            sum(m for _s, kind, _p, m, _d in sched if kind == "dec")
            + len(fin_slots) + len(mid_slots) + n_idle)
        self.stats["unified_steps"] += 1
        if decoding:
            self.stats["decode_steps"] += 1
        if n_pf_rows:
            self.stats["prefills"] += 1
            self.stats["prefill_grid_tokens"] += n_pf_rows * qb

    def _emit(self, req: Request, tok: int) -> None:
        """Append one picked token (advancing the request's constraint)
        or count it as overrun."""
        if len(req.out_tokens) < req.max_new_tokens:
            req.out_tokens.append(tok)
            if req.constraint is not None:
                req.constraint.advance(tok)
            self.stats["decode_active_tokens"] += 1
        else:
            self.stats["waste_overrun_slot_tokens"] += 1

    def _harvest(self, inflight) -> None:
        """Read a dispatched step's row outputs (the serving path's only
        device-to-host wait) and apply them; release pages freed one
        cycle ago."""
        out_dev, snap = inflight
        toks = out_dev.cpu().numpy()                 # [C, 1] or [C, qb]
        if self._inflight is not None and self._inflight[0] is out_dev:
            self._inflight = None
        self.pool.release(self._deferred_free)
        self._deferred_free = []
        self.pool.commit_evictable()
        now = _clock.now()
        for idx, s, req, kind, m, drafts in snap:
            if kind == "mid":
                continue
            if req.aborted:
                self.stats["waste_overrun_slot_tokens"] += (
                    m if kind == "dec" else 1)
                continue
            if kind == "dec" and self.spec_k:
                # greedy verify: draft j survives iff it equals the pick
                # after the tokens before it
                o = [int(t) for t in toks[idx, :m]]
                a = 1
                while a < m and drafts[a - 1] == o[a - 1]:
                    a += 1
                take = min(a, req.max_new_tokens - len(req.out_tokens))
                req.out_tokens.extend(o[:take])
                if req.t_first is None and take:
                    req.t_first = now
                    _obs.lifecycle(req.rid, "first-token",
                                   engine=self.engine_id)
                self.stats["decode_active_tokens"] += take
                self.stats["waste_spec_rejected_slot_tokens"] += m - a
                self.stats["waste_overrun_slot_tokens"] += a - take
                self.stats["spec_proposed_tokens"] += m - 1
                self.stats["spec_accepted_tokens"] += a - 1
                if self.slots[s] is req:
                    # seq_lens advances by the accepted count: a rejected
                    # draft's k/v lies past it, masked for every later
                    # query and overwritten before it could be attended
                    self.seq_lens[s] += take
                    if take:
                        self.cur_tok[s] = o[take - 1]
                    self._finish_if_done(s, defer_free=True)
            else:
                # a prefill-final row's own output is the first token
                tok = int(toks[idx, m - 1] if kind == "fin" and self.spec_k
                          else toks[idx, 0])
                self._emit(req, tok)
                if kind == "fin" and req.t_first is None:
                    req.t_first = now
                    _obs.lifecycle(req.rid, "first-token",
                                   engine=self.engine_id)
                if self.slots[s] is req:
                    self.cur_tok[s] = tok
                    self._finish_if_done(s, defer_free=True)
            if (self.slots[s] is not req
                    and len(req.out_tokens) >= req.max_new_tokens
                    and req.t_done is None):
                # released at dispatch: only the completion time is left
                req.t_done = now
                _obs.lifecycle(req.rid, "done", engine=self.engine_id)

    # -- the KV page wire (inference/fleet/) --------------------------------
    #
    # A KV page is a function of (params, token prefix, page size, quant
    # mode, adapter digest), the argument that makes the prefix cache
    # sound, so replicas of one model can exchange page bytes, and a
    # request resumed through adopted pages emits the stream of an
    # uninterrupted run. A shipment (wire version 2, the reference's) is
    # a dict:
    #
    #   version=2, rid, page_size, kv_quant, dtype, geom=(L, nKV, dH)
    #   hashes  [n]  cumulative prefix-chain hashes (adapter-salted)
    #   k       [n, L, nKV, dH, bs]   numpy, page-major
    #   v       [n, L, nKV, bs, dH]
    #   k_scales/v_scales [n, L, nKV] fp32 (int8 payload only, else None)
    #   crc     [n]  crc32 over each page's k + v (+ scale) bytes
    #   quant_mode "int8" | "fp", tokens [n * bs] int32, salt  (v2 only)
    #   staged  True while the payload is an asynchronous copy (crc None
    #           until finalize_shipment)
    #
    # ``dtype`` is the canonical name ("bfloat16", "float32", "int8");
    # numpy has no bf16, so a bf16 payload travels as a uint16 view of
    # the same bytes (the crcs are over bytes and do not change).
    # Adoption is two-phase so the page ledger is exact while bytes are
    # in transit: begin_adopt allocates and stages (ledger class
    # in_flight), commit_adopt publishes the pages in the prefix cache at
    # refcount 0 and writes their bytes, now (synchronous wire) or at the
    # next dispatch (overlapped), abort_adopt returns staged pages.

    def _export_meta(self, rid: int):
        """The slot serving ``rid``, and for its exportable prefix (the
        tokens the host knows, prompt + harvested out_tokens, that have
        been dispatched into the pool) the tokens, salt, hashes and page
        ids. None for unknown or queued rids or no full page."""
        for slot in range(self.B):
            req = self.slots[slot]
            if req is not None and req.rid == rid:
                break
        else:
            return None
        full = (np.concatenate([np.asarray(req.prompt, np.int32),
                                np.asarray(req.out_tokens, np.int32)])
                if req.out_tokens else np.asarray(req.prompt, np.int32))
        written = (self._prefilling[slot] if slot in self._prefilling
                   else int(self.seq_lens[slot]))
        n_exp = min(written, len(full)) // self.bs
        if n_exp <= 0:
            return None
        tokens = np.ascontiguousarray(full[:n_exp * self.bs], np.int32)
        salt = self._cache_salt(req)
        hashes = self._page_hashes(tokens, salt)
        pg = np.asarray(self._full_rows[slot][:n_exp], np.int32)
        return slot, tokens, salt, hashes, pg

    def _shipment_header(self, rid: int, tokens, salt, hashes) -> dict:
        cfg = self.cfg
        return {"version": 2, "rid": rid, "page_size": self.bs,
                "kv_quant": self._kv_quant,
                "quant_mode": "int8" if self._kv_quant else "fp",
                "dtype": _DTYPE_NAME[self.k_pages.dtype],
                "geom": (cfg.n_layers, cfg.n_kv_heads, cfg.head_dim),
                "hashes": hashes, "tokens": tokens, "salt": salt}

    def _gather_export(self, pg: np.ndarray) -> list:
        """The pages ``pg`` of the k, v (and scale) arrays in shipment
        layout, on the engine's device: gathers enqueued on its stream."""
        pgd = torch.as_tensor(pg, dtype=torch.long).to(self.device)
        arrs = [self.k_pages, self.v_pages]
        if self._kv_quant:
            arrs += [self.k_scales, self.v_scales]
        out = [wire_gather_pages(a, pgd) for a in arrs]
        return out + [None] * (4 - len(out))

    def export_request_pages(self, rid: int) -> Optional[dict]:
        """The synchronous wire: the full KV pages (+ scale planes) a
        resident request has written, on the host, for adoption by
        another engine. Reading them waits for every step enqueued on
        the stream. None for unknown or queued rids or no full page."""
        if self._commit_pending:
            self._flush_commits()
        meta = self._export_meta(rid)
        if meta is None:
            return None
        _slot, tokens, salt, hashes, pg = meta
        k, v, ks, vs = (None if a is None else _to_host(a.cpu())
                        for a in self._gather_export(pg))
        out = self._shipment_header(rid, tokens, salt, hashes)
        out.update({"k": k, "v": v, "k_scales": ks, "v_scales": vs,
                    "crc": [_page_crc(k, v, ks, vs, j)
                            for j in range(len(pg))]})
        return out

    def stage_request_pages(self, rid: int) -> Optional[dict]:
        """The overlapped wire's export: gather the request's pages on
        the engine's stream behind the in-flight step, start their copy
        into pinned host buffers on a side stream that waits for the
        gather, and return at once with ``staged=True`` and ``crc=None``
        (``finalize_shipment`` waits for the copy). The slot's pages may
        be released right after: every later write to them is enqueued
        on the engine's stream behind the gather, and the side stream is
        recorded on the gathered buffers so that the caching allocator
        keeps them until the copy is done."""
        if self._commit_pending:
            self._flush_commits()
        meta = self._export_meta(rid)
        if meta is None:
            return None
        _slot, tokens, salt, hashes, pg = meta
        arrs = self._gather_export(pg)
        done = None
        if self.device.type == "cuda":
            gathered = torch.cuda.Event()
            gathered.record()
            if self._wire_stream is None:
                self._wire_stream = torch.cuda.Stream(self.device)
            side = self._wire_stream
            side.wait_event(gathered)
            host = []
            with torch.cuda.stream(side):
                for a in arrs:
                    if a is None:
                        host.append(None)
                        continue
                    h = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
                    h.copy_(a, non_blocking=True)
                    a.record_stream(side)
                    host.append(h)
                done = torch.cuda.Event()
                done.record(side)
            arrs = host
        k, v, ks, vs = arrs
        out = self._shipment_header(rid, tokens, salt, hashes)
        out.update({"k": k, "v": v, "k_scales": ks, "v_scales": vs,
                    "crc": None, "staged": True, "copied": done})
        return out

    def finalize_shipment(self, shipment: Optional[dict]) -> Optional[dict]:
        """Wait for a staged shipment's copy and compute its crcs (the
        router calls this when it drains the outbox). Chaos point
        ``migration.stage``: ``drop`` loses the staging buffer (the
        request falls back to re-prefill), ``corrupt`` flips a payload
        byte after the crcs are computed, so the adopter rejects the
        page. A shipment that is not staged passes through."""
        if not shipment or not shipment.get("staged"):
            return shipment
        t0 = _clock.now()
        done = shipment.pop("copied", None)
        if done is not None:
            done.synchronize()
        k, v, ks, vs = (None if shipment[n] is None
                        else _to_host(shipment[n])
                        for n in ("k", "v", "k_scales", "v_scales"))
        shipment.update({"k": k, "v": v, "k_scales": ks, "v_scales": vs,
                         "crc": [_page_crc(k, v, ks, vs, j)
                                 for j in range(len(shipment["hashes"]))],
                         "staged": False})
        self.stats["wire_export_ms"] += (_clock.now() - t0) * 1e3
        _obs.instant("wire.finalize", engine=self.engine_id,
                     rid=shipment.get("rid"),
                     pages=len(shipment.get("hashes", [])))
        if _chaos.active():
            ctx = {"engine": self.engine_id}
            if self.pool_role is not None:
                ctx["pool"] = self.pool_role
            spec = _chaos.fire("migration.stage", ctx=ctx)
            if spec is not None:
                if spec.kind == "drop":
                    return None
                if spec.kind == "corrupt":
                    k = np.array(k, copy=True)
                    k.reshape(-1).view(np.uint8)[0] ^= 0xFF
                    shipment["k"] = k
        return shipment

    @staticmethod
    def shipment_bytes(shipment: dict) -> int:
        """Wire bytes of a shipment's payload (an int8 page ships at about
        half a bf16 page's bytes)."""
        n = shipment["k"].nbytes + shipment["v"].nbytes
        if shipment["k_scales"] is not None:
            n += shipment["k_scales"].nbytes + shipment["v_scales"].nbytes
        return int(n)

    def _shipment_quant_mode(self, shipment: dict) -> str:
        """The payload's representation: v2 names it, v1's ``kv_quant``
        decides."""
        qm = shipment.get("quant_mode")
        if qm is not None:
            return qm
        return "int8" if shipment.get("kv_quant") else "fp"

    def shipment_cache_hashes(self, shipment: dict) -> Optional[list]:
        """The hashes a shipment's pages take in THIS pool's cache: its
        own in the same quant mode, else re-keyed from its token prefix
        (the preimage tags int8 content). None when that is impossible
        (a v1 cross-mode shipment)."""
        want = "int8" if self._kv_quant else "fp"
        if self._shipment_quant_mode(shipment) == want:
            return list(shipment["hashes"])
        toks = shipment.get("tokens")
        if toks is None:
            return None
        return self._page_hashes(
            np.asarray(toks, np.int32),
            shipment.get("salt", b""))[:len(shipment["hashes"])]

    def _convert_shipment(self, shipment: dict) -> Optional[dict]:
        """Re-express a v2 shipment of the other quant mode in this
        pool's, re-keyed from its token prefix; bit for bit the
        reference's numpy conversion. int8 -> fp: q * scale in fp32, then
        one rounding to the pool dtype (round to nearest even, bf16 too).
        fp -> int8: a one-shot absmax / 127 per (page, layer, kv head),
        the stored scale unclamped, only the quantizing divide clamped by
        SCALE_EPS. The crcs are checked against the original payload and
        the conversion stops at the first bad page, so a corrupt
        shipment is never re-crc'd clean. None without a token prefix
        (v1)."""
        toks = shipment.get("tokens")
        if toks is None:
            return None
        src_q = self._shipment_quant_mode(shipment) == "int8"
        k, v = shipment["k"], shipment["v"]
        ks, vs = shipment["k_scales"], shipment["v_scales"]
        n_ok = 0
        for j in range(len(shipment["hashes"])):
            if _page_crc(k, v, ks if src_q else None, vs, j) \
                    != shipment["crc"][j]:
                break     # corrupt: pages past j can't extend the chain
            n_ok += 1
        tokens = np.asarray(toks, np.int32)[:n_ok * self.bs]
        hashes = self._page_hashes(tokens, shipment.get("salt", b""))
        dt = self.k_pages.dtype
        if src_q:
            def conv(q, sc):
                return _to_host((_from_host(q[:n_ok], torch.int8).float()
                                 * _from_host(sc[:n_ok], torch.float32)[
                                     :, :, :, None, None]).to(dt))

            kc, vc, ksc, vsc = conv(k, ks), conv(v, vs), None, None
        else:
            src = {"bfloat16": torch.bfloat16, "float16": torch.float16}.get(
                shipment["dtype"], torch.float32)

            def conv(x):
                xf = _from_host(x[:n_ok], src).float()
                sc = xf.abs().amax(dim=(3, 4)) / 127.0
                q = torch.round(xf / torch.clamp_min(
                    sc, SCALE_EPS)[:, :, :, None, None])
                return (q.clamp(-127, 127).to(torch.int8).numpy(),
                        sc.numpy())

            (kc, ksc), (vc, vsc) = conv(k), conv(v)
        out = dict(shipment)
        out.update({"kv_quant": self._kv_quant,
                    "quant_mode": "int8" if self._kv_quant else "fp",
                    "dtype": _DTYPE_NAME[dt], "hashes": hashes,
                    "tokens": tokens, "k": kc, "v": vc, "k_scales": ksc,
                    "v_scales": vsc,
                    "crc": [_page_crc(kc, vc, ksc, vsc, j)
                            for j in range(n_ok)]})
        return out

    def begin_adopt(self, shipment: dict) -> Optional[dict]:
        """Phase 1 of adoption: check the shipment against this pool's
        geometry (ValueError on a mismatch; a v2 shipment of the other
        quant mode converts instead), skip pages whose hash is resident,
        stop at the first page whose crc fails or that cannot be
        allocated, and stage the rest (ledger class ``in_flight``).
        Returns the staging handle, or None when nothing is adoptable or
        chaos ``migration.adopt`` ``fail`` fires."""
        cfg = self.cfg
        if (shipment.get("version") not in (1, 2)
                or shipment["page_size"] != self.bs
                or tuple(shipment["geom"]) != (cfg.n_layers,
                                               cfg.n_kv_heads,
                                               cfg.head_dim)):
            raise ValueError(
                f"shipment geometry {shipment.get('page_size')}/"
                f"{shipment.get('dtype')}/{shipment.get('geom')} does "
                f"not match this pool ({self.bs}/"
                f"{_DTYPE_NAME[self.k_pages.dtype]}/"
                f"{(cfg.n_layers, cfg.n_kv_heads, cfg.head_dim)})")
        want = "int8" if self._kv_quant else "fp"
        if self._shipment_quant_mode(shipment) != want:
            conv = self._convert_shipment(shipment)
            if conv is None:
                raise ValueError(
                    f"shipment quant mode "
                    f"{self._shipment_quant_mode(shipment)} does not "
                    f"match this pool ({want}) and carries no token "
                    f"prefix to re-key from (wire v1)")
            shipment = conv
        elif shipment["dtype"] != _DTYPE_NAME[self.k_pages.dtype]:
            raise ValueError(
                f"shipment dtype {shipment['dtype']} does not match "
                f"this pool ({_DTYPE_NAME[self.k_pages.dtype]})")
        if _chaos.active():
            spec = _chaos.fire("migration.adopt",
                               ctx={"engine": self.engine_id})
            if spec is not None and spec.kind == "fail":
                return None
        k, v = shipment["k"], shipment["v"]
        ks, vs = shipment["k_scales"], shipment["v_scales"]
        staged: list[tuple[int, int]] = []     # (shipment idx, pool page)
        for j, h in enumerate(shipment["hashes"]):
            if _page_crc(k, v, ks if self._kv_quant else None, vs, j) \
                    != shipment["crc"][j]:
                break     # corrupt: pages past j can't extend the chain
            if h in self.pool.cache:
                continue  # already resident; the chain stays contiguous
            pages = self._alloc_pages(1)
            if pages is None:
                break     # adopter full: keep the prefix staged so far
            staged.append((j, pages[0]))
        if not staged:
            return None
        handle = {"shipment": shipment, "staged": staged}
        self._adopting.append(handle)
        return handle

    def commit_adopt(self, handle: dict) -> int:
        """Phase 2: publish the staged pages in the prefix cache at
        refcount 0 (idle-cached, where the victim's re-admission lookup
        finds them) and write their bytes into the pool: now on the
        synchronous wire, at the next dispatch on the overlapped one
        (``_flush_commits``). Chaos ``migration.commit`` ``raise`` fires
        before any state moves. Returns the pages adopted."""
        if _chaos.active():
            ctx = {"engine": self.engine_id}
            if self.pool_role is not None:
                ctx["pool"] = self.pool_role
            spec = _chaos.fire("migration.commit", ctx=ctx)
            if spec is not None and spec.kind == "raise":
                raise _chaos.ChaosInjected(
                    f"chaos: engine {self.engine_id} commit failure")
        self._adopting.remove(handle)
        shipment, staged = handle["shipment"], handle["staged"]
        with _obs.span("wire.commit", engine=self.engine_id,
                       rid=shipment.get("rid"), pages=len(staged)):
            idx = [j for j, _ in staged]
            if idx == list(range(idx[0], idx[0] + len(idx))):
                idx = slice(idx[0], idx[0] + len(idx))   # a view, no copy

            def rows(name):
                a = shipment[name]
                return None if a is None else a[idx]

            ent = {"pages": [p for _, p in staged],
                   "hashes": [shipment["hashes"][j] for j, _ in staged],
                   "k": rows("k"), "v": rows("v"),
                   "ks": rows("k_scales") if self._kv_quant else None,
                   "vs": rows("v_scales") if self._kv_quant else None}
            if self._wire_overlap:
                self._commit_pending.append(ent)
            else:
                self._write_pages(ent["pages"], ent["k"], ent["v"],
                                  ent["ks"], ent["vs"])
            for j, p in staged:
                self.pool.insert(shipment["hashes"][j], p)
            # the pages idle in the cache until a lookup claims them
            self.pool.decref(ent["pages"])
        if shipment.get("rid") is not None:
            _obs.lifecycle(shipment["rid"], "adopt", engine=self.engine_id,
                           pages=len(staged))
        return len(staged)

    def _write_pages(self, pages: list, k, v, ks, vs) -> None:
        """Write page-major host payloads into the pool at ``pages``: one
        host-to-device copy per array and an ``index_copy_`` on the page
        dimension, enqueued on the engine's stream."""
        pg = torch.as_tensor(pages, dtype=torch.long).to(self.device)
        for pool, host, dt in ((self.k_pages, k, self.k_pages.dtype),
                               (self.v_pages, v, self.v_pages.dtype),
                               (self.k_scales, ks, torch.float32),
                               (self.v_scales, vs, torch.float32)):
            if host is not None:
                wire_scatter_pages(pool, pg, _from_host(host, dt).to(
                    self.device).movedim(0, 1))

    def _flush_commits(self) -> None:
        """Write every deferred adoption commit (overlapped wire) in one
        batch: at dispatch entry, before a step can attend the pages, and
        at export entry, before their bytes can ship again. A page whose
        cache entry no longer carries its commit's hash was evicted (and
        maybe handed out) since the commit; it is skipped, or it would
        clobber the new tenant's bytes and freshly zeroed scales."""
        pend, self._commit_pending = self._commit_pending, []
        pages: list[int] = []
        parts: list[list] = [[], [], [], []]
        for ent in pend:
            keep = [i for i, (p, h) in enumerate(zip(ent["pages"],
                                                     ent["hashes"]))
                    if self.pool.hash_of.get(p) == h]
            if not keep:
                continue
            pages += [ent["pages"][i] for i in keep]
            for lst, name in zip(parts, ("k", "v", "ks", "vs")):
                if ent[name] is not None:
                    lst.append(ent[name][keep])
        if pages:
            self._write_pages(pages, *(np.concatenate(lst) if lst else None
                                       for lst in parts))

    def abort_adopt(self, handle: dict) -> None:
        """Roll back a staged adoption: its pages return to the free list
        (nothing was published or written)."""
        self._adopting.remove(handle)
        self.pool.release([p for _, p in handle["staged"]])

    def adopt_pages(self, shipment: dict) -> int:
        """begin_adopt + commit_adopt (the router's path); the pages
        adopted, 0 when nothing was adoptable. A commit that raises
        (chaos ``migration.commit``) aborts the staging leak-free and
        reports 0: the wire counts a rejection."""
        handle = self.begin_adopt(shipment)
        if handle is None:
            return 0
        try:
            return self.commit_adopt(handle)
        except Exception:
            self.abort_adopt(handle)
            return 0

    def kv_bytes_per_page(self) -> float:
        """Device bytes one KV page costs across all layers, with its
        share of the scale planes under serving_kv_quant."""
        cfg = self.cfg
        L, nKV = cfg.n_layers, cfg.n_kv_heads
        per = L * nKV * cfg.head_dim * self.bs * (
            self.k_pages.element_size() + self.v_pages.element_size())
        if self._kv_quant:
            per += 2 * L * nKV * self.k_scales.element_size()
        return float(per)

    def kv_bytes_per_token(self) -> float:
        return self.kv_bytes_per_page() / self.bs

    def page_accounting(self) -> dict:
        """Page census for the leak invariant: every non-sink page is in
        exactly one of free / slot-owned / slot-shared (deduplicated) /
        idle-cached (refcount 0, including pages adopted on the
        overlapped wire whose bytes land at the next dispatch) /
        deferred-free / adapter (resident LoRA weights) / in-flight
        (pages staged by begin_adopt, not yet committed or rolled back);
        the counts sum to n_pages - 1, per engine and so fleet-wide."""
        owned = [p for lst in self._slot_owned for p in lst]
        shared = {p for lst in self._slot_shared for p in lst}
        counts = {
            "free": len(self.pool.free),
            "slot_owned": len(owned),
            "slot_shared": len(shared),
            "cache_idle": sum(1 for r in self.pool.ref.values() if r == 0),
            "deferred_free": len(self._deferred_free),
            "adapter": (self.adapters.n_pages_held()
                        if self.adapters is not None else 0),
            "in_flight": sum(len(h["staged"]) for h in self._adopting),
        }
        counts["total"] = sum(counts.values())
        return counts

    def run(self, requests: list[Request]) -> dict:
        """Drive all requests to completion against wall-clock arrivals;
        returns throughput, latency percentiles, the slot-occupancy
        decomposition, the speculative, preemption, adapter and
        prefix-cache counters. As the reference's, it reads none of the
        fleet's request fields (``deadline_ttft``, ``deadline_e2e``,
        ``session``, ``param_version``): deadlines are the load
        generator's driver's to enforce, the rest the router's."""
        for r in sorted(requests, key=lambda r: r.arrival):
            self.submit(r)
        self.stats = {k: 0 for k in self.stats}   # per-run counters
        hits0, misses0 = self.pool.hits, self.pool.misses
        t0 = _clock.now()
        while (any(s is not None for s in self.slots) or self.queue
               or self._inflight is not None):
            self.step(now=_clock.now() - t0)
            if not any(s is not None for s in self.slots) \
                    and self._inflight is None and self.queue:
                # next arrival is in the future: sleep, don't spin
                nxt = min(r.arrival for r in self.queue)
                wait = max(0.0, nxt - (_clock.now() - t0))
                time.sleep(min(max(wait, 0.001), 0.05))
        wall = _clock.now() - t0
        if self._deferred_free or self.pool.pending_evict:
            self.pool.release(self._deferred_free)
            self._deferred_free = []
            self.pool.commit_evictable()
        done = [r for r in requests if not r.aborted]
        lat = [r.t_done - (t0 + r.arrival) for r in done
               if r.t_done is not None]
        ttft = [r.t_first - (t0 + r.arrival) for r in done
                if r.t_first is not None]
        total_new = sum(len(r.out_tokens) for r in requests)
        hits = self.pool.hits - hits0
        misses = self.pool.misses - misses0
        st = self.stats
        slot_tok = max(1, st["decode_slot_tokens"])

        def q(xs, p):
            return float(np.percentile(np.asarray(xs), p)) if xs else 0.0

        return {
            "n_requests": len(requests),
            "total_new_tokens": total_new,
            "wall_s": wall,
            "throughput_tok_s": total_new / wall,
            "latency_p50_s": q(lat, 50),
            "latency_p99_s": q(lat, 99),
            "ttft_p50_s": q(ttft, 50),
            "ttft_p99_s": q(ttft, 99),
            "slot_occupancy": st["decode_active_tokens"] / slot_tok,
            "prefill_padding_frac": 1.0 - st["prefill_tokens"]
            / max(1, st["prefill_grid_tokens"]),
            "preemption_rate": st["preemptions"] / max(1, len(requests)),
            "spec_accept_rate": (st["spec_accepted_tokens"]
                                 / st["spec_proposed_tokens"]
                                 if st["spec_proposed_tokens"] else 0.0),
            "prefix_cache_hit_rate": hits / (hits + misses)
            if hits + misses else 0.0,
            "prefix_cache_hits": hits,
            "prefix_cache_misses": misses,
            **(self.adapters.stats() if self.adapters is not None else {}),
            **st,
        }
