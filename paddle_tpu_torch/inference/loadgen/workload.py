"""Workload synthesis: seeded request mixes for the open-loop driver.

A spec pins everything the scheduler is sensitive to — arrival process,
shared-prefix structure (exercises the prefix cache and page refcounts),
long-tail prompt lengths (exercises chunked prefill packing and the
admission skip/aging path), output lengths, and the sampled/greedy mix
(sampled rows exercise the in-program top-p path) — behind one seed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..serving import Request
from .arrivals import burst_arrivals, gamma_arrivals, poisson_arrivals

__all__ = ["WorkloadSpec", "synthesize"]


@dataclasses.dataclass
class WorkloadSpec:
    """One reproducible traffic mix. Lengths are token counts."""

    n_requests: int = 256
    seed: int = 0
    vocab_size: int = 32000
    # arrival process: "poisson" | "gamma" | "burst"
    process: str = "poisson"
    rate: float = 10.0                   # mean req/s
    cv: float = 2.0                      # gamma only
    burst_size: int = 8                  # burst only
    # shared prefixes: ``shared_frac`` of requests start with one of
    # ``n_prefixes`` fixed prefixes of ``prefix_len`` tokens (system
    # prompts); the rest are fully random
    n_prefixes: int = 2
    prefix_len: int = 0                  # 0 disables sharing
    shared_frac: float = 0.7
    # long-tail tail lengths: lognormal(mean of log, sigma) clamped to
    # [tail_min, tail_max] — a heavy right tail, the realistic shape
    tail_log_mean: float = 4.0           # exp(4) ~ 55 tokens median
    tail_log_sigma: float = 0.8
    tail_min: int = 4
    tail_max: int = 512
    # output lengths: uniform in [new_min, new_max]
    new_min: int = 16
    new_max: int = 96
    # sampling mix
    sampled_frac: float = 0.0
    temperature: float = 0.8
    top_p: float = 0.9
    max_seq: Optional[int] = None        # clamp prompt+new when set
    # multi-tenant knobs (inference/multitenant/): all default off. The
    # fields draw from a SEPARATE RandomState keyed off the seed, so a
    # single-tenant stream (all knobs 0) is byte-identical to the one
    # without them for the same seed, and even with the knobs on,
    # prompts, arrivals and sampling are unchanged
    n_tenants: int = 0                   # round-robin tenant ids
    n_adapters: int = 0                  # adapter pool size ("a<j>")
    adapter_frac: float = 0.5            # P(request carries an adapter)
    priority_levels: int = 0             # uniform priority in [0, levels)
    constrained_frac: float = 0.0        # P(request names a schema)
    n_schemas: int = 1                   # schema pool size ("s<j>")
    # fleet knobs (inference/fleet/): all default off, decorated from a
    # THIRD RandomState after the multi-tenant pass — legacy and
    # multi-tenant streams stay byte-identical (same convention as
    # above). Deadlines are constant per-request budgets in seconds
    # from arrival (0 = none); tenant_skew > 0 replaces the round-robin
    # tenant assignment with a Zipf-ish draw (weight of tenant t is
    # 1/(t+1)^skew) — the skewed mix a real fleet sees; n_sessions > 0
    # tags requests with session keys for router affinity.
    deadline_ttft: float = 0.0
    deadline_e2e: float = 0.0
    tenant_skew: float = 0.0
    n_sessions: int = 0
    # disaggregation knob (inference/fleet/ pool split): a FOURTH
    # stream, same convention — earlier streams stay byte-identical.
    # prefill_heavy_frac > 0 re-shapes that fraction of requests into
    # the long-prompt/short-output mix where prefill/decode
    # interference is worst (the DistServe argument): the prompt is
    # extended by prefill_heavy_len fresh tokens and the output clamped
    # to new_min.
    prefill_heavy_frac: float = 0.0
    prefill_heavy_len: int = 256
    # phase-imbalance knob (dynamic pool splitting): a FIFTH stream,
    # same convention — earlier streams stay byte-identical. When
    # phase_imbalance > 0, requests alternate by arrival epoch
    # (floor(arrival / phase_epoch_s)): even epochs are prefill-heavy
    # (prompt extended by phase_imbalance_len fresh tokens, output
    # clamped to new_min), odd epochs decode-heavy (output raised
    # toward new_max * phase_imbalance). The drifting mix is what the
    # measured-load split controller (serving_disagg_dynamic) exists
    # to chase.
    phase_imbalance: float = 0.0
    phase_epoch_s: float = 2.0
    phase_imbalance_len: int = 192


def synthesize(spec: WorkloadSpec) -> list[Request]:
    """Materialize the spec into arrival-stamped Requests (rid = arrival
    order)."""
    rng = np.random.RandomState(spec.seed)
    n = spec.n_requests
    if spec.process == "poisson":
        arrivals = poisson_arrivals(spec.rate, n, spec.seed)
    elif spec.process == "gamma":
        arrivals = gamma_arrivals(spec.rate, spec.cv, n, spec.seed)
    elif spec.process == "burst":
        arrivals = burst_arrivals(spec.rate, n, spec.seed,
                                  burst_size=spec.burst_size)
    else:
        raise ValueError(f"unknown arrival process '{spec.process}'")
    prefixes = [rng.randint(1, spec.vocab_size,
                            size=spec.prefix_len).astype(np.int32)
                for _ in range(spec.n_prefixes)] if spec.prefix_len else []
    reqs = []
    for i in range(n):
        tail_len = int(np.clip(
            np.round(rng.lognormal(spec.tail_log_mean,
                                   spec.tail_log_sigma)),
            spec.tail_min, spec.tail_max))
        tail = rng.randint(1, spec.vocab_size,
                           size=tail_len).astype(np.int32)
        if prefixes and rng.rand() < spec.shared_frac:
            prompt = np.concatenate([prefixes[rng.randint(
                len(prefixes))], tail])
        else:
            prompt = tail
        max_new = int(rng.randint(spec.new_min, spec.new_max + 1))
        if spec.max_seq is not None:
            # clamp to engine capacity: trim the tail first, then new
            over = len(prompt) + max_new - spec.max_seq
            if over > 0:
                keep = max(spec.tail_min, len(prompt) - over)
                prompt = prompt[:keep]
                max_new = min(max_new, spec.max_seq - len(prompt))
        kw = {}
        if rng.rand() < spec.sampled_frac:
            kw = dict(temperature=spec.temperature, top_p=spec.top_p,
                      seed=int(rng.randint(1 << 30)))
        reqs.append(Request(rid=i, prompt=prompt, max_new_tokens=max_new,
                            arrival=float(arrivals[i]), **kw))
    if (spec.n_tenants or spec.n_adapters or spec.priority_levels
            or spec.constrained_frac):
        # multi-tenant decoration AFTER the legacy draw sequence, from
        # its own stream: the legacy fields above stay byte-identical
        rng2 = np.random.RandomState((spec.seed + 0x517A) % (1 << 32))
        for i, r in enumerate(reqs):
            if spec.n_tenants:
                r.tenant = i % spec.n_tenants
            if spec.priority_levels:
                r.priority = int(rng2.randint(spec.priority_levels))
            if spec.n_adapters and rng2.rand() < spec.adapter_frac:
                r.adapter_id = "a%d" % rng2.randint(spec.n_adapters)
            if spec.constrained_frac and rng2.rand() < spec.constrained_frac:
                r.schema_id = "s%d" % rng2.randint(max(1, spec.n_schemas))
    if (spec.deadline_ttft or spec.deadline_e2e or spec.n_sessions
            or (spec.tenant_skew and spec.n_tenants)):
        # fleet decoration, third stream: earlier draws untouched
        rng3 = np.random.RandomState((spec.seed + 0xF1EE7) % (1 << 32))
        if spec.tenant_skew and spec.n_tenants:
            w = 1.0 / np.arange(1, spec.n_tenants + 1) ** spec.tenant_skew
            w /= w.sum()
        for r in reqs:
            if spec.deadline_ttft:
                r.deadline_ttft = spec.deadline_ttft
            if spec.deadline_e2e:
                r.deadline_e2e = spec.deadline_e2e
            if spec.tenant_skew and spec.n_tenants:
                r.tenant = int(rng3.choice(spec.n_tenants, p=w))
            if spec.n_sessions:
                r.session = "sess%d" % rng3.randint(spec.n_sessions)
    if spec.prefill_heavy_frac:
        # disaggregation decoration, fourth stream: earlier draws
        # untouched; clamping respects max_seq like the legacy path
        rng4 = np.random.RandomState((spec.seed + 0xD15A6) % (1 << 32))
        for r in reqs:
            if rng4.rand() >= spec.prefill_heavy_frac:
                continue
            extra = rng4.randint(1, spec.vocab_size,
                                 size=spec.prefill_heavy_len)
            r.prompt = np.concatenate(
                [np.asarray(r.prompt, np.int32),
                 extra.astype(np.int32)])
            r.max_new_tokens = max(1, min(r.max_new_tokens,
                                          spec.new_min))
            if spec.max_seq is not None:
                over = len(r.prompt) + r.max_new_tokens - spec.max_seq
                if over > 0:
                    r.prompt = r.prompt[:len(r.prompt) - over]
    if spec.phase_imbalance:
        # phase-imbalance decoration, fifth stream: earlier draws
        # untouched. Epoch parity comes from the (already final)
        # arrival stamp, so the alternation is a property of wall
        # time, not of request index.
        rng5 = np.random.RandomState((spec.seed + 0x9A5E) % (1 << 32))
        ep = max(spec.phase_epoch_s, 1e-9)
        for r in reqs:
            if rng5.rand() >= spec.phase_imbalance:
                continue
            if int(r.arrival // ep) % 2 == 0:
                extra = rng5.randint(1, spec.vocab_size,
                                     size=spec.phase_imbalance_len)
                r.prompt = np.concatenate(
                    [np.asarray(r.prompt, np.int32),
                     extra.astype(np.int32)])
                r.max_new_tokens = max(1, min(r.max_new_tokens,
                                              spec.new_min))
            else:
                r.max_new_tokens = max(
                    r.max_new_tokens,
                    int(round(spec.new_max * spec.phase_imbalance)))
            if spec.max_seq is not None:
                over = len(r.prompt) + r.max_new_tokens - spec.max_seq
                if over > 0:
                    keep = max(1, len(r.prompt) - over)
                    r.prompt = r.prompt[:keep]
                    r.max_new_tokens = min(
                        r.max_new_tokens,
                        max(1, spec.max_seq - len(r.prompt)))
    return reqs
