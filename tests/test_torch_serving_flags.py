"""The port's serving engine with its five flag-gated paths against the
JAX reference engine on the CPU: int8 KV pages (``kv_quant``),
speculative decode (``speculative_k``), LoRA adapters (``lora``),
priority preemption (``priorities``) and constrained decoding
(``constrained``), alone and combined as the reference's own tests
combine them.

At the tiny fp32 config of tests/test_torch_serving.py, fed the same
weights, adapters and requests (greedy and sampled), the two engines
give identical token streams, page ledgers and counters. After an int8
run the port's int8 pages are within one int8 step of the reference's
and its scale planes within rtol 1e-6 (the absmax, the scales and the
divides are the same fp32 expressions; only the summation order of the
projections differs). The reference's output is the oracle."""

import string

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.inference.multitenant import json_schema_dfa as jax_dfa
from paddle_tpu.inference.multitenant import make_lora as jax_make_lora
from paddle_tpu.inference.serving import Request as JRequest
from paddle_tpu.inference.serving import ServingEngine as JEngine
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu.models.llama import init_llama_params as jax_init
from paddle_tpu_torch.inference.multitenant import (TokenDfa,
                                                    json_schema_dfa,
                                                    make_lora)
from paddle_tpu_torch.inference.serving import Request, ServingEngine
from paddle_tpu_torch.models.llama import LlamaConfig
from paddle_tpu_torch.utils.convert import params_from_jax

SHAPE = dict(vocab_size=512, hidden=128, n_layers=2, n_heads=8,
             n_kv_heads=4, ffn_hidden=256, max_seq_len=256)
JCFG = JConfig(**SHAPE, dtype=jnp.float32, param_dtype=jnp.float32)
TCFG = LlamaConfig(**SHAPE, dtype=torch.float32, param_dtype=torch.float32)
ENGINE = dict(max_batch=2, page_size=16, max_seq=256, prefill_budget=64)

VOCAB = [""] * 512
for _i, _ch in enumerate(string.printable[:94]):
    VOCAB[_i + 1] = _ch
SCHEMA = {"enum": ["cat", "car", "dog"]}


@pytest.fixture(scope="module")
def weights():
    params = jax_init(JCFG, jax.random.PRNGKey(0))
    return params, params_from_jax(jax.tree.map(np.asarray, params), "cpu")


def _engines(weights, adapters=(), schema=False, **kw):
    """The reference engine and the port's on the same weights, each
    with the same adapters and schema registered."""
    kw = {**ENGINE, **kw}
    jeng = JEngine(JCFG, params=weights[0], **kw)
    teng = ServingEngine(TCFG, params=weights[1], device="cpu", **kw)
    for name, seed in adapters:
        jeng.register_adapter(name, jax_make_lora(JCFG, 8, seed=seed,
                                                  scale=0.3))
        teng.register_adapter(name, make_lora(TCFG, 8, seed=seed,
                                              scale=0.3))
    if schema:
        jeng.register_schema("s", jax_dfa(SCHEMA, VOCAB).fresh)
        teng.register_schema("s", json_schema_dfa(SCHEMA, VOCAB).fresh)
    return jeng, teng


def _requests(cls, seed=5, n=6, adapters=(), schema=False, prio=False):
    """A shared 40-token prefix on even rids, a repeated 6-token pattern
    (the n-gram proposer's food) on odd ones; sampled on rids not a
    multiple of 3; adapters, a schema and priorities by rid."""
    rng = np.random.RandomState(seed)
    shared = rng.randint(1, 512, size=40).astype(np.int32)
    pat = rng.randint(1, 512, size=6).astype(np.int32)
    out = []
    for i in range(n):
        tail = rng.randint(1, 512, size=rng.randint(3, 30)).astype(np.int32)
        prompt = (np.concatenate([shared, tail]) if i % 2 == 0
                  else np.tile(pat, rng.randint(2, 6)))
        kw = dict(temperature=0.9, top_p=0.85, seed=10 + i) if i % 3 else {}
        if adapters and i % 3 != 2:
            kw["adapter_id"] = adapters[i % len(adapters)]
        if schema and i % 2:
            kw["schema_id"] = "s"
        if prio:
            # later arrivals rank higher: residents get preempted
            kw.update(priority=i % 3, arrival=0.004 * i)
        out.append(cls(rid=i, prompt=prompt,
                       max_new_tokens=int(rng.randint(4, 12)), **kw))
    return out


def _assert_same(jeng, teng, jreq, treq):
    for a, b in zip(jreq, treq):
        assert len(b.out_tokens) == b.max_new_tokens, b.rid
        assert a.out_tokens == b.out_tokens, a.rid
    tacc = teng.page_accounting()
    assert tacc["total"] == teng.n_pages - 1
    assert teng.page_accounting() == jeng.page_accounting()
    for k in teng.stats:
        assert jeng.stats[k] == teng.stats[k], k


def _step_both(jeng, teng, jreq, treq, tick=0.002):
    """Submit and step both engines in lockstep on one clock of ``tick``
    seconds per step (the wall clock would give each its own schedule),
    the ledgers equal after every step."""
    for eng, reqs in ((jeng, jreq), (teng, treq)):
        for r in sorted(reqs, key=lambda r: r.arrival):
            eng.submit(r)
    n = 0
    while True:
        more_j, more_t = jeng.step(now=tick * n), teng.step(now=tick * n)
        assert more_j == more_t
        if not more_t:
            break
        n += 1
        assert teng.page_accounting() == jeng.page_accounting(), n
        assert n < 500


def _run_both(weights, req_kw=None, adapters=(), schema=False, **kw):
    """Both engines on the same requests: run() unless the requests
    arrive over time (priorities), then stepped in lockstep."""
    jeng, teng = _engines(weights, adapters, schema, **kw)
    names = tuple(a for a, _ in adapters)
    req_kw = dict(req_kw or {}, adapters=names, schema=schema)
    jreq, treq = _requests(JRequest, **req_kw), _requests(Request, **req_kw)
    if req_kw.get("prio"):
        _step_both(jeng, teng, jreq, treq)
        jstats, tstats = jeng.stats, teng.stats
    else:
        jstats, tstats = jeng.run(jreq), teng.run(treq)
    _assert_same(jeng, teng, jreq, treq)
    for k in ("prefix_cache_hits", "prefix_cache_misses", "preemptions",
              "spec_accepted_tokens", "spec_proposed_tokens",
              "total_new_tokens", "adapter_hits", "adapter_misses",
              "adapter_evictions", "adapter_pages"):
        assert jstats.get(k) == tstats.get(k), k
    return jeng, teng, tstats


def test_kv_quant_equals_reference(weights):
    """Streams, ledger and counters equal; int8 pages within one step,
    scale planes within rtol 1e-6; half the fp32 pool's bytes per token
    or less. The sink page (page 0) is left out: every padding token
    writes there, several to one offset, and which of those writes lands
    last is the scatter's own order."""
    jeng, teng, _ = _run_both(weights, kv_quant=True)
    assert teng.k_pages.dtype == torch.int8
    assert teng.k_scales.shape == (TCFG.n_layers, teng.n_pages,
                                   TCFG.n_kv_heads)
    for jp, tp in ((jeng.k_pages, teng.k_pages),
                   (jeng.v_pages, teng.v_pages)):
        diff = np.abs(np.asarray(jp).astype(np.int32)
                      - tp.numpy().astype(np.int32))
        assert diff[:, 1:].max() <= 1
    for js, ts in ((jeng.k_scales, teng.k_scales),
                   (jeng.v_scales, teng.v_scales)):
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6,
                                   atol=0)
    assert teng.kv_bytes_per_token() == jeng.kv_bytes_per_token()
    assert teng.kv_bytes_per_token() * 2 <= ServingEngine(
        TCFG, device="cpu", **ENGINE).kv_bytes_per_token()


@pytest.mark.parametrize("kv_quant", [False, True])
def test_speculative_equals_reference(weights, kv_quant):
    """Greedy-verify accept and rollback, int8 pages or fp; drafts fire
    on the repeated prompts."""
    _, _, st = _run_both(weights, req_kw=dict(seed=6), speculative_k=3,
                         kv_quant=kv_quant)
    assert st["spec_proposed_tokens"] > 0
    assert st["spec_accepted_tokens"] > 0


def test_lora_equals_reference(weights):
    """Two adapters with 2 device slots and requests without one: the
    q/v deltas, adapter residency and the adapter ledger class."""
    _, teng, st = _run_both(weights, adapters=(("a0", 1), ("a1", 2)),
                            lora=True, lora_slots=2)
    assert teng.adapters.n_resident() >= 1 and st["adapter_pages"] > 0


def test_priorities_equal_reference(weights):
    """A tight pool with three priority classes: admission order and
    preemption equal the reference's."""
    _, _, st = _run_both(weights, req_kw=dict(prio=True), priorities=True,
                         n_pages=9, max_batch=3)
    assert st["preemptions"] >= 1


def test_constrained_equals_reference(weights):
    """Schema-constrained rows, greedy and sampled: the mask before the
    sampler and the DFA advance at harvest."""
    _run_both(weights, schema=True, constrained=True)


def test_all_multitenant_axes_on_int8(weights):
    """LoRA + priorities + constrained on one tight int8 pool."""
    _run_both(weights, req_kw=dict(prio=True, n=8),
              adapters=(("a0", 1), ("a1", 2)), schema=True, lora=True,
              lora_slots=2, priorities=True, constrained=True,
              kv_quant=True, n_pages=13, max_batch=3)


def test_spec_abort_ledger_on_int8_equals_reference(weights):
    """The reference's randomized speculation + abort load on int8 pages
    (tests/test_serving_unified.py): both engines stepped side by side,
    the ledgers equal after every step, the occupancy ledger closed."""
    kw = dict(max_batch=3, page_size=16, max_seq=128, n_pages=15,
              prefill_budget=32, qb=8, speculative_k=3, kv_quant=True)
    jeng = JEngine(JCFG, params=weights[0], **kw)
    teng = ServingEngine(TCFG, params=weights[1], device="cpu", **kw)
    reqs = {}
    for name, eng, cls in (("j", jeng, JRequest), ("t", teng, Request)):
        rng = np.random.RandomState(23)
        pat = rng.randint(1, 512, size=5).astype(np.int32)
        reqs[name] = []
        for i in range(9):
            if rng.rand() < 0.5:
                prompt = np.tile(pat, rng.randint(2, 6))
            else:
                prompt = rng.randint(1, 512, size=rng.randint(4, 40)).astype(
                    np.int32)
            r = cls(rid=i, prompt=prompt,
                    max_new_tokens=int(rng.randint(3, 12)),
                    temperature=float(rng.rand() < 0.3) * 0.8, seed=i)
            reqs[name].append(r)
            eng.submit(r)
    aborts = {3: 2, 8: 5}
    steps = 0
    while True:
        more_j, more_t = jeng.step(now=1e9), teng.step(now=1e9)
        assert more_j == more_t
        if not more_t:
            break
        steps += 1
        if steps in aborts:
            assert jeng.abort(aborts[steps]) == teng.abort(aborts[steps])
        assert teng.page_accounting() == jeng.page_accounting(), steps
        assert teng.page_accounting()["total"] == teng.n_pages - 1
        assert steps < 500
    for a, b in zip(reqs["j"], reqs["t"]):
        assert a.out_tokens == b.out_tokens and a.aborted == b.aborted
    st = teng.stats
    assert st == {k: jeng.stats[k] for k in st}
    assert st["decode_slot_tokens"] == (
        st["decode_active_tokens"] + st["waste_prefill_slot_tokens"]
        + st["waste_queue_empty_slot_tokens"]
        + st["waste_admission_blocked_slot_tokens"]
        + st["waste_overrun_slot_tokens"]
        + st["waste_spec_rejected_slot_tokens"])
    assert not teng.queue and all(s is None for s in teng.slots)


@pytest.mark.parametrize("sampled", [False, True])
def test_preempt_resume_equals_reference_and_solo(weights, sampled):
    """The reference's preempt-resume case (tests/test_multitenant.py):
    a high-priority arrival evicts a low-priority resident on a 9-page
    pool; the port's streams equal the reference's, and each victim's
    stream equals its uninterrupted solo run."""
    rng = np.random.RandomState(2)
    lows = [rng.randint(1, 512, size=30).astype(np.int32) for _ in range(2)]
    hi = rng.randint(1, 512, size=30).astype(np.int32)
    samp = dict(temperature=0.9, top_p=0.85, seed=77) if sampled else {}

    def reqs(cls):
        return [cls(rid=0, prompt=lows[0], max_new_tokens=16, **samp),
                cls(rid=1, prompt=lows[1], max_new_tokens=16),
                cls(rid=2, prompt=hi, max_new_tokens=8, priority=5,
                    arrival=0.001)]

    jeng, teng = _engines(weights, max_batch=4, n_pages=9, priorities=True)
    jr, tr = reqs(JRequest), reqs(Request)
    _step_both(jeng, teng, jr, tr)
    _assert_same(jeng, teng, jr, tr)
    victims = [r for r in tr if r.n_preempted]
    assert victims and teng.stats["preemptions"] >= 1
    for v in victims:
        solo = Request(rid=9, prompt=v.prompt.copy(),
                       max_new_tokens=v.max_new_tokens,
                       temperature=v.temperature, top_p=v.top_p, seed=v.seed)
        ServingEngine(TCFG, params=weights[1], device="cpu",
                      **{**ENGINE, "max_batch": 4, "n_pages": 9}).run([solo])
        assert solo.out_tokens == v.out_tokens


def test_cache_salts_isolate_pages(weights):
    """The ``:kvq8`` tag and the ``lora:`` salt: int8 and fp page hashes
    never alias, nor do two adapters' or an adapter's and none; equal to
    the reference's hashes."""
    toks = np.arange(2 * 16, dtype=np.int32)
    engs = {}
    for name, kw in (("fp", {}), ("q8", dict(kv_quant=True)),
                     ("lora", dict(lora=True))):
        engs[name] = _engines(weights, (("a0", 1), ("a1", 2))
                              if name == "lora" else (), **kw)
    hashes = set()
    for name, (jeng, teng) in engs.items():
        salts = [b""]
        if name == "lora":
            salts += [teng._cache_salt(Request(rid=0, prompt=toks,
                                               max_new_tokens=1,
                                               adapter_id=a))
                      for a in ("a0", "a1")]
            assert salts[1] == jeng._cache_salt(JRequest(
                rid=0, prompt=toks, max_new_tokens=1, adapter_id="a0"))
        for salt in salts:
            got = teng._page_hashes(toks, salt)
            assert got == jeng._page_hashes(toks, salt)
            if name != "lora" or salt:
                assert not hashes & set(got)
                hashes |= set(got)
    # the same adapter's prefix is shared: a warm int8 LoRA engine hits
    jeng, teng = _engines(weights, (("a0", 1),), lora=True, kv_quant=True,
                          max_batch=1)
    p0 = np.random.RandomState(1).randint(1, 512, size=40).astype(np.int32)
    for eng, cls in ((jeng, JRequest), (teng, Request)):
        eng.run([cls(rid=0, prompt=p0, max_new_tokens=4, adapter_id="a0"),
                 cls(rid=1, prompt=p0.copy(), max_new_tokens=4,
                     adapter_id="a0", arrival=0.001)])
    assert teng.pool.hits == jeng.pool.hits > 0


def test_validation_and_constrained_spec_conflict(weights):
    eng = ServingEngine(TCFG, device="cpu", **ENGINE)
    with pytest.raises(ValueError, match="serving_constrained is off"):
        eng.submit(Request(rid=0, prompt=np.ones(4, np.int32),
                           max_new_tokens=2, schema_id="s"))
    with pytest.raises(ValueError, match="serving_lora is off"):
        eng.submit(Request(rid=0, prompt=np.ones(4, np.int32),
                           max_new_tokens=2, adapter_id="a"))
    with pytest.raises(RuntimeError, match="serving_lora"):
        eng.register_adapter("a", make_lora(TCFG, 8, seed=1))
    engc = ServingEngine(TCFG, device="cpu", constrained=True, **ENGINE)
    with pytest.raises(ValueError, match="unknown schema"):
        engc.submit(Request(rid=0, prompt=np.ones(4, np.int32),
                            max_new_tokens=2, schema_id="nope"))
    with pytest.raises(ValueError, match="vocab"):
        engc.submit(Request(rid=0, prompt=np.ones(4, np.int32),
                            max_new_tokens=2,
                            constraint=TokenDfa(np.zeros((2, 7),
                                                         np.int32)).fresh()))
    with pytest.raises(ValueError, match="incompatible"):
        ServingEngine(TCFG, device="cpu", constrained=True, speculative_k=2,
                      **ENGINE)


def test_constraint_dfa_and_proposer_equal_reference():
    """The port's copies of the pure-numpy modules: the schema compiler's
    tables and the n-gram proposer's drafts equal the reference's."""
    from paddle_tpu.inference.speculative import NgramProposer as JProp
    from paddle_tpu_torch.inference.speculative import NgramProposer

    for schema in (SCHEMA, {"type": "boolean"},
                   {"type": "integer", "minimum": 10, "maximum": 12}):
        np.testing.assert_array_equal(json_schema_dfa(schema, VOCAB).trans,
                                      jax_dfa(schema, VOCAB).trans)
    rng = np.random.RandomState(0)
    for _ in range(50):
        hist = rng.randint(0, 6, size=rng.randint(0, 30)).tolist()
        k = int(rng.randint(0, 5))
        assert NgramProposer(3).propose(hist, k) == JProp(3).propose(hist, k)
    for name, w in make_lora(TCFG, 8, seed=3).items():
        np.testing.assert_array_equal(w, jax_make_lora(JCFG, 8, seed=3)[name])
