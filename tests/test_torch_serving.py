"""The PyTorch port's serving engine against the JAX reference engine.

``_pick_tokens`` equals the reference's on the same logits, greedy and
sampled (the Gumbel noise is bit-equal). At the tiny fp32 config of
tests/test_serving_unified.py the port's ``ServingEngine(device="cpu")``
and the reference engine, fed the same weights and requests (greedy and
sampled, a shared prefix, more requests than slots), give identical token
streams, page ledgers and counters, for fp and weight-only int8 weights.
The reference's own output is the oracle (not ``LlamaForCausalLM``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.inference.serving import Request as JRequest
from paddle_tpu.inference.serving import ServingEngine as JEngine
from paddle_tpu.inference.serving import _pick_tokens as jax_pick
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu.models.llama import init_llama_params as jax_init
from paddle_tpu_torch.core.flags import GLOBAL_FLAGS
from paddle_tpu_torch.inference.serving import Request, ServingEngine
from paddle_tpu_torch.inference.serving import _pick_tokens
from paddle_tpu_torch.models.llama import LlamaConfig
from paddle_tpu_torch.utils.convert import params_from_jax

SHAPE = dict(vocab_size=512, hidden=128, n_layers=2, n_heads=8,
             n_kv_heads=4, ffn_hidden=256, max_seq_len=256)
JCFG = JConfig(**SHAPE, dtype=jnp.float32, param_dtype=jnp.float32)
TCFG = LlamaConfig(**SHAPE, dtype=torch.float32, param_dtype=torch.float32)
ENGINE = dict(max_batch=2, page_size=16, max_seq=256, prefill_budget=64)


def test_pick_tokens_greedy_and_sampled_equal():
    rng = np.random.RandomState(0)
    N, V = 6, 512
    logits = (rng.standard_normal((N, V)) * 3).astype(np.float32)
    temps = np.array([0, 0.9, 0.5, 0, 1.3, 0.9], np.float32)
    topps = np.array([1, 0.85, 1.0, 0.5, 0.3, 0.99], np.float32)
    seeds = np.array([0, 11, 12, 13, 14, 15], np.int32)
    pos = np.array([0, 5, 77, 3, 1000, 41], np.int32)
    for t in (temps, np.zeros_like(temps)):
        want = np.asarray(jax_pick(*map(jnp.asarray,
                                        (logits, t, topps, seeds, pos))))
        got = _pick_tokens(*map(torch.from_numpy,
                                (logits, t, topps, seeds, pos)))
        np.testing.assert_array_equal(got.numpy(), want)


def _requests(cls):
    rng = np.random.RandomState(5)
    shared = rng.randint(1, 512, size=40).astype(np.int32)
    out = []
    for i in range(6):
        tail = rng.randint(1, 512, size=rng.randint(3, 30)).astype(np.int32)
        prompt = np.concatenate([shared, tail]) if i % 2 == 0 else tail
        kw = dict(temperature=0.9, top_p=0.85, seed=10 + i) if i % 3 else {}
        out.append(cls(rid=i, prompt=prompt,
                       max_new_tokens=int(rng.randint(4, 12)), **kw))
    return out


@pytest.mark.parametrize("int8", [False, True])
def test_engine_streams_and_ledger_equal_reference(int8):
    params = jax_init(JCFG, jax.random.PRNGKey(0))
    jeng = JEngine(JCFG, params=params, weight_only_int8=int8, **ENGINE)
    teng = ServingEngine(TCFG, params=params_from_jax(
        jax.tree.map(np.asarray, params), "cpu"), weight_only_int8=int8,
        device="cpu", **ENGINE)
    jreq, treq = _requests(JRequest), _requests(Request)
    jstats, tstats = jeng.run(jreq), teng.run(treq)
    for a, b in zip(jreq, treq):
        assert len(b.out_tokens) == b.max_new_tokens
        assert a.out_tokens == b.out_tokens, a.rid
    jacc, tacc = jeng.page_accounting(), teng.page_accounting()
    assert tacc["total"] == teng.n_pages - 1
    assert {k: jacc[k] for k in tacc} == tacc
    for k in teng.stats:
        assert jeng.stats[k] == teng.stats[k], k
    for k in ("prefix_cache_hits", "prefix_cache_misses",
              "total_new_tokens"):
        assert jstats[k] == tstats[k], k
    assert tstats["prefix_cache_hits"] > 0
    assert teng.kv_bytes_per_token() == jeng.kv_bytes_per_token()


def test_abort_releases_pages():
    eng = ServingEngine(TCFG, device="cpu", **ENGINE)
    reqs = [Request(rid=i, prompt=np.arange(1, 30, dtype=np.int32) + i,
                    max_new_tokens=8) for i in range(3)]
    for r in reqs:
        eng.submit(r)
    eng.step()
    assert eng.abort(0) and eng.abort(2) and not eng.abort(99)
    while eng.step():
        pass
    assert reqs[0].aborted and reqs[2].aborted
    assert len(reqs[1].out_tokens) == 8
    acc = eng.page_accounting()
    assert acc["total"] == eng.n_pages - 1 and acc["slot_owned"] == 0


@pytest.mark.parametrize("flag", ["serving_speculative_k",
                                  "serving_kv_quant", "serving_lora",
                                  "serving_priorities",
                                  "serving_constrained"])
def test_later_slice_flags_raise(flag):
    """Each of the five engine flags, turned on through GLOBAL_FLAGS
    alone, puts the engine on its path: int8 pages with scale planes, a
    draft budget, an adapter store, priority admission order, the
    constrained vocabulary mask."""
    from paddle_tpu_torch.inference import serving
    from paddle_tpu_torch.inference.multitenant import (AdapterStore,
                                                        json_schema_dfa)

    old = GLOBAL_FLAGS.get(flag)
    GLOBAL_FLAGS.set(flag, 3 if flag == "serving_speculative_k" else True)
    try:
        eng = ServingEngine(TCFG, device="cpu", **ENGINE)
    finally:
        GLOBAL_FLAGS.set(flag, old)
    if flag == "serving_kv_quant":
        assert eng.k_pages.dtype == torch.int8
        assert eng.v_scales.shape == (TCFG.n_layers, eng.n_pages,
                                      TCFG.n_kv_heads)
    elif flag == "serving_speculative_k":
        assert eng.spec_k == 3
    elif flag == "serving_lora":
        assert isinstance(eng.adapters, AdapterStore)
    elif flag == "serving_priorities":
        reqs = [Request(rid=i, prompt=np.arange(1, 9, dtype=np.int32),
                        max_new_tokens=2, priority=p)
                for i, p in enumerate((0, 2, 1))]
        for r in reqs:
            eng.submit(r)
        eng._admit(0.0)
        assert [r.rid for r in eng.slots] == [1, 2]
    else:
        vocab = [""] * TCFG.vocab_size
        vocab[1:4] = ["a", "b", "c"]
        eng.register_schema("s", json_schema_dfa({"enum": ["ab"]},
                                                 vocab).fresh)
        seen = []
        pick = serving._pick_tokens
        serving._pick_tokens = lambda logits, *a: (seen.append(logits),
                                                   pick(logits, *a))[1]
        try:
            eng.run([Request(rid=0, prompt=np.arange(1, 9, dtype=np.int32),
                             max_new_tokens=3, schema_id="s")])
        finally:
            serving._pick_tokens = pick
        assert (seen[0][0] > -1e30).nonzero().flatten().tolist() == [1]
        assert (seen[0][1:] > -1e30).all()


def test_flags_read_environment_and_decode_weight_quant(monkeypatch):
    from paddle_tpu_torch.core.flags import FlagRegistry

    monkeypatch.setenv("FLAGS_serving_unified_qb", "8")
    monkeypatch.setenv("FLAGS_decode_weight_quant", "1")
    reg = FlagRegistry()
    reg.define("serving_unified_qb", 16)
    reg.define("decode_weight_quant", False)
    assert reg.get("serving_unified_qb") == 8
    assert reg.get("decode_weight_quant") is True
    GLOBAL_FLAGS.set("decode_weight_quant", True)
    try:
        eng = ServingEngine(TCFG, device="cpu", **ENGINE)
    finally:
        GLOBAL_FLAGS.set("decode_weight_quant", False)
    assert isinstance(eng.params["blocks"]["w_up"], tuple)
    assert eng.params["blocks"]["w_up"][0].dtype == torch.int8
