"""The KV page wire (version 2) between the JAX package and the port on
the CPU, byte for byte in both directions.

A shipment the JAX engine exports adopts into the port's engine, and one
the port exports adopts into the JAX engine, leaving pools (pages and
scale planes), prefix caches, refcounts and free lists equal to a
same-package adoption, bitwise, for fp32, bf16 and int8 pools. The two
packages' headers and crcs agree. The JAX shipment of a bf16 pool holds
``ml_dtypes.bfloat16`` arrays, the port's a uint16 view of the same
bytes; a port shipment handed to the JAX engine is first viewed as
``ml_dtypes.bfloat16`` (a view, not a conversion), which is what a JAX
host does with bytes off a wire. Also: the staged export equals the
synchronous one; the mixed-mode conversions (int8 -> fp32, int8 -> bf16,
fp32 / bf16 -> int8) equal the reference's ``_convert_shipment``
bitwise; a LoRA request's shipment (adapter-salted block hashes) crosses
both ways with equal pages, crcs and salts; v1 shipments adopt; redelivery skips resident hashes; chaos
``migration.stage`` drop and corrupt and ``migration.commit`` raise
leave no leak in either fleet; the ledger sums mid-stage and
mid-deferred-commit."""

import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)
import zlib

import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu.inference.serving import Request as JRequest
from paddle_tpu_torch.inference.fleet import ship_shipment
from paddle_tpu_torch.inference.serving import Request as TRequest

from torch_fleet_common import (arm, assert_same_fleet, engines, isolate,
                                lockstep, requests, routers, settle,
                                solo_port, submit)

__all__ = ["isolate"]

POOLS = {"fp32": dict(dtype="float32"), "bf16": dict(dtype="bfloat16"),
         "int8": dict(dtype="float32", kv_quant=True)}
HEADER = ("version", "rid", "page_size", "kv_quant", "quant_mode", "dtype",
          "geom", "hashes", "salt")


def _pool_engines(pool: str, n: int = 3, **kw):
    return engines(n, **POOLS[pool], **kw)


def _run_donor(eng, cls, n_tokens: int = 1):
    """rid 0 (a 40-token prompt) until it has ``n_tokens`` tokens: its
    two full prompt pages are exportable."""
    req = cls(rid=0, prompt=np.arange(1, 41, dtype=np.int32),
              max_new_tokens=8)
    eng.submit(req)
    while len(req.out_tokens) < n_tokens:
        eng.step(now=1e18)
    return req


def _crc(ship, j):
    """The reference's crc of shipment page j (zlib over the bytes)."""
    extra = (ship["k_scales"][j].tobytes() + ship["v_scales"][j].tobytes()
             if ship["k_scales"] is not None else b"")
    return zlib.crc32(ship["k"][j].tobytes() + ship["v"][j].tobytes()
                      + extra)


def _as_jax(ship):
    """A port shipment as a JAX host sees it: bf16 payloads viewed as
    ``ml_dtypes.bfloat16``."""
    out = dict(ship)
    if ship["dtype"] == "bfloat16":
        out["k"] = ship["k"].view(ml_dtypes.bfloat16)
        out["v"] = ship["v"].view(ml_dtypes.bfloat16)
    return out


def _host(a):
    """A pool array of either package as numpy with the same bytes."""
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return (a.view(torch.int16) if a.dtype == torch.bfloat16
                else a).numpy()
    return np.asarray(a)


def _state(eng):
    """An engine's pool bytes and prefix-cache state, packageless."""
    arrs = {n: _host(getattr(eng, n)) for n in ("k_pages", "v_pages", "k_scales",
                                        "v_scales")}
    p = eng.pool
    return arrs, (dict(p.cache), dict(p.ref), list(p.free),
                  list(p.pending_evict), dict(p.evictable))


def _assert_same_state(a, b):
    (aa, ac), (ba, bc) = _state(a), _state(b)
    for n in aa:
        if aa[n] is None:
            assert ba[n] is None, n
        else:
            assert aa[n].tobytes() == ba[n].tobytes(), n
    assert ac == bc


@pytest.mark.parametrize("pool", list(POOLS))
def test_wire_v2_both_directions_bitwise(pool):
    """JAX export -> port adopter == JAX adopter, and port export -> JAX
    adopter == port adopter: pools and caches bitwise equal. Headers are
    equal between the packages' exports of the same request, and each
    package's crcs are the reference's crc32 of its own payload."""
    (jd, ja, ja2), (td, ta, ta2) = _pool_engines(pool)
    _run_donor(jd, JRequest)
    _run_donor(td, TRequest)
    js, ts = jd.export_request_pages(0), td.export_request_pages(0)
    assert len(js["hashes"]) == len(ts["hashes"]) == 2
    for k in HEADER:
        assert js[k] == ts[k], k
    assert np.array_equal(js["tokens"], ts["tokens"])
    for ship in (js, ts):
        assert ship["crc"] == [_crc(ship, j) for j in range(2)]
        assert ship["k"].dtype.itemsize == (1 if pool == "int8" else
                                            2 if pool == "bf16" else 4)
    assert ts["k"].shape == js["k"].shape and ts["v"].shape == js["v"].shape
    if pool == "bf16":
        assert ts["k"].dtype == np.uint16
    # JAX -> port, against JAX -> JAX
    assert ja.adopt_pages(js) == ta.adopt_pages(js) == 2
    _assert_same_state(ja, ta)
    # port -> JAX, against port -> port
    assert ja2.adopt_pages(_as_jax(ts)) == ta2.adopt_pages(ts) == 2
    _assert_same_state(ja2, ta2)
    # the adopted pages serve the same prompt from the cache on the port
    hits0 = ta.pool.hits
    req = _run_donor(ta, TRequest, n_tokens=2)
    assert ta.pool.hits - hits0 == 2 and len(req.out_tokens) == 2


def test_lora_request_shipment_both_directions():
    """A LoRA request's pages: the hashes are salted with the adapter's
    content digest (``_cache_salt``), equal in both packages, as are the
    headers; each package's crcs are the reference's crc32 of its
    payload; adopted both ways, the pools, caches and hashes equal a
    same-package adoption bitwise, and the
    adopted pages serve the same adapter's request from the cache (and
    not a request under no adapter)."""
    from paddle_tpu.inference.multitenant import make_lora as jax_make_lora
    from paddle_tpu_torch.inference.multitenant import make_lora

    from torch_fleet_common import JCFG, TCFG

    (jd, ja, ja2), (td, ta, ta2) = engines(3, lora=True, lora_slots=2)
    for e in (jd, ja, ja2):
        e.register_adapter("a0", jax_make_lora(JCFG["float32"], 8, seed=1,
                                               scale=0.3))
    for e in (td, ta, ta2):
        e.register_adapter("a0", make_lora(TCFG["float32"], 8, seed=1,
                                           scale=0.3))
    for eng, cls in ((jd, JRequest), (td, TRequest)):
        req = cls(rid=0, prompt=np.arange(1, 41, dtype=np.int32),
                  max_new_tokens=8, adapter_id="a0")
        eng.submit(req)
        while not req.out_tokens:
            eng.step(now=1e18)
        assert eng._cache_salt(req).startswith(b"lora:")
    assert td._cache_salt(req) == jd._cache_salt(req)
    js, ts = jd.export_request_pages(0), td.export_request_pages(0)
    assert len(ts["hashes"]) == 2 and ts["salt"].startswith(b"lora:")
    for k in HEADER:
        assert js[k] == ts[k], k
    for ship in (js, ts):        # each payload's crcs are the reference's
        assert ship["crc"] == [_crc(ship, j) for j in range(2)]
    assert ts["hashes"] == td._page_hashes(np.arange(1, 33, dtype=np.int32),
                                           ts["salt"])
    assert ts["hashes"] != td._page_hashes(np.arange(1, 33, dtype=np.int32),
                                           b"")
    # JAX -> port against JAX -> JAX, port -> JAX against port -> port
    assert ja.adopt_pages(js) == ta.adopt_pages(js) == 2
    _assert_same_state(ja, ta)
    assert ja2.adopt_pages(_as_jax(ts)) == ta2.adopt_pages(ts) == 2
    _assert_same_state(ja2, ta2)
    hits0 = ta.pool.hits
    plain = TRequest(rid=1, prompt=np.arange(1, 41, dtype=np.int32),
                     max_new_tokens=1)
    ta.run([plain])
    assert ta.pool.hits == hits0
    lora = TRequest(rid=2, prompt=np.arange(1, 41, dtype=np.int32),
                    max_new_tokens=1, adapter_id="a0")
    ta.run([lora])
    assert ta.pool.hits - hits0 == 2


@pytest.mark.parametrize("pool", list(POOLS))
def test_staged_export_equals_sync_export(pool):
    """stage_request_pages + finalize_shipment ship the same bytes,
    hashes and crcs as export_request_pages; finalize passes a
    materialized shipment through."""
    _, (td, _, _) = _pool_engines(pool)
    _run_donor(td, TRequest, n_tokens=4)
    sync = td.export_request_pages(0)
    staged = td.stage_request_pages(0)
    assert staged["staged"] and staged["crc"] is None
    fin = td.finalize_shipment(staged)
    assert fin["staged"] is False and td.finalize_shipment(sync) is sync
    for k in HEADER + ("crc",):
        assert fin[k] == sync[k], k
    for k in ("k", "v", "k_scales", "v_scales"):
        if sync[k] is None:
            assert fin[k] is None
        else:
            assert fin[k].tobytes() == sync[k].tobytes(), k
    assert td.shipment_bytes(fin) == td.shipment_bytes(sync)
    assert td.stats["wire_export_ms"] > 0.0


@pytest.mark.parametrize("src,dst", [("int8", "fp32"), ("int8", "bf16"),
                                     ("fp32", "int8"), ("bf16", "int8")])
def test_mixed_mode_conversion_equals_reference(src, dst):
    """The edge conversion of one shipment by the JAX engine and by the
    port's of the destination mode: payload bytes, scales, re-keyed
    hashes, tokens and crcs bitwise equal; adopting it leaves equal
    pools."""
    (jd, _, _), _ = _pool_engines(src)
    _run_donor(jd, JRequest, n_tokens=4)
    ship = jd.export_request_pages(0)
    (ja,), (ta,) = _pool_engines(dst, n=1)
    jc, tc = ja._convert_shipment(ship), ta._convert_shipment(ship)
    assert jc["quant_mode"] == tc["quant_mode"] != ship["quant_mode"]
    for k in HEADER + ("crc",):
        assert jc[k] == tc[k], k
    for k in ("k", "v", "k_scales", "v_scales"):
        if jc[k] is None:
            assert tc[k] is None
        else:
            assert np.asarray(jc[k]).tobytes() == tc[k].tobytes(), k
    assert ja.adopt_pages(ship) == ta.adopt_pages(ship) > 0
    _assert_same_state(ja, ta)


def test_wire_v1_adopts_and_cross_mode_v1_is_refused():
    """Wire v2 is additive: a v1 shipment (no quant_mode, tokens, salt)
    adopts into a same-mode pool; a cross-mode v1 shipment cannot be
    re-keyed and raises."""
    (jd, _, _), (td, ta, _) = _pool_engines("fp32")
    _run_donor(jd, JRequest, n_tokens=4)
    v1 = {k: v for k, v in jd.export_request_pages(0).items()
          if k not in ("quant_mode", "tokens", "salt")}
    v1["version"] = 1
    assert ta.adopt_pages(v1) == len(v1["hashes"])
    _, (tq,) = _pool_engines("int8", n=1)
    with pytest.raises(ValueError, match="wire v1"):
        tq.begin_adopt(v1)
    assert tq.shipment_cache_hashes(v1) is None


@pytest.mark.parametrize("pool", ["int8", "bf16"])
def test_redelivery_skips_resident_hashes(pool):
    """At-least-once delivery: a second delivery to the same pool, and to
    a pool of the other mode through the re-keyed hashes, is ok with 0
    pages and stages nothing."""
    _, (td, same, _) = _pool_engines(pool)
    _run_donor(td, TRequest, n_tokens=4)
    ship = td.export_request_pages(0)
    _, (cross,) = _pool_engines("bf16" if pool == "int8" else "int8", n=1)
    for eng in (same, cross):
        first = ship_shipment(ship, 0, eng)
        assert first["status"] == "ok" and first["pages"] >= 2
        free0 = len(eng.pool.free)
        again = ship_shipment(ship, 0, eng)
        assert (again["status"], again["pages"], again["bytes"]) == \
            ("ok", 0, 0)
        assert len(eng.pool.free) == free0
        settle_engine(eng)
        acc = eng.page_accounting()
        assert acc["total"] == eng.n_pages - 1 and acc["in_flight"] == 0


def settle_engine(e):
    if e._deferred_free or e.pool.pending_evict:
        e.pool.release(e._deferred_free)
        e._deferred_free = []
        e.pool.commit_evictable()


def test_ledger_sums_mid_stage_and_mid_deferred_commit():
    """in_flight holds exactly the staged pages between begin_adopt and
    commit_adopt; on the overlapped wire the committed pages are
    cache_idle while their bytes wait in _commit_pending; the next
    dispatch writes them and a request sharing the prefix then decodes
    the uninterrupted stream through them."""
    _, (td, _, _) = _pool_engines("fp32")
    _run_donor(td, TRequest, n_tokens=4)
    ship = td.export_request_pages(0)
    _, (recv,) = engines(1, wire_overlap=True)
    free0 = len(recv.pool.free)
    h = recv.begin_adopt(ship)
    acc = recv.page_accounting()
    assert acc["in_flight"] == len(ship["hashes"])
    assert acc["total"] == recv.n_pages - 1
    n = recv.commit_adopt(h)
    assert n == len(ship["hashes"]) and len(recv._commit_pending) == 1
    acc = recv.page_accounting()
    assert acc["in_flight"] == 0 and acc["cache_idle"] >= n
    assert acc["total"] == recv.n_pages - 1
    req = TRequest(rid=9, prompt=np.arange(1, 41, dtype=np.int32),
                   max_new_tokens=4)
    recv.submit(req)
    while recv.step(now=1e18):
        assert not recv._commit_pending
    assert req.out_tokens == solo_port(req)
    assert recv.stats["prefill_cached_tokens"] == 32
    settle_engine(recv)
    acc = recv.page_accounting()
    assert acc["in_flight"] == acc["deferred_free"] == 0
    assert acc["free"] + acc["cache_idle"] == free0


def test_flush_skips_a_page_evicted_since_its_commit():
    """A deferred commit whose page was evicted and handed out again
    before the next dispatch must not be written over the new tenant."""
    _, (td, _, _) = _pool_engines("fp32")
    _run_donor(td, TRequest, n_tokens=4)
    ship = td.export_request_pages(0)
    _, (recv,) = engines(1, wire_overlap=True)
    recv.adopt_pages(ship)
    recv.pool.commit_evictable()
    page = recv.pool.cache[ship["hashes"][0]]
    before = recv.k_pages[:, page].clone()
    recv.pool.evict(len(recv.pool.evictable))
    assert recv.pool.hash_of.get(page) is None
    recv._flush_commits()
    assert not recv._commit_pending
    assert bool((recv.k_pages[:, page] == before).all())


@pytest.mark.parametrize("spec,counter", [
    (("migration.stage", "drop", dict(once=True, pool="prefill")), None),
    (("migration.stage", "corrupt", dict(once=True, pool="prefill")),
     "migration_rejected"),
    (("migration.commit", "raise", dict(once=True, pool="decode")),
     "migration_rejected"),
    (("migration.commit", "raise", dict(once=False, pool="prefill")),
     None)])
def test_overlapped_wire_chaos_matches_reference_leak_free(spec, counter):
    """The overlapped wire under chaos (a staging buffer lost, a byte
    flipped after the crcs, a commit raising on the adopter; a
    prefill-scoped commit spec never matches the decode side): both
    fleets agree on every tick, every stream completes unchanged and the
    pools settle leak-free."""
    arm(spec)
    jr, tr = routers(disagg_prefill=1, retry_max=2, retry_base_delay=0.0,
                     engine_kw=dict(wire_overlap=True))
    jreqs, treqs = requests(seed=5, n=4, max_new=8, sampled=(1,))
    submit(jr, tr, jreqs, treqs)
    lockstep(jr, tr)
    assert_same_fleet(jr, tr, jreqs, treqs)
    for r in treqs:
        assert r.out_tokens == solo_port(r), r.rid
    st = tr.fleet_stats()
    if counter:
        assert st[counter] >= 1
    elif spec[0] == "migration.stage":
        assert st["n_handoffs"] == 3
    else:
        assert st["migration_rejected"] == 0 and st["n_handoffs"] >= 3
    settle(tr)
    for rep in tr.replicas:
        acc = rep.engine.page_accounting()
        assert acc["total"] == rep.engine.n_pages - 1
        assert not any(acc[k] for k in ("slot_owned", "slot_shared",
                                         "deferred_free", "in_flight"))
        assert not rep.engine._commit_pending


@pytest.mark.parametrize("donor,decode", [(True, False), (False, True)])
def test_mixed_mode_fleet_matches_reference(donor, decode):
    """An int8 prefill pool into an fp decode pool and the reverse, on
    the overlapped wire: both fleets agree on every tick and the streams
    equal a lone port engine of the decode pool's mode."""
    jr, tr = routers(disagg_prefill=1, retry_max=2, retry_base_delay=0.0,
                     engine_kw=dict(wire_overlap=True),
                     per_engine=(dict(kv_quant=donor),
                                 dict(kv_quant=decode)))
    jreqs, treqs = requests(seed=7, n=4, max_new=8, sampled=(1, 3))
    submit(jr, tr, jreqs, treqs)
    lockstep(jr, tr)
    assert_same_fleet(jr, tr, jreqs, treqs)
    for r in treqs:
        assert r.out_tokens == solo_port(r, kv_quant=decode), r.rid
    assert tr.stats["n_handoffs"] >= 4
    assert tr.stats["migration_rejected"] == 0
