"""The port's grouped BGMV (K13, ops/kernels/lora_matmul.py) and adapter
store (inference/multitenant/lora.py) against the JAX reference on the
CPU: the plain arm, which the wrapper runs on a CPU tensor, against the
reference's Pallas kernel in interpret mode and its XLA gather arm on
the same numpy inputs; fp32 outputs within atol/rtol 1e-6 (two fp32
products of the same values, summed in another order), slot-0 rows
exactly 0. The store's refcounting, content-hash dedup and idle-LRU
eviction follow the reference's test of its own store."""

import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas.lora_matmul import _lora_xla, lora_matmul_kernel
from paddle_tpu_torch.inference.multitenant import AdapterStore, make_lora
from paddle_tpu_torch.models.llama import LlamaConfig
from paddle_tpu_torch.ops.kernels.lora_matmul import (lora_matmul,
                                                      lora_matmul_plain)

CFG = LlamaConfig(vocab_size=512, hidden=128, n_layers=2, n_heads=8,
                  n_kv_heads=4, ffn_hidden=256, max_seq_len=256,
                  dtype=torch.float32, param_dtype=torch.float32)


def _case(seed, C=4, qb=8, H=128, r=8, N=256, S=3):
    rng = np.random.RandomState(seed)
    x = rng.randn(C, qb, H).astype(np.float32)
    a = (rng.randn(S, H, r) * 0.1).astype(np.float32)
    b = (rng.randn(S, r, N) * 0.1).astype(np.float32)
    a[0], b[0] = 0.0, 0.0                        # the identity slot
    ids = np.array([0, 2, 1, 2][:C], np.int32)
    return x, a, b, ids


@pytest.mark.parametrize("ref", ["kernel_interpret", "xla"])
def test_plain_matches_reference(ref):
    x, a, b, ids = _case(0)
    if ref == "xla":
        want = _lora_xla(*map(jnp.asarray, (x, a, b, ids)))
    else:
        want = lora_matmul_kernel(*map(jnp.asarray, (x, a, b, ids)), bn=128)
    got = lora_matmul(*map(torch.from_numpy, (x, a, b, ids)))
    assert got.dtype == torch.float32 and got.shape == (4, 8, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)
    assert (got[0] == 0).all()


def test_bf16_inputs_widen_exactly():
    """bf16 x and stacks: the products run in fp32 on exact widenings."""
    x, a, b, ids = _case(1)
    xb, ab, bb = (torch.from_numpy(t).to(torch.bfloat16) for t in (x, a, b))
    got = lora_matmul_plain(xb, ab, bb, torch.from_numpy(ids))
    want = _lora_xla(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                       for t in (xb, ab, bb)), jnp.asarray(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


def test_wrapper_on_cpu_launches_nothing():
    x, a, b, ids = _case(2)
    before = lora_matmul.launches
    lora_matmul(*map(torch.from_numpy, (x, a, b, ids)))
    assert lora_matmul.launches == before


def test_adapter_store_refcount_dedup_and_eviction():
    pool = list(range(100, 140))
    held = []

    def alloc(n):
        if len(pool) < n:
            return None
        got = [pool.pop() for _ in range(n)]
        held.extend(got)
        return got

    def release(pages):
        for p in pages:
            held.remove(p)
            pool.append(p)

    st = AdapterStore(CFG, rank=8, n_slots=2, page_bytes=4096,
                      alloc_pages=alloc, release_pages=release)
    w = make_lora(CFG, 8, seed=1)
    st.register("x", w)
    st.register("y", {k: v.copy() for k, v in w.items()})   # same bytes
    st.register("z", make_lora(CFG, 8, seed=2))
    s1, s2 = st.acquire("x"), st.acquire("y")
    assert s1 == s2 and st.ref_of("x") == 2 and st.n_resident() == 1
    assert st.pages_of("x") == st.pages_of("y")
    np.testing.assert_array_equal(st.stacks()["aq"][:, s1].numpy(),
                                  w["a_q"])
    assert (st.stacks()["bv"][:, 0] == 0).all()
    per = st.n_pages_held()
    s3 = st.acquire("z")
    assert s3 != s1 and st.n_pages_held() == 2 * per
    st.decref("x")
    st.decref("y")
    assert st.ref_of("x") == 0 and st.n_resident() == 2   # idle but warm
    st.register("w", make_lora(CFG, 8, seed=3))
    assert st.acquire("w") == s1 and st.evictions == 1    # slot reused
    st.decref("z")
    st.decref("w")
    assert st._evict_idle() and st._evict_idle()
    assert st.n_pages_held() == 0 and not held
