"""The port's LLaMA prefill + decode engine (``LlamaForCausalLM``)
against the JAX package's on the CPU, at a 2-layer config with head dim
128 and G = 2 (4 heads, 2 kv heads), prompts of 128 tokens, B 2, in fp32
and in bf16 (the bf16 cast points: the norm's cast back, the swiglu's
silu cast, p before p.v, the cache dtype).
Weights come from the JAX package (``init_llama_params``, and its
``quantize_weights_int8`` for the int8 engine, carried by
``params_from_jax`` with the (int8, scale) pairs as they are).

The port runs its default path, the fusion compiler on (K6, K11 and K12
in the prefill, K10 in the decode, their plain arms on the CPU); the
reference runs with its compiler off (its own compiler needs
``jax.core.Var``, which this jax lacks), which it holds equal to its
fused path; its flash forward and decode kernel run as Pallas in
interpret mode.

Tolerances, fp32: greedy and sampled streams exact, except from a token
where the reference's top-2 logits are within 1e-4 of each other (fp32
summation order can swap a tie; the test prints the gap where a token
differs). Prefill logits rtol 1e-5 with atol 1e-5 of the largest; decode
logits against the full forward over the grown sequence likewise.

bf16: the two packages' bf16 matmuls sum in another order, so logits
differ by up to ~1.5 bf16 ulps of the largest logit (measured 0.0117 at a
largest logit of 1.6). Prefill logits are held to 4 ulps of the largest
logit (``_bf16_margin``), and a greedy or sampled stream may part from
the reference's only at a token where the reference's scores of the two
picks are within that margin: for greedy their logits, for sampling their
gumbel-perturbed scores (times the temperature) when both are in the
reference's nucleus, else the excluded pick's distance to the nucleus
cutoff. The test prints the gap where a token differs."""

import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.core.flags import GLOBAL_FLAGS as JFLAGS
from paddle_tpu.models import llama as jl
from paddle_tpu.ops import nucleus as jnucleus
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.utils.convert import params_from_jax

SHAPE = dict(vocab_size=512, hidden=512, n_layers=2, n_heads=4,
             n_kv_heads=2, ffn_hidden=768, max_seq_len=256)
B, T = 2, 128
MARGIN = 1e-4


@pytest.fixture(scope="module", autouse=True)
def no_jax_auto_fusion():
    old = JFLAGS.get("use_auto_fusion")
    JFLAGS.set("use_auto_fusion", False)
    yield
    JFLAGS.set("use_auto_fusion", old)


def _engines(int8=False, seed=0, bf16=False):
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32,
                                                           torch.float32)
    jc = jl.LlamaConfig(**SHAPE, dtype=jdt, param_dtype=jdt,
                        weight_only_int8=int8)
    tc = tl.LlamaConfig(**SHAPE, dtype=tdt, param_dtype=tdt,
                        weight_only_int8=int8)
    jm = jl.LlamaForCausalLM(jc, seed=seed, max_batch=B)
    tp = params_from_jax(jax.tree.map(np.asarray, jm.params), "cpu")
    tm = tl.LlamaForCausalLM(tc, params=tp, max_batch=B, device="cpu")
    return jm, tm


@pytest.fixture(scope="module")
def engines():
    return _engines()


@pytest.fixture(scope="module")
def engines_bf16():
    return _engines(bf16=True)


def _prompt(seed=0, b=B):
    return np.random.RandomState(seed).randint(0, SHAPE["vocab_size"],
                                               size=(b, T)).astype(np.int32)


def _jax_logits_at(jm, prompt, toks, j):
    """The reference's logits that picked token j of each row."""
    cache = jm._empty_cache(prompt.shape[0])
    logits, cache = jm._prefill(jm.params, jnp.asarray(prompt), cache)
    for s in range(j):
        logits, cache = jm._decode(jm.params, cache, jnp.asarray(toks[:, s]),
                                   jnp.asarray(T + s, jnp.int32))
    return np.asarray(logits, dtype=np.float32)


def _bf16_margin(logits) -> float:
    """4 bf16 ulps of the largest |logit|."""
    top = float(np.abs(logits).max())
    return 4 * 2.0 ** (np.floor(np.log2(top)) - 7)


def _sampled_gap(logits, a, c, j, temperature, top_p, seed) -> float:
    """How far apart the reference's sampler holds picks a (its own) and
    c at token j, in logit units: their gumbel-perturbed scores times the
    temperature when both are in its nucleus, else c's distance to the
    nucleus cutoff (built from the reference's own pieces)."""
    key = jax.random.PRNGKey(seed)
    for _ in range(j + 1):
        key, sub = jax.random.split(key)
    x = jnp.asarray(logits) / temperature
    s = jnp.sort(x, -1)[..., ::-1]
    keep = jnucleus.nucleus_keep(jax.nn.softmax(s, -1),
                                 jnp.asarray(top_p, jnp.float32))
    cut = float(jnp.min(jnp.where(keep, s, jnp.inf)))
    x = np.asarray(x)
    if x[c] < cut:
        return float(cut - x[c]) * temperature
    z = x + np.asarray(jax.random.gumbel(sub, (1, x.shape[0]))).reshape(-1)
    return float(z[a] - z[c]) * temperature


def _assert_streams(jm, prompt, want, got, bf16=False, sampling=None):
    """Rows of ``got`` equal ``want`` except from a token where the
    reference's scores of the two picks are within the margin (1e-4 in
    fp32, _bf16_margin in bf16); ``sampling`` = (temperature, top_p,
    seed) for sampled streams."""
    assert got.shape == want.shape
    for b in range(want.shape[0]):
        diff = np.nonzero(want[b] != got[b])[0]
        if not len(diff):
            continue
        j = int(diff[0])
        a, c = int(want[b, j]), int(got[b, j])
        logits = _jax_logits_at(jm, prompt, want, j)[b]
        margin = _bf16_margin(logits) if bf16 else MARGIN
        if sampling is None:
            gap = float(logits[a] - logits[c])
        else:
            gap = _sampled_gap(logits, a, c, j, *sampling)
        print(f"row {b} differs at token {j}: tokens {a} vs {c}, reference "
              f"gap {gap:.3e} (margin {margin:.3e})")
        assert 0.0 <= gap < margin, (b, j, gap, margin)


def test_greedy_generate_matches_jax(engines):
    jm, tm = engines
    prompt = _prompt(0)
    want = np.asarray(jm.generate(prompt, max_new_tokens=12))
    got = tm.generate(prompt, max_new_tokens=12)
    _assert_streams(jm, prompt, want, got)


@pytest.mark.parametrize("temperature,top_p,seed", [(0.8, 0.9, 3),
                                                    (1.5, 0.5, 11)])
def test_sampled_generate_matches_jax(engines, temperature, top_p, seed):
    jm, tm = engines
    prompt = _prompt(1)
    kw = dict(max_new_tokens=10, temperature=temperature, top_p=top_p,
              seed=seed)
    np.testing.assert_array_equal(tm.generate(prompt, **kw),
                                  np.asarray(jm.generate(prompt, **kw)))


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_int8_engine_matches_jax(temperature):
    jm, tm = _engines(int8=True, seed=1)
    assert isinstance(tm.params["blocks"]["wq"], tuple)
    assert tm.params["blocks"]["wq"][0].dtype == torch.int8
    prompt = _prompt(2)
    kw = dict(max_new_tokens=8, temperature=temperature, top_p=0.9, seed=5)
    want = np.asarray(jm.generate(prompt, **kw))
    got = tm.generate(prompt, **kw)
    if temperature == 0.0:
        _assert_streams(jm, prompt, want, got)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("prompt_seed", [0, 1])
def test_bf16_greedy_generate_matches_jax(engines_bf16, prompt_seed):
    jm, tm = engines_bf16
    prompt = _prompt(prompt_seed)
    want = np.asarray(jm.generate(prompt, max_new_tokens=12))
    got = tm.generate(prompt, max_new_tokens=12)
    _assert_streams(jm, prompt, want, got, bf16=True)


@pytest.mark.parametrize("temperature,top_p,seed,prompt_seed",
                         [(0.8, 0.9, 3, 0), (1.5, 0.5, 11, 0),
                          (0.8, 0.9, 3, 1)])
def test_bf16_sampled_generate_matches_jax(engines_bf16, temperature, top_p,
                                           seed, prompt_seed):
    jm, tm = engines_bf16
    prompt = _prompt(prompt_seed)
    kw = dict(max_new_tokens=10, temperature=temperature, top_p=top_p,
              seed=seed)
    _assert_streams(jm, prompt, np.asarray(jm.generate(prompt, **kw)),
                    tm.generate(prompt, **kw), bf16=True,
                    sampling=(temperature, top_p, seed))


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_bf16_int8_engine_matches_jax(temperature):
    jm, tm = _engines(int8=True, seed=1, bf16=True)
    assert tm.params["blocks"]["wq"][0].dtype == torch.int8
    assert tm.params["blocks"]["wq"][1].dtype == torch.bfloat16
    prompt = _prompt(2)
    kw = dict(max_new_tokens=8, temperature=temperature, top_p=0.9, seed=5)
    _assert_streams(jm, prompt, np.asarray(jm.generate(prompt, **kw)),
                    tm.generate(prompt, **kw), bf16=True,
                    sampling=(temperature, 0.9, 5) if temperature else None)


def test_bf16_prefill_logits_match_jax(engines_bf16):
    jm, tm = engines_bf16
    prompt = _prompt(3)
    want, _ = jm._prefill(jm.params, jnp.asarray(prompt), jm._empty_cache(B))
    got, cache = tm._prefill_impl(torch.from_numpy(prompt),
                                  tm._empty_cache(B))
    want = np.asarray(want, dtype=np.float32)
    assert got.dtype == torch.float32 and cache["k"].dtype == torch.bfloat16
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=_bf16_margin(want))


def test_prefill_logits_match_jax(engines):
    jm, tm = engines
    prompt = _prompt(3)
    want, _ = jm._prefill(jm.params, jnp.asarray(prompt), jm._empty_cache(B))
    got, cache = tm._prefill_impl(torch.from_numpy(prompt),
                                  tm._empty_cache(B))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))
    # slots past the prompt stay empty
    assert not cache["k"][:, :, :, T:].any()


def test_decode_logits_equal_full_forward(engines):
    """Each decode step's logits equal the full forward over the grown
    sequence (KV slots, rope positions), the port's counterpart of the
    reference's test_llama_decode_matches_full_forward."""
    _, tm = engines
    prompt = torch.from_numpy(_prompt(4))
    with torch.no_grad():
        logits, cache = tm._prefill_impl(prompt, tm._empty_cache(B))
        seq = prompt
        for step in range(4):
            tok = torch.argmax(logits, dim=-1)
            seq = torch.cat([seq, tok[:, None]], dim=1)
            logits, cache = tm._decode_impl(cache, tok, T + step)
            full = tl.llama_apply(tm.params, seq, tm.cfg)[:, -1]
            np.testing.assert_allclose(
                logits.numpy(), full.numpy(), rtol=1e-5,
                atol=1e-5 * float(full.abs().max()), err_msg=f"step {step}")


def test_eos_early_exit_matches_jax(engines):
    jm, tm = engines
    # a prompt whose greedy stream reaches a new token at step 3 or later
    # (random weights repeat themselves): that token is the eos
    for seed in range(5, 30):
        prompt = _prompt(seed, b=1)
        full = tm.generate(prompt, max_new_tokens=10)
        fresh = [i for i in range(3, 10) if full[0, i] not in full[0, :i]]
        if fresh:
            break
    j = fresh[0]
    eos = int(full[0, j])
    got = tm.generate(prompt, max_new_tokens=10, eos_token_id=eos)
    want = np.asarray(jm.generate(prompt, max_new_tokens=10,
                                  eos_token_id=eos))
    np.testing.assert_array_equal(got, full[:, :j + 1])
    np.testing.assert_array_equal(got, want)
    # an eos never reached: the per-token path equals the whole-loop path
    np.testing.assert_array_equal(
        tm.generate(prompt, max_new_tokens=10, eos_token_id=-1), full)

