"""The port's fusion compiler (paddle_tpu_torch/compiler) on the CPU:
one golden match per template, near-misses that must not match, escapes
that shrink a candidate or leave it unapplied, the flags, the report,
GPT's rediscovery, and the fused forward and gradients bitwise equal to
the unfused composition (on the CPU the fused entries run their plain
arms, which are that composition). Where the JAX compiler runs, the
per-template site counts equal ``paddle_tpu.compiler.discover``'s on the
same unrolled JAX config.

Tolerance: none, everything here is bitwise (torch.equal)."""

import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)
import dataclasses
import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from paddle_tpu_torch import compiler
from paddle_tpu_torch.compiler import catalog
from paddle_tpu_torch.core.flags import GLOBAL_FLAGS
from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.models.llama import rms_norm
from paddle_tpu_torch.ops.kernels import fused_bias_act as fba
from paddle_tpu_torch.ops.kernels import fused_norm_epilogue as fne

BF = torch.bfloat16
N, H = 256, 128


@pytest.fixture
def flags():
    """Set port flags for one test and restore them after."""
    saved = {}

    def set_(name, value):
        saved.setdefault(name, GLOBAL_FLAGS.get(name))
        GLOBAL_FLAGS.set(name, value)

    yield set_
    for name, value in saved.items():
        GLOBAL_FLAGS.set(name, value)


@pytest.fixture
def spies(monkeypatch):
    """Count calls of the fused entries' forward wrappers (on the CPU,
    their plain arms)."""
    calls = {"norm": 0, "gelu": 0}

    def wrap(key, fn):
        def spy(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return spy

    monkeypatch.setattr(fne, "norm_epilogue_fwd",
                        wrap("norm", fne.norm_epilogue_fwd))
    monkeypatch.setattr(fba, "bias_gelu_fwd",
                        wrap("gelu", fba.bias_gelu_fwd))
    return calls


def _rand(seed, *shape, dtype=torch.float32, mean=0.0, std=1.0):
    rng = np.random.RandomState(seed)
    return torch.from_numpy((mean + std * rng.randn(*shape)).astype(
        np.float32)).to(dtype)


def _vecs(seed, h=H):
    return (_rand(seed, h, std=0.5), _rand(seed + 1, h, mean=1.0, std=0.2),
            _rand(seed + 2, h, std=0.2))


def _by_template(report) -> dict:
    out = {}
    for row in report.sites:
        out[row["template"]] = out.get(row["template"], 0) + 1
    return out


def _fused_equals_plain(fn, *args):
    """Run fn fused and plain; every output must be bitwise equal."""
    got = compiler.auto_fuse(fn)(*args)
    want = fn(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# -- the compositions -------------------------------------------------------

def gpt_ln2(x, o, b, g, beta):
    """GPT's residual + proj bias + ln2."""
    r = x + o + b.to(x.dtype)
    return r, tg._layer_norm(r, g, beta, 1e-5)


def llama_ffn_norm(x, o, g):
    """LLaMA's residual + ffn norm."""
    r = x + o
    return r, rms_norm(r, g, 1e-6)


def gpt_gelu(h, b):
    return (F.gelu(h + b.to(h.dtype), approximate="tanh"),)


def _layer_norm_var1(x, g, b):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, unbiased=True, keepdim=True)
    return ((((x32 - mu) * torch.rsqrt(var + 1e-5)) * g.float() + b.float())
            .to(x.dtype),)


def _layer_norm_axis0(x, g, b):
    x32 = x.float()
    mu = x32.mean(0, keepdim=True)
    var = x32.var(-1, unbiased=False, keepdim=True)
    return ((((x32 - mu) * torch.rsqrt(var + 1e-5)) * g.float() + b.float())
            .to(x.dtype),)


# -- golden matches ---------------------------------------------------------

def test_layer_epilogue_golden(spies):
    args = (_rand(0, 2, N // 2, H, dtype=BF), _rand(1, 2, N // 2, H, dtype=BF),
            *_vecs(2))
    rep = compiler.discover(gpt_ln2, *args)
    assert [(s["template"], s["applied"]) for s in rep.sites] == \
        [("layer_epilogue", True)]
    # both adds, the bias cast, the fp32 cast, mean, var, sub, eps add,
    # rsqrt, the normalizing mul, gain mul, beta add, the cast back
    assert rep.sites[0]["eqns"] == 13
    _fused_equals_plain(gpt_ln2, *args)
    assert spies["norm"] == 1


def test_rms_epilogue_golden(spies):
    args = (_rand(0, N, H, dtype=BF), _rand(1, N, H, dtype=BF),
            _rand(2, H, mean=1.0, std=0.2))
    rep = compiler.discover(llama_ffn_norm, *args)
    assert [(s["template"], s["applied"]) for s in rep.sites] == \
        [("rms_epilogue", True)]
    _fused_equals_plain(llama_ffn_norm, *args)
    assert spies["norm"] == 1


def test_bias_gelu_golden(spies):
    args = (_rand(0, 2, N // 2, 4 * H, dtype=BF), _rand(1, 4 * H, std=0.5))
    rep = compiler.discover(gpt_gelu, *args)
    assert [(s["template"], s["applied"], s["eqns"]) for s in rep.sites] \
        == [("bias_gelu", True, 3)]
    _fused_equals_plain(gpt_gelu, *args)
    assert spies["gelu"] == 1


def test_fp32_chains_match_without_casts():
    args = (_rand(0, N, H), _rand(1, N, H), *_vecs(2))
    rep = compiler.discover(gpt_ln2, *args)
    assert [(s["template"], s["applied"]) for s in rep.sites] == \
        [("layer_epilogue", True)]
    _fused_equals_plain(gpt_ln2, *args)


def test_unsupported_geometry_keeps_the_chain():
    """200 rows fail the kernel's gate: discovered, not applied."""
    args = (_rand(0, 200, H, dtype=BF), _rand(1, 200, H, dtype=BF),
            *_vecs(2))
    rep = compiler.discover(gpt_ln2, *args)
    assert [(s["template"], s["applied"]) for s in rep.sites] == \
        [("layer_epilogue", False)]
    assert rep.n_applied == 0


# -- near-misses ------------------------------------------------------------

@pytest.mark.parametrize("fn", [_layer_norm_var1, _layer_norm_axis0],
                         ids=["var-correction-1", "mean-wrong-axis"])
def test_norm_near_misses_do_not_match(fn):
    _, g, b = _vecs(2)
    rep = compiler.discover(fn, _rand(0, N, H, dtype=BF), g, b)
    assert rep.sites == [] and not rep.errors


def test_exact_gelu_does_not_match():
    rep = compiler.discover(lambda h, b: (F.gelu(h + b.to(h.dtype)),),
                            _rand(0, N, H, dtype=BF), _rand(1, H))
    assert rep.sites == []


def test_rank2_bias_does_not_match():
    rep = compiler.discover(
        lambda h, b: (F.gelu(h + b.to(h.dtype), approximate="tanh"),),
        _rand(0, 2, N // 2, H, dtype=BF), _rand(1, N // 2, H))
    assert rep.sites == []


# -- escapes ----------------------------------------------------------------

def test_escape_falls_back_to_a_smaller_candidate():
    """The inner residual escapes: residual + bias cannot be fused, the
    norm alone is."""
    def fn(x, o, b, g, beta):
        inner = x + o
        r = inner + b.to(x.dtype)
        return r, tg._layer_norm(r, g, beta, 1e-5), inner

    args = (_rand(0, N, H, dtype=BF), _rand(1, N, H, dtype=BF), *_vecs(2))
    rep = compiler.discover(fn, *args)
    assert [(s["template"], s["applied"]) for s in rep.sites] == \
        [("layer_epilogue", True)]
    assert rep.sites[0]["eqns"] == 10       # the norm alone
    _fused_equals_plain(fn, *args)


def test_escape_of_an_inner_value_leaves_the_site_unapplied():
    def fn(x, g, b):
        x32 = x.float()
        mu = x32.mean(-1, keepdim=True)
        var = x32.var(-1, unbiased=False, keepdim=True)
        y = (x32 - mu) * torch.rsqrt(var + 1e-5)
        return (y * g.float() + b.float()).to(x.dtype), mu

    _, g, b = _vecs(2)
    rep = compiler.discover(fn, _rand(0, N, H, dtype=BF), g, b)
    assert [(s["template"], s["applied"], s["note"]) for s in rep.sites] \
        == [("layer_epilogue", False, "unsafe")]


# -- flags, report, errors --------------------------------------------------

def test_fusion_off_calls_the_function_untraced(flags):
    seen = []

    def fn(h, b):
        seen.append(type(h))
        return gpt_gelu(h, b)

    args = (_rand(0, N, H, dtype=BF), _rand(1, H))
    wrapped = compiler.auto_fuse(fn)
    flags("use_auto_fusion", False)
    wrapped(*args)
    wrapped(*args)
    assert seen == [torch.Tensor, torch.Tensor]
    flags("use_auto_fusion", True)
    wrapped(*args)                      # traces once (a fake tensor)
    wrapped(*args)                      # replays the rewritten graph
    assert len(seen) == 3 and seen[2] is not torch.Tensor


@pytest.mark.parametrize("flag,left", [
    ("use_fused_norm_epilogue", {"bias_gelu": 1}),
    ("use_fused_bias_act", {"layer_epilogue": 1})])
def test_kill_switches(flags, flag, left):
    def fn(x, o, b, g, beta, hb):
        r, y = gpt_ln2(x, o, b, g, beta)
        return gpt_gelu(y, hb)[0], r

    args = (_rand(0, N, H, dtype=BF), _rand(1, N, H, dtype=BF), *_vecs(2),
            _rand(5, H))
    assert _by_template(compiler.discover(fn, *args)) == \
        {"layer_epilogue": 1, "bias_gelu": 1}
    flags(flag, False)
    assert _by_template(compiler.discover(fn, *args)) == left
    _fused_equals_plain(fn, *args)


def test_report_shape():
    args = (_rand(0, N, H, dtype=BF), _rand(1, N, H, dtype=BF), *_vecs(2))
    out = compiler.fused_call(("test_report_shape",), gpt_ln2, *args)
    assert len(out) == 2
    rep = compiler.last_report()
    assert {f.name for f in dataclasses.fields(rep)} == {
        "program_hash", "n_sites", "n_applied", "sites",
        "program_cache_hit", "errors"}
    assert len(rep.program_hash) == 16
    int(rep.program_hash, 16)
    assert rep.n_sites == len(rep.sites) == 1 and rep.n_applied == 1
    assert set(rep.sites[0]) == {"template", "applied", "eqns", "note"}
    assert rep.program_cache_hit is False and rep.errors == []
    assert compiler.discover(gpt_ln2, *args).program_hash == \
        rep.program_hash


def test_matcher_errors_are_reported_not_raised(monkeypatch):
    def broken(g, i, node):
        if node.target is torch.ops.aten.rsqrt.default:
            raise RuntimeError("matcher bug")
        return None

    monkeypatch.setattr(catalog, "ALL_TEMPLATES",
                        (("broken", broken),) + catalog.ALL_TEMPLATES)
    args = (_rand(0, N, H, dtype=BF), _rand(1, N, H, dtype=BF), *_vecs(2))
    rep = compiler.discover(gpt_ln2, *args)
    assert len(rep.errors) == 1 and "matcher bug" in rep.errors[0]
    _fused_equals_plain(gpt_ln2, *args)


# -- GPT --------------------------------------------------------------------

GPT_SHAPE = dict(vocab_size=128, hidden=256, n_layers=2, n_heads=2,
                 seq_len=256)


def _gpt(remat, seed=0):
    cfg = tg.GPTConfig(**GPT_SHAPE, dtype=BF, remat=remat)
    params = tg.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():        # LayerNorm and biases off their init values
        for name, leaf in list(params["blocks"].items()) + [
                ("lnf_g", params["lnf_g"]), ("lnf_b", params["lnf_b"])]:
            if name.endswith(("_g", "_b")):
                leaf.add_(0.1 * torch.randn(leaf.shape, generator=gen))
    rng = np.random.RandomState(seed)
    tokens = torch.from_numpy(rng.randint(0, 128, size=(1, 256)))
    labels = torch.from_numpy(rng.randint(0, 128, size=(1, 256)))
    return cfg, params, tokens, labels


@pytest.mark.parametrize("remat", [False, True])
def test_gpt_rediscovers_layer_epilogues_and_bias_gelu(remat):
    """2L + 1 layer epilogues (ln1 and ln2 of each layer, lnf) and L bias
    gelus, all applied. Layer 0's ln1 is norm-only: its input adds wpe
    with implicit broadcasting, which aten records without an expand, so
    the residual candidate's shape check fails (the JAX pass sees a
    broadcast_in_dim and fuses the add; the count is the same)."""
    cfg, params, tokens, _ = _gpt(remat)
    rep = compiler.discover(functools.partial(tg._model_apply_unfused,
                                              cfg=cfg), params, tokens)
    L = cfg.n_layers
    assert _by_template(rep) == {"layer_epilogue": 2 * L + 1, "bias_gelu": L}
    assert rep.n_applied == rep.n_sites and not rep.errors


@pytest.mark.parametrize("remat", [False, True])
def test_gpt_fused_forward_and_grads_are_bitwise_unfused(flags, spies,
                                                         remat):
    cfg, params, tokens, labels = _gpt(remat)
    leaves = jax.tree_util.tree_leaves(params)
    runs = []
    for on in (False, True):
        flags("use_auto_fusion", on)
        for p in leaves:
            p.requires_grad_(True)
        hidden, _ = tg.model_apply(params, tokens, cfg, return_hidden=True)
        loss = tg.loss_fn(params, tokens, labels, cfg)
        runs.append((hidden.detach(), loss.detach(),
                     torch.autograd.grad(loss, leaves)))
    (h0, l0, g0), (h1, l1, g1) = runs
    L = cfg.n_layers
    # the fused run: two forwards, each 2L + 1 epilogues and L gelus
    # (with remat, each block's are recomputed in the backward)
    rec = 1 if remat else 0
    assert spies["norm"] == 2 * (2 * L + 1) + rec * 2 * L
    assert spies["gelu"] == 2 * L + rec * L
    assert torch.equal(h0, h1) and torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


@pytest.mark.parametrize("remat", [False, True])
def test_gpt_site_counts_match_the_jax_compiler(remat):
    _needs_the_jax_compiler()
    from paddle_tpu import compiler as jcompiler
    from paddle_tpu.models import gpt as jg

    jcfg = jg.GPTConfig(**GPT_SHAPE, dtype=jnp.bfloat16, unroll=True,
                        remat=remat)
    jp = jg.init_params(jcfg, jax.random.PRNGKey(0))
    tokens = np.random.RandomState(0).randint(0, 128, size=(1, 256))
    jrep = jcompiler.discover(functools.partial(jg._model_apply_unfused,
                                                cfg=jcfg),
                              jp, jnp.asarray(tokens))
    cfg, params, _, _ = _gpt(remat)
    rep = compiler.discover(functools.partial(tg._model_apply_unfused,
                                              cfg=cfg),
                            params, torch.from_numpy(tokens))
    # per template, applied or not: the JAX K7 gate is off on the
    # harness's 8 virtual devices
    assert _by_template(rep) == _by_template(jrep)


def _needs_the_jax_compiler():
    if not hasattr(jax.core, "Var"):
        pytest.skip("this jax has no jax.core.Var, which the JAX compiler "
                    "(paddle_tpu.compiler) needs")


# -- LLaMA: rope_attention and swiglu ---------------------------------------

def _rope_inputs(seed=0, B=1, S=128, h=2, d=128, dtype=BF, kv_heads=None):
    from paddle_tpu_torch.models.llama import LlamaConfig, rope_angles

    q = _rand(seed, B, S, h, d, dtype=dtype)
    k = _rand(seed + 1, B, S, kv_heads or h, d, dtype=dtype)
    v = _rand(seed + 2, B, S, kv_heads or h, d, dtype=dtype)
    cos, sin = rope_angles(LlamaConfig(hidden=h * d, n_heads=h),
                           torch.arange(S))
    return q, k, v, cos[None, :, None, :], sin[None, :, None, :]


def _rope_flash(q, k, v, cos, sin, rep=1, escape=False):
    from paddle_tpu_torch.models.llama import _repeat_kv, apply_rope
    from paddle_tpu_torch.ops.kernels.flash_attention import \
        flash_attention_raw

    qr, kr = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    o = flash_attention_raw(qr, _repeat_kv(kr, rep), _repeat_kv(v, rep),
                            causal=True)
    return (o, kr) if escape else (o,)


def _rope_sites(rep):
    return [(s["template"], s["applied"], s["eqns"]) for s in rep.sites]


def test_rope_attention_fuses_both_rotations_for_mha():
    args = _rope_inputs()
    rep = compiler.discover(_rope_flash, *args)
    # flash + 12 nodes per rotation: the fp32 cast, the split and its two
    # halves, four table products, sub, add, cat, the cast back
    assert _rope_sites(rep) == [("rope_attention", True, 25)]
    _fused_equals_plain(_rope_flash, *args)


def test_rope_attention_is_q_only_when_k_escapes():
    fn = functools.partial(_rope_flash, escape=True)
    args = _rope_inputs(1)
    assert _rope_sites(compiler.discover(fn, *args)) == \
        [("rope_attention", True, 13)]
    _fused_equals_plain(fn, *args)


def test_rope_attention_is_q_only_under_gqa():
    """The k rotation hides behind the repeat: the site reads the
    repeated, rotated k (the matcher does not peel the repeat)."""
    fn = functools.partial(_rope_flash, rep=2)
    args = _rope_inputs(2, h=4, kv_heads=2, dtype=torch.float32)
    # fp32: no casts, 10 nodes of the q rotation + flash
    assert _rope_sites(compiler.discover(fn, *args)) == \
        [("rope_attention", True, 11)]
    _fused_equals_plain(fn, *args)


def test_rope_with_other_tables_for_k_fuses_q_only():
    def fn(q, k, v, cos, sin):
        from paddle_tpu_torch.models.llama import apply_rope
        from paddle_tpu_torch.ops.kernels.flash_attention import \
            flash_attention_raw

        return (flash_attention_raw(apply_rope(q, cos, sin),
                                    apply_rope(k, sin, cos), v, causal=True),)

    args = _rope_inputs(3)
    assert _rope_sites(compiler.discover(fn, *args)) == \
        [("rope_attention", True, 13)]
    _fused_equals_plain(fn, *args)


def test_swiglu_golden():
    def fn(g, u):
        return (F.silu(g.float()).to(g.dtype) * u,)

    args = (_rand(0, 2, N // 2, 4 * H, dtype=BF), _rand(1, 2, N // 2, 4 * H,
                                                      dtype=BF))
    assert [(s["template"], s["applied"], s["eqns"])
            for s in compiler.discover(fn, *args).sites] == \
        [("swiglu", True, 4)]
    _fused_equals_plain(fn, *args)


def test_swiglu_near_miss_does_not_match():
    """silu in bf16 (no fp32 round trip) is another function."""
    rep = compiler.discover(lambda g, u: (F.silu(g) * u,),
                            _rand(0, N, H, dtype=BF), _rand(1, N, H, dtype=BF))
    assert rep.sites == []


LLAMA_SHAPE = dict(vocab_size=256, hidden=512, n_layers=3, n_heads=4,
                   ffn_hidden=768, max_seq_len=256)


def _llama(dtype, n_kv_heads=2, seed=0):
    from paddle_tpu_torch.models import llama as tl

    cfg = tl.LlamaConfig(**LLAMA_SHAPE, n_kv_heads=n_kv_heads, dtype=dtype,
                         param_dtype=dtype)
    params = tl.init_llama_params(cfg, torch.Generator().manual_seed(seed),
                                  "cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():        # norm gains off their init values
        for name in ("attn_norm", "ffn_norm"):
            params["blocks"][name].add_(0.1 * torch.randn(
                params["blocks"][name].shape, generator=gen).to(dtype))
    tokens = torch.from_numpy(np.random.RandomState(seed).randint(
        0, 256, size=(2, 128)))
    return tl, cfg, params, tokens


@pytest.mark.parametrize("n_kv_heads", [2, 4], ids=["gqa", "mha"])
def test_llama_prefill_fuses_every_layer(n_kv_heads):
    """2L + 1 rms epilogues, L q-only rope sites (the rotated k escapes
    into the cache) and L swiglus, all applied: the rope tables are shared
    by every layer and no site consumes them."""
    tl, cfg, params, tokens = _llama(BF, n_kv_heads)
    m = tl.LlamaForCausalLM(cfg, params=params, max_batch=2, device="cpu")
    rep = compiler.discover(functools.partial(tl._prefill_unfused, cfg=cfg),
                            params, tokens, m._empty_cache(2))
    L = cfg.n_layers
    assert _by_template(rep) == {"rms_epilogue": 2 * L + 1,
                                 "rope_attention": L, "swiglu": L}
    assert rep.n_applied == rep.n_sites and not rep.errors
    assert {s["eqns"] for s in rep.sites
            if s["template"] == "rope_attention"} == {13}


def test_llama_apply_fuses_both_rotations_for_mha():
    tl, cfg, params, tokens = _llama(BF, 4)
    rep = compiler.discover(functools.partial(tl._llama_apply_unfused,
                                              cfg=cfg), params, tokens)
    assert {s["eqns"] for s in rep.sites
            if s["template"] == "rope_attention"} == {25}
    assert rep.n_applied == rep.n_sites == 2 * 3 + 1 + 3 + 3


@pytest.mark.parametrize("dtype", [torch.float32, BF])
def test_llama_fused_prefill_is_bitwise_unfused(flags, dtype):
    """Logits and the filled cache, fusion on against off."""
    tl, cfg, params, tokens = _llama(dtype)
    m = tl.LlamaForCausalLM(cfg, params=params, max_batch=2, device="cpu")
    runs = []
    for on in (True, False):
        flags("use_auto_fusion", on)
        cache = m._empty_cache(2)
        logits, cache = m._prefill_impl(tokens, cache)
        runs.append((logits, cache["k"], cache["v"]))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_rope_kill_switch(flags):
    tl, cfg, params, tokens = _llama(BF)
    fn = functools.partial(tl._llama_apply_unfused, cfg=cfg)
    flags("use_fused_rope_attention", False)
    assert _by_template(compiler.discover(fn, params, tokens)) == \
        {"rms_epilogue": 7, "swiglu": 3}
    flags("use_fused_bias_act", False)
    assert _by_template(compiler.discover(fn, params, tokens)) == \
        {"rms_epilogue": 7}
