"""The port's incubate/nn/functional/__init__.py against the reference's
(paddle_tpu/incubate/nn/functional/__init__.py), on the CPU: its ops
(``fused_rms_norm``, ``fused_layer_norm``, ``fused_rotary_position_
embedding``, ``fused_bias_act``, ``masked_multihead_attention``) and its
functions, on tests/torch_incubate_cases.py's cases, forward and the vjp
of a seeded cotangent; the reference test's cases
(tests/test_llama_incubate.py:70-117) on both packages; and the slice: a
2-layer fp32 LLaMA written from the incubate functionals
(tests/torch_incubate_llama.py) in both packages, prefill logits, the
greedy stream through ``masked_multihead_attention`` and the caches, and
each package's composition against its own ``llama_apply``.

The bar: fp32 outputs within rtol 1e-6 of the reference (1e-6 of the
largest magnitude for entries that cancel), integers exact, the vjp
within rtol 1e-5; the flash routes (no mask at S 128, d 64: the port's
plain version of K1-sep against the reference's flash path) at 2e-6 of
the largest magnitude (two fp32 softmaxes summed in other orders); the
slice's logits and caches at 1e-5 of the largest magnitude and its
streams exact (the same bar as tests/test_torch_llama_engine.py's fp32
cases).
"""

import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as ref
import paddle_tpu.incubate.nn.functional as ref_F
import paddle_tpu_torch as port
import paddle_tpu_torch.incubate.nn.functional as port_F
from paddle_tpu.core.dispatch import OpDef as RefOpDef

import torch_incubate_llama as IL
from torch_eager_common import freeze_after_case, frozen_heap  # noqa: F401
from torch_incubate_cases import FUNC_CASES, OP_CASES
from torch_ops_cases import CONTRACTS, assert_same, contract_case, f32
from torch_ops_common import hold, npy, opdef, reference_op_flags, wrappers

port.set_device("cpu")

_MODULE = "paddle_tpu/incubate/nn/functional/__init__.py"
REF_OPS = wrappers(ref_F)
PORT_OPS = wrappers(port_F)
_OP_PARAMS = [(n, cid) for n in sorted(REF_OPS) if n in OP_CASES
              for cid, _, _ in OP_CASES[n]]
_FUNC_PARAMS = [(n, cid) for n in sorted(FUNC_CASES)
                for cid, _, _ in FUNC_CASES[n]]
# the contract ops incubate/nn/ adds to the port's registry
INCUBATE_CONTRACT_OPS = sorted(
    set(reference_op_flags(_MODULE))
    | set(reference_op_flags(
        "paddle_tpu/incubate/nn/functional/fused_parity.py")))


def test_functional_registrations_and_names_are_the_references():
    flags = reference_op_flags(_MODULE)
    assert set(flags) == {"fused_rms_norm", "fused_layer_norm",
                          "fused_rotary_position_embedding",
                          "fused_bias_act", "masked_multihead_attention"}
    for name, (diff, amp) in flags.items():
        p = port.OP_REGISTRY[name]
        assert (p.differentiable, p.amp_policy) == (diff, amp), name
    assert port_F.__all__ == ref_F.__all__
    import paddle_tpu.incubate as ref_inc
    import paddle_tpu.incubate.asp as ref_asp
    import paddle_tpu.incubate.optimizer as ref_opt
    import paddle_tpu_torch.incubate as port_inc
    import paddle_tpu_torch.incubate.asp as port_asp
    import paddle_tpu_torch.incubate.optimizer as port_opt

    def public(m):
        """``__all__`` and every public function or class the module
        defines or re-exports from its package."""
        return set(m.__all__) | {
            n for n, v in vars(m).items() if not n.startswith("_")
            and callable(v) and getattr(v, "__module__", "").startswith(
                m.__name__.split(".")[0] + ".incubate")}

    for r, p in ((ref_inc.nn, port_inc.nn), (ref_F, port_F),
                 (ref_opt, port_opt), (ref_asp, port_asp)):
        assert public(r) - set(dir(p)) == set(), r.__name__


def test_the_39_contract_ops_are_registered():
    """With the incubate modules imported, every contract op of
    incubate/nn/functional (its 5 and fused_parity's 34) is in the
    port's registry: 39 of artifacts/op_contracts.json."""
    assert len(INCUBATE_CONTRACT_OPS) == 39
    assert set(INCUBATE_CONTRACT_OPS) <= set(CONTRACTS)
    assert [n for n in INCUBATE_CONTRACT_OPS
            if n not in port.OP_REGISTRY] == []


@pytest.mark.parametrize("name,cid", _OP_PARAMS)
def test_functional_op_against_reference(name, cid):
    factory, opts = next((f, o) for c, f, o in OP_CASES[name] if c == cid)
    r_def = opdef(REF_OPS[name], RefOpDef)
    case = contract_case(name, r_def.impl) if factory is None else factory()
    opts = {"differentiable": r_def.differentiable, **opts}
    hold(REF_OPS[name], PORT_OPS[name], case, name=f"{name}[{cid}]", **opts)


@pytest.mark.parametrize("name,cid", _FUNC_PARAMS)
def test_function_against_reference(name, cid):
    factory, opts = next((f, o) for c, f, o in FUNC_CASES[name] if c == cid)
    hold(getattr(ref_F, name), getattr(port_F, name), factory(),
         name=f"{name}[{cid}]", **opts)


def test_weight_only_linear_output_dtype_is_the_references():
    """bf16 activations times the int8 weight widened to bf16 and scaled
    by fp32 scales: fp32 out in both packages (JAX's promotion)."""
    w = f32(16, 8)
    x = f32(4, 16, seed=1)
    outs = {}
    for pkg, F in ((ref, ref_F), (port, port_F)):
        wq, s = F.weight_quantize(pkg.to_tensor(w))
        y = F.weight_only_linear(pkg.to_tensor(x).astype("bfloat16"), wq,
                                 weight_scale=s)
        assert str(y.dtype).split(".")[-1] == "float32", (pkg.__name__,
                                                          y.dtype)
        assert str(s.dtype).split(".")[-1] == "float32"
        outs[pkg.__name__] = npy(y)
    np.testing.assert_allclose(outs["paddle_tpu_torch"], outs["paddle_tpu"],
                               rtol=1e-6, atol=1e-6)


def test_masked_multihead_attention_writes_in_place_and_refuses():
    """The port writes the cache it is given, and returns it; the
    reference's returned cache equals it. The variants the reference
    refuses raise in both."""
    x, cache = f32(3, 3 * 2 * 8), f32(2, 3, 2, 6, 8, seed=1)
    lens = np.array([0, 3, 5], np.int32)
    pc = port.to_tensor(cache)
    _, out_c = port_F.masked_multihead_attention(
        port.to_tensor(x), cache_kv=pc, sequence_lengths=port.to_tensor(lens))
    assert out_c._data.data_ptr() == pc._data.data_ptr()
    _, ref_c = ref_F.masked_multihead_attention(
        ref.to_tensor(x), cache_kv=ref.to_tensor(cache),
        sequence_lengths=ref.to_tensor(lens))
    np.testing.assert_array_equal(npy(pc), npy(ref_c))
    changed = np.nonzero((npy(pc) != cache).any(axis=(0, 2, 4)))
    assert list(zip(*changed)) == [(0, 0), (1, 3), (2, 5)]
    for F, pkg in ((ref_F, ref), (port_F, port)):
        for kw in ({"bias": pkg.to_tensor(f32(48))}, {"rotary_emb_dims": 1},
                   {"out_scale": 1.0}):
            with pytest.raises(NotImplementedError):
                F.masked_multihead_attention(pkg.to_tensor(x),
                                             cache_kv=pkg.to_tensor(cache),
                                             **kw)


def test_memory_efficient_attention_scale_defect_m():
    """Defect M: the reference takes ``scale`` and drops it. The port
    scales the queries by scale * sqrt(d) first, which equals the
    reference's call on those queries; without a scale the two agree."""
    q, k, v = (f32(2, 5, 2, 4, seed=s) for s in range(3))
    s = 0.7
    r_plain = npy(ref_F.memory_efficient_attention(
        *(ref.to_tensor(t) for t in (q, k, v)), scale=s))
    r_scaled = npy(ref_F.memory_efficient_attention(
        ref.to_tensor(q * np.float32(s * 2.0)), ref.to_tensor(k),
        ref.to_tensor(v)))
    p_scaled = npy(port_F.memory_efficient_attention(
        *(port.to_tensor(t) for t in (q, k, v)), scale=s))
    assert_same(p_scaled, r_scaled, 1e-6, "scaled")
    assert np.abs(r_plain - r_scaled).max() > 1e-2
    p_plain = npy(port_F.memory_efficient_attention(
        *(port.to_tensor(t) for t in (q, k, v))))
    assert_same(p_plain, npy(ref_F.memory_efficient_attention(
        *(ref.to_tensor(t) for t in (q, k, v)))), 1e-6, "unscaled")


@pytest.mark.parametrize("pkg", [ref, port], ids=["reference", "port"])
def test_reference_cases_llama_incubate(pkg):
    """tests/test_llama_incubate.py:70-117's cases on either package."""
    F = pkg.incubate.nn.functional
    x = pkg.to_tensor(f32(2, 8, 16))
    y = F.fused_rms_norm(x, pkg.ones([16]))
    xn = npy(x)
    np.testing.assert_allclose(
        npy(y), xn / np.sqrt((xn ** 2).mean(-1, keepdims=True) + 1e-5),
        rtol=1e-5)
    q, k = pkg.to_tensor(f32(1, 8, 2, 16)), pkg.to_tensor(f32(1, 8, 2, 16,
                                                              seed=1))
    qr, kr, none = F.fused_rotary_position_embedding(q, k)
    assert none is None and list(qr.shape) == [1, 8, 2, 16]
    np.testing.assert_allclose(npy(qr)[:, 0], npy(q)[:, 0], rtol=1e-5)
    rng = np.random.RandomState(0)
    w = pkg.to_tensor(rng.randn(16, 8).astype(np.float32))
    xx = pkg.to_tensor(rng.randn(4, 16).astype(np.float32))
    wq, scale = F.weight_quantize(w)
    np.testing.assert_allclose(
        npy(F.weight_only_linear(xx, wq, weight_scale=scale)),
        npy(xx) @ npy(w), rtol=0.06, atol=0.15)
    rng = np.random.RandomState(0)
    args = [pkg.to_tensor(rng.randn(*s).astype(np.float32))
            for s in ((2, 4, 8), (8, 4), (4, 8, 16), (4, 16, 8))]
    assert list(F.fused_moe(*args, moe_topk=2).shape) == [2, 4, 8]


# -- the slice: LLaMA from the incubate functionals ---------------------------

_CFG = dict(vocab_size=128, hidden=64, n_layers=2, n_heads=4, n_kv_heads=4,
            ffn_hidden=96, max_seq_len=64)
_T, _NEW, _MAX_SEQ = 9, 5, 16


@pytest.fixture(scope="module")
def llama():
    from paddle_tpu.core.flags import GLOBAL_FLAGS as ref_flags
    from paddle_tpu.models.llama import LlamaConfig as RefCfg
    from paddle_tpu.models.llama import init_llama_params
    from paddle_tpu_torch.models.llama import LlamaConfig
    from paddle_tpu_torch.utils.convert import params_from_jax

    jax.config.update("jax_default_matmul_precision", "highest")
    rc = RefCfg(**_CFG, dtype=jnp.float32, param_dtype=jnp.float32)
    pc = LlamaConfig(**_CFG, dtype=torch.float32, param_dtype=torch.float32)
    rp = init_llama_params(rc, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, rp)
    pp = params_from_jax(np_params, "cpu")
    toks = np.random.RandomState(3).randint(0, 128, (2, _T)).astype(np.int32)
    was = ref_flags.get("use_auto_fusion")
    ref_flags.set("use_auto_fusion", False)
    try:
        yield rc, pc, rp, np_params, pp, toks
    finally:
        ref_flags.set("use_auto_fusion", was)


def _run(pkg, cfg, params, toks):
    w = IL.weights(pkg, params, cfg.n_layers)
    logits = []
    picks, kv = IL.generate(pkg, w, pkg.to_tensor(toks), cfg, _NEW, _MAX_SEQ,
                            "float32",
                            on_logits=lambda s, l: logits.append(npy(l)))
    return (np.stack([npy(p) for p in picks], 1), logits,
            [npy(c) for c in kv])


def _close(a, b, what, rtol=1e-5):
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.abs(b).max(),
                               err_msg=what)


def test_incubate_llama_slice_against_reference(llama):
    """Prefill logits, every decode step's logits, the greedy stream and
    the caches of the composition, port against reference; and each
    package's composition against its own llama_apply over the grown
    sequence (the decode's logits are the full forward's at its
    position)."""
    from paddle_tpu.models.llama import llama_apply as ref_apply
    from paddle_tpu_torch.models.llama import llama_apply as port_apply

    rc, pc, rp, np_params, pp, toks = llama
    r_picks, r_logits, r_kv = _run(ref, rc, np_params, toks)
    p_picks, p_logits, p_kv = _run(port, pc, pp, toks)
    np.testing.assert_array_equal(p_picks, r_picks)
    for s, (a, b) in enumerate(zip(p_logits, r_logits)):
        _close(a, b, f"step {s} logits")
    for i, (a, b) in enumerate(zip(p_kv, r_kv)):
        _close(a, b, f"layer {i} cache")
    grown = np.concatenate([toks, p_picks[:, :-1]], 1)
    full_r = np.asarray(ref_apply(rp, jnp.asarray(grown), rc))
    full_p = port_apply(pp, torch.from_numpy(grown), pc).numpy()
    for s in range(_NEW):
        _close(r_logits[s], full_r[:, _T - 1 + s], f"reference step {s}")
        _close(p_logits[s], full_p[:, _T - 1 + s], f"port step {s}")
