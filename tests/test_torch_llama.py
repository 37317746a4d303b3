"""LLaMA building blocks of the PyTorch port against the JAX reference
(fp32 atol/rtol 1e-6 for elementwise blocks, which differ only in the
last bits of transcendental functions), and the parameter tree's
names, shapes and dtypes."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models import llama as jl
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.utils.convert import params_from_jax

SHAPE = dict(vocab_size=64, hidden=32, n_layers=2, n_heads=4, n_kv_heads=2,
             ffn_hidden=48, max_seq_len=64)
TOL = 1e-6


def _cfgs(dtype=np.float32):
    jd = jnp.dtype(dtype)
    td = torch.float32 if dtype == np.float32 else torch.bfloat16
    return (jl.LlamaConfig(**SHAPE, dtype=jd, param_dtype=jd),
            tl.LlamaConfig(**SHAPE, dtype=td, param_dtype=td))


def test_presets_match():
    for name in ("llama2-7b", "llama3-8b", "tinyllama"):
        j, t = jl.llama_presets(name), tl.llama_presets(name)
        for f in ("vocab_size", "hidden", "n_layers", "n_heads",
                  "n_kv_heads", "ffn_hidden", "max_seq_len", "rope_theta",
                  "rms_eps", "head_dim"):
            assert getattr(j, f) == getattr(t, f), (name, f)


def test_param_tree_names_shapes_dtypes():
    jc, tc = _cfgs()
    jp = jax.tree.map(np.asarray, jl.init_llama_params(jc, jax.random.PRNGKey(0)))
    tp = tl.init_llama_params(tc, torch.Generator().manual_seed(0), "cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tflat = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), tp))[0])
    assert len(jflat) == len(tflat)
    for path, leaf in jflat:
        assert tflat[path].shape == leaf.shape and \
            tflat[path].dtype == leaf.dtype, path


def test_rms_norm_and_rope_match():
    jc, tc = _cfgs()
    rng = np.random.RandomState(0)
    x = rng.standard_normal((3, 5, 4, 8)).astype(np.float32)
    g = rng.standard_normal(8).astype(np.float32)
    np.testing.assert_allclose(
        tl.rms_norm(torch.from_numpy(x), torch.from_numpy(g), 1e-5).numpy(),
        np.asarray(jl.rms_norm(jnp.asarray(x), jnp.asarray(g), 1e-5)),
        atol=TOL, rtol=TOL)
    pos = rng.randint(0, 60, size=(3, 5)).astype(np.int32)
    jcos, jsin = jl.rope_angles(jc, jnp.asarray(pos))
    tcos, tsin = tl.rope_angles(tc, torch.from_numpy(pos))
    np.testing.assert_allclose(tcos.numpy(), np.asarray(jcos), atol=TOL)
    np.testing.assert_allclose(tsin.numpy(), np.asarray(jsin), atol=TOL)
    jr = jl.apply_rope(jnp.asarray(x), jcos[:, :, None], jsin[:, :, None])
    tr = tl.apply_rope(torch.from_numpy(x), tcos[:, :, None],
                       tsin[:, :, None])
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_quantize_weights_int8_tree_bit_equal(dtype):
    jc, tc = _cfgs(dtype)
    jp = jl.init_llama_params(jc, jax.random.PRNGKey(1))
    want = jax.tree.map(np.asarray, jl.quantize_weights_int8(jp))
    got = tl.quantize_weights_int8(
        params_from_jax(jax.tree.map(np.asarray, jp), "cpu"))
    assert isinstance(got["blocks"]["wq"], tuple)
    assert not isinstance(got["blocks"]["attn_norm"], tuple)
    back = params_from_jax(want, "cpu")
    flat_w = jax.tree_util.tree_leaves(back)
    flat_g = jax.tree_util.tree_leaves(got)
    assert len(flat_w) == len(flat_g)
    for a, b in zip(flat_w, flat_g):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
