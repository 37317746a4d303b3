"""The port's split flash backward (K3's plain version, in its fused-qkv
and separate modes) and its route against the JAX reference's Pallas
kernels (interpret mode on the CPU):

- the fused-qkv backward with ``flash_attention_fused_dqkv`` off, through
  the port's autograd, against ``_flash_bwd(..., fused_dqkv=False)`` (the
  reference's split dq + dk/dv kernels and their concatenate);
- ``flash_bwd_sep_plain`` against ``_flash_bwd`` on separate q, k, v;
- the port's autograd of ``flash_attention_raw`` against ``jax.grad`` of
  the reference's;
- ``fused_dqkv_ok`` against the reference's gate over a grid of shapes,
  and the flag: defined, on by default, read from the environment, and
  the route it and the gate choose.

B 2, S 256, (h 4, d 64) and (h 2, d 128), causal and not, fp32; atol and
rtol 1e-5 (summation order only)."""

import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.core.flags import GLOBAL_FLAGS as JFLAGS
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch.core.flags import GLOBAL_FLAGS
from paddle_tpu_torch.ops.kernels import flash_attention as tfa

ROOT = Path(__file__).resolve().parents[1]
B, S = 2, 256
TOL = 1e-5
CASES = [(4, 64, True), (4, 64, False), (2, 128, True), (2, 128, False)]


@pytest.fixture
def fused_dqkv():
    """Set the port's (and the reference's) flag; restored after."""
    old = GLOBAL_FLAGS.get("flash_attention_fused_dqkv")
    jold = JFLAGS.get("flash_attention_fused_dqkv")

    def set_(value: bool):
        GLOBAL_FLAGS.set("flash_attention_fused_dqkv", value)
        JFLAGS.set("flash_attention_fused_dqkv", value)

    yield set_
    GLOBAL_FLAGS.set("flash_attention_fused_dqkv", old)
    JFLAGS.set("flash_attention_fused_dqkv", jold)


def _data(shape, seed):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shape]


@pytest.mark.parametrize("h,d,causal", CASES)
def test_split_route_matches_reference_split(fused_dqkv, h, d, causal):
    """Flag off: the port's autograd takes K3's route (counted), and its
    dqkv equals the reference's split kernels' concatenated output."""
    qkv, do = _data([(B, S, 3 * h * d), (B, S, h, d)], seed=d + causal)
    scale = d ** -0.5
    jq = jnp.asarray(qkv)
    jo, jlse = jfa._flash_fwd(jq, None, None, causal, scale, with_lse=True,
                              n_heads=h)
    want = jfa._flash_bwd(jq, None, None, jo, jlse, jnp.asarray(do), causal,
                          scale, n_heads=h, fused_dqkv=False)
    fused_dqkv(False)
    before = dict(tfa.BWD_ROUTES)
    x = torch.from_numpy(qkv).requires_grad_(True)
    out = tfa.flash_attention_qkv(x, h, causal=causal)
    (got,) = torch.autograd.grad(out, x, torch.from_numpy(do))
    assert tfa.BWD_ROUTES == {"merged": before["merged"],
                              "split": before["split"] + 1}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("h,d,causal", CASES)
def test_sep_plain_backward_matches_reference(h, d, causal):
    q, k, v, do = _data([(B, S, h, d)] * 4, seed=3 * d + causal)
    scale = d ** -0.5
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    jo, jlse = jfa._flash_fwd(jq, jk, jv, causal, scale, with_lse=True)
    want = jfa._flash_bwd(jq, jk, jv, jo, jlse, jnp.asarray(do), causal,
                          scale)
    o, lse = tfa.flash_fwd_sep(*(torch.from_numpy(a) for a in (q, k, v)),
                               causal, scale)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, :, 0, :],
                               atol=TOL, rtol=TOL)
    got = tfa.flash_bwd_sep(*(torch.from_numpy(a) for a in (q, k, v)), o,
                            lse, torch.from_numpy(do), causal, scale)
    for g, w in zip(got, want):
        assert g.shape == (B, S, h, d)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=TOL)
    # the fused-qkv mode on the same values, packed: the same numbers
    qkv = torch.cat([torch.from_numpy(a).reshape(B, S, h * d)
                     for a in (q, k, v)], dim=-1)
    dqkv = tfa.flash_bwd_split(qkv, o, lse, torch.from_numpy(do), h, causal,
                               scale)
    assert torch.equal(dqkv, torch.cat([g.reshape(B, S, h * d)
                                        for g in got], dim=-1))


@pytest.mark.parametrize("h,d,causal", CASES[::3])
def test_raw_autograd_matches_jax_grad(h, d, causal):
    q, k, v, do = _data([(B, S, h, d)] * 4, seed=7)

    def f(q, k, v):
        return (jfa.flash_attention_raw(q, k, v, causal=causal)
                * jnp.asarray(do)).sum()

    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                            for a in (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = tfa.flash_attention_raw(*leaves, causal=causal)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=TOL)


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_gate_matches_reference(hd, itemsize):
    for s in (128, 256, 384, 512, 640, 1024, 1536, 2048, 3072, 4096, 6144,
              8192, 12288, 16384):
        assert tfa.fused_dqkv_ok(s, hd, itemsize) == \
            jfa._fused_dqkv_ok(s, hd, itemsize), (s, hd, itemsize)


def test_flag_defined_on_by_default_and_read_from_the_environment():
    assert GLOBAL_FLAGS.get("flash_attention_fused_dqkv") is True
    code = ("from paddle_tpu_torch.core.flags import GLOBAL_FLAGS as F; "
            "print(F.get('flash_attention_fused_dqkv'))")
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               FLAGS_flash_attention_fused_dqkv="0")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False"]


@pytest.mark.parametrize("flag,S_,route", [
    (True, 256, "merged"),      # the gate holds: K2
    (False, 256, "split"),      # the flag sends every backward to K3
    (True, 4096, "split")])     # 4 * 4096 * 128 * 4 B = 8 MiB > 6 MiB: K3
def test_route(fused_dqkv, flag, S_, route):
    h, d = 1, 128
    fused_dqkv(flag)
    qkv = torch.zeros((1, S_, 3 * h * d), requires_grad=True)
    assert tfa.fused_dqkv_ok(S_, d, 4) == (route == "merged" or not flag)
    before = dict(tfa.BWD_ROUTES)
    tfa.flash_attention_qkv(qkv, h).sum().backward()
    assert tfa.BWD_ROUTES[route] == before[route] + 1
    assert sum(tfa.BWD_ROUTES.values()) == sum(before.values()) + 1
