"""The port's torch integer-op versions of ``jax.random``'s PRNGKey,
fold_in and float32 gumbel are bit-equal to JAX (threefry2x32, the
partitionable bit layout this JAX runs with, and XLA's CPU log)."""

import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu_torch.core import jax_random as jr

SEEDS = [0, 1, 7, 12345, 2 ** 31 - 1]


def test_jax_runs_the_pinned_prng_mode():
    assert jax.config.jax_threefry_partitionable
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("pos", [0, 5, 1000, 2 ** 20 + 3])
def test_prng_key_and_fold_in_bit_equal(pos):
    keys = jr.fold_in(jr.prng_key(torch.tensor(SEEDS)),
                      torch.tensor([pos] * len(SEEDS)))
    for i, seed in enumerate(SEEDS):
        k = jax.random.fold_in(jax.random.PRNGKey(seed), pos)
        np.testing.assert_array_equal(
            keys[i].numpy(),
            np.asarray(jax.random.key_data(k)).astype(np.int64))


@pytest.mark.parametrize("V", [1, 7, 512, 4099])
def test_gumbel_bit_equal(V):
    pos = [0, 3, 77, 1000, 65536]
    keys = jr.fold_in(jr.prng_key(torch.tensor(SEEDS)), torch.tensor(pos))
    got = jr.gumbel(keys, V).numpy()
    for i, (seed, p) in enumerate(zip(SEEDS, pos)):
        k = jax.random.fold_in(jax.random.PRNGKey(seed), p)
        want = np.asarray(jax.random.gumbel(k, (V,), jnp.float32))
        np.testing.assert_array_equal(got[i], want)


def test_xla_log_bit_equal():
    rng = np.random.RandomState(0)
    x = np.concatenate([
        rng.random_sample(20000).astype(np.float32),
        (np.abs(rng.standard_normal(20000)) * 80).astype(np.float32),
        np.float32([np.finfo(np.float32).tiny, 1.0, 0.5, 2.0])])
    x = x[x > 0]
    np.testing.assert_array_equal(jr.xla_log(torch.from_numpy(x)).numpy(),
                                  np.asarray(jnp.log(jnp.asarray(x))))


def test_split_pinned_values():
    np.testing.assert_array_equal(
        jr.split(jr.prng_key(0)).numpy(),
        [[1797259609, 2579123966], [928981903, 3453687069]])


@pytest.mark.parametrize("n", [2, 3, 7])
def test_split_bit_equal(n):
    for seed in SEEDS:
        got = jr.split(jr.prng_key(seed), n)
        want = jax.random.split(jax.random.PRNGKey(seed), n)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want).astype(np.int64))
        # the engine's chain: the key it keeps is split again
        np.testing.assert_array_equal(
            jr.split(got[0]).numpy(),
            np.asarray(jax.random.split(want[0])).astype(np.int64))


@pytest.mark.parametrize("B,V", [(1, 7), (3, 512), (2, 4099)])
def test_categorical_bit_equal(B, V):
    rng = np.random.RandomState(B * V)
    logits = (3 * rng.randn(B, V)).astype(np.float32)
    logits[:, ::5] = -1e30                  # nucleus-masked entries
    for seed in SEEDS:
        key = jr.split(jr.prng_key(seed))[1]
        jkey = jax.random.split(jax.random.PRNGKey(seed))[1]
        got = jr.categorical(key, torch.from_numpy(logits)).numpy()
        want = np.asarray(jax.random.categorical(jkey, jnp.asarray(logits),
                                                 -1))
        np.testing.assert_array_equal(got, want)
