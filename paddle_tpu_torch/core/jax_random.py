"""Bit-exact torch versions of the ``jax.random`` calls behind the
serving sampler.

The engine's sampled rows draw Gumbel noise keyed on (request seed,
position): ``gumbel(fold_in(PRNGKey(seed), pos), (V,), float32)``. For a
sampled stream of the port to equal the JAX engine's, the noise has to
be the same bits, so this module rebuilds the default JAX PRNG in torch
integer ops:

- ``threefry2x32``: the 20-round Threefry-2x32 block cipher with JAX's
  rotation schedule and key-injection order;
- ``prng_key(seed)``: a 32-bit seed becomes the key ``[0, seed]``
  (``jax_enable_x64`` off, so the high word is 0);
- ``fold_in(key, data)``: ``threefry2x32(key, [0, data])``;
- ``split(key, n)``: key i is ``threefry2x32(key, [0, i])`` (the
  partitionable layout counts with the 64-bit iota split into (hi, lo));
- ``random_bits32(key, n)``: the ``jax_threefry_partitionable=True``
  layout — element i hashes the 64-bit counter i split into (hi, lo)
  and returns ``y0 ^ y1``;
- ``uniform``/``gumbel``: mantissa fill ``(bits >> 9) | 0x3F800000``,
  minus 1.0, scaled into [tiny, 1), then ``-log(-log(u))`` (the "low"
  Gumbel mode, JAX's default);
- ``categorical(key, logits)``: ``argmax(gumbel + logits)`` over the last
  axis, the noise for all ``[B, V]`` rows drawn from the one key (in the
  partitionable layout that is the flat ``B * V`` draw, reshaped).

uint32 arithmetic is carried in int64 tensors masked to 32 bits. Every
function takes a leading batch of keys, so one call covers all rows of
a step.
"""

from __future__ import annotations

import torch

__all__ = ["threefry2x32", "prng_key", "fold_in", "split", "random_bits32",
           "uniform_from_bits", "gumbel", "categorical"]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_FLOAT32_TINY = torch.finfo(torch.float32).tiny


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 on uint32 values held in int64 tensors (all four
    broadcastable); returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x1 + ks[0]) & _M32
    b = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & _M32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & _M32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & _M32
    return a, b


def prng_key(seed) -> torch.Tensor:
    """``jax.random.PRNGKey`` for 32-bit seeds: int tensor [...] (or a
    Python int) -> int64 key [..., 2]."""
    s = torch.as_tensor(seed).to(torch.int64) & _M32
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: key [..., 2], data int [...] -> [..., 2]."""
    d = torch.as_tensor(data, device=key.device).to(torch.int64) & _M32
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split(key, n)``: key [2] -> int64 keys [n, 2]."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[0], key[1], torch.zeros_like(i), i)
    return torch.stack([y0, y1], dim=-1)


def random_bits32(key: torch.Tensor, n: int) -> torch.Tensor:
    """32 random bits per element of a length-``n`` vector, per key:
    key [..., 2] -> int64 [..., n] holding uint32 values."""
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[..., 0, None], key[..., 1, None],
                          torch.zeros_like(lo), lo)
    return y0 ^ y1


def uniform_from_bits(bits: torch.Tensor, minval: float = 0.0,
                      maxval: float = 1.0) -> torch.Tensor:
    """JAX's float32 ``uniform`` from 32 random bits: 23 mantissa bits
    under exponent 0 give [1, 2), minus 1, scaled into [minval, maxval),
    clamped below at minval — each op in float32, in JAX's order."""
    fb = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fb.view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=bits.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=bits.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def _fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 fused multiply-add: the product of two float32 values is
    exact in float64, so one float64 add and one rounding to float32
    give the fused result (up to a double rounding at an exact float32
    midpoint, about one case in 2**29)."""
    return (a.double() * b + c).float()


# Cephes single-precision log polynomial (the one XLA's CPU backend
# emits for float32 ``log``), in evaluation order.
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375
_SQRTHF = 0.707106781186547524


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """Natural log of positive, finite float32 values, rounded exactly as
    XLA's CPU backend rounds it. ``torch.log`` is correctly rounded and
    differs from it in the last bit for about one value in seven, which
    would move the Gumbel noise off JAX's bits. Same steps and fusions
    as the compiled XLA code: frexp, recentre to [sqrt(1/2), sqrt(2)),
    a degree-8 polynomial in three fused chains, exponent added back in
    two parts."""
    p = [torch.tensor(v, dtype=torch.float32).item() for v in _LOG_P]
    q1 = torch.tensor(_LOG_Q1, dtype=torch.float32).item()
    q2 = torch.tensor(_LOG_Q2, dtype=torch.float32).item()
    m, e = torch.frexp(x.float())
    e = e.float()
    low = m < torch.tensor(_SQRTHF, dtype=torch.float32)
    m = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    e = e - low.float()
    x2 = m * m
    x3 = x2 * m
    y = _fma32(_fma32(m, p[0], p[1]), m, p[2])
    y1 = _fma32(_fma32(m, p[3], p[4]), m, p[5])
    y2 = _fma32(_fma32(m, p[6], p[7]), m, p[8])
    y = _fma32(x3, y, y1)
    y = _fma32(y, x3, y2)
    y = _fma32(y, x3, e * q1)
    r = _fma32(x2, -0.5, m) + y
    return _fma32(e, q2, r)


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` per key: [..., 2] ->
    float32 [..., n], bit for bit with JAX on the CPU."""
    u = uniform_from_bits(random_bits32(key, n), _FLOAT32_TINY, 1.0)
    return -xla_log(-xla_log(u))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, -1)`` for float32 logits
    [..., V] and one key [2]: int64 [...]."""
    noise = gumbel(key, logits.numel()).reshape(logits.shape)
    return torch.argmax(noise + logits, dim=-1)
