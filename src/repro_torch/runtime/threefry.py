"""JAX's default PRNG, threefry-2x32, on torch tensors.

The reference draws every sampled token with ``jax.random.categorical``
under the key ``fold_in(fold_in(PRNGKey(seed), rid), age)``
(``runtime/sampling.py``). Its bits come from Threefry-2x32 (Salmon et
al., SC'11: 20 rounds of 32-bit add, rotate and xor over a two-word
counter), a public counter-based hash. This module computes the same
words from JAX's own definitions (``jax/_src/prng.py``: ``threefry_seed``,
``threefry_2x32``, ``threefry_fold_in``, ``threefry_random_bits``;
``jax/_src/random.py``: ``_uniform``, ``_gumbel``), so the port's keys and
random bits equal the reference's bit for bit.

The words live in int64 tensors holding values in [0, 2**32): every sum is
masked to 32 bits and every rotation is two shifts and an or. Everything
is elementwise on the device, reads nothing back and allocates by shape
alone, so a draw fits inside a CUDA graph.

The scheme is the one JAX uses by default since 0.5,
``jax_threefry_partitionable=True``: the random bits of a key over n
values are ``threefry(key, (hi, lo))`` of the 64-bit counter 0..n-1 split
into two words, the two output words xored. The older scheme (the flag
False) hashes the counter iota as one array split in halves and draws
other bits; it is not implemented here.
"""
from __future__ import annotations

import numpy as np
import torch

PARTITIONABLE = True   # the jax_threefry_partitionable scheme of these bits

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = float(np.finfo(np.float32).tiny)
_SPAN = float(np.float32(1.0) - np.float32(_TINY))   # maxval - minval in float32


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) & _M32) | (x >> (32 - d))


def threefry_2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                  x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash of the counter words (x1, x2) under the key
    (k1, k2): 20 rounds in five groups of four, a key injection after each
    group. Every argument is an int64 tensor of 32-bit words; they
    broadcast together. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def seed(s: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.random.PRNGKey`` of 32-bit seeds ``s`` (any integer tensor,
    taken modulo 2**32): the key words (0, s)."""
    s = s.to(torch.int64) & _M32
    return torch.zeros_like(s), s


def fold_in(key: tuple, data: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.random.fold_in``: the key hashed with the counter (0, data),
    ``data`` taken modulo 2**32 (jax casts it to uint32)."""
    d = data.to(torch.int64) & _M32
    return threefry_2x32(key[0], key[1], torch.zeros_like(d), d)


def random_bits(key: tuple, n: int) -> torch.Tensor:
    """``jax.random.bits`` of 32 bits over ``n`` values for each key of a
    batch: key words (B,) -> (B, n) int64 words."""
    k1, k2 = key[0][:, None], key[1][:, None]
    lo = torch.arange(n, dtype=torch.int64, device=k1.device)[None, :]
    b1, b2 = threefry_2x32(k1, k2, torch.zeros_like(lo), lo)
    return b1 ^ b2


def uniform(key: tuple, n: int) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval=tiny, maxval=1)``
    per key: the top 23 bits as the mantissa of a float in [1, 2), minus
    one, scaled and shifted into [tiny, 1). (B, n) float32."""
    bits = (random_bits(key, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    return (floats * _SPAN + _TINY).clamp_min(_TINY)


def gumbel(key: tuple, n: int) -> torch.Tensor:
    """``jax.random.gumbel`` in its default ("low") mode: -log(-log(u)) of
    ``uniform``. (B, n) float32."""
    return -torch.log(-torch.log(uniform(key, n)))
