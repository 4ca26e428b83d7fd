"""jax.random's threefry-2x32 generator in torch, bit for bit.

gms_tpu draws its random numbers from jax.random (the threefry PRNG with
`jax_threefry_partitionable` on, jax's default): Johansson's picks, the
Barenboim/Elkin one-shot picks and the sampled ADG boundaries. This module
computes the same words from the same keys, so the port's randomized
colorings and sampled orderings equal gms_tpu's:

  * `key(seed)` / `PRNGKey(seed)`: the raw key (hi, lo) of the 64-bit seed
    (jax `threefry_seed`);
  * `fold_in(key, data)`, `split(key, num)` (the fold-like split);
  * `random_bits(key, bits, shape)` for 32 and 64 bits;
  * `randint(key, shape, minval, maxval, dtype)`: jax's `_randint`, which
    draws two words an element and reduces them mod the span
    ((higher % span) * ((2^(bits/2) % span)^2 % span) + lower % span) % span
    in uint32 or uint64 arithmetic (so the 32-bit products wrap), with
    span 1 where maxval <= minval; maxval may be a tensor (per element).

torch cannot shift uint32 on the CPU, so every 32-bit word is held in an
int64 tensor, masked to 32 bits after each operation that can carry; a
64-bit word is its (hi, lo) pair, and the 64-bit `% span` works in pieces.
Spans of 2^31 or more raise (no graph here reaches them). Keys are int64
tensors [2] on the caller's device; the arithmetic is plain torch, run on
that device.
"""

from __future__ import annotations

import math

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_SPAN_LIMIT = 1 << 31


def _rotl(x, r: int):
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The threefry-2x32 hash (20 rounds) of the count pairs (x1, x2) under
    the key (k1, k2); all int64 tensors (or ints) holding uint32 words."""
    k3 = k1 ^ k2 ^ _PARITY
    ks = (k1, k2, k3)
    x1 = (x1 + k1) & _M32
    x2 = (x2 + k2) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _M32
    return x1, x2


def key(seed: int, device="cuda") -> torch.Tensor:
    """jax.random.key(seed)'s raw words: int64[2] (seed >> 32, seed & M32)
    of the seed as a 64-bit integer."""
    s = int(seed) & ((1 << 64) - 1)
    return torch.tensor([s >> 32, s & _M32], dtype=torch.int64,
                        device=device)


PRNGKey = key


def fold_in(k: torch.Tensor, data: int) -> torch.Tensor:
    """jax.random.fold_in(k, data), data taken as uint32."""
    d = torch.full((1,), int(data) & _M32, dtype=torch.int64,
                   device=k.device)
    a, b = threefry2x32(k[0], k[1], torch.zeros_like(d), d)
    return torch.cat([a, b])


def _counts(shape, device):
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return idx >> 32, idx & _M32


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """jax.random.split(k, num): int64[num, 2]."""
    hi, lo = _counts((num,), k.device)
    a, b = threefry2x32(k[0], k[1], hi, lo)
    return torch.stack([a, b], dim=1)


def _bits_pair(k, shape):
    hi, lo = _counts(shape, k.device)
    a, b = threefry2x32(k[0], k[1], hi, lo)
    return a.reshape(shape), b.reshape(shape)


def random_bits(k: torch.Tensor, bits: int, shape) -> torch.Tensor:
    """jax.random.bits(k, shape, uint32 or uint64): int64 tensor of the
    words — 32 bits: the unsigned value; 64 bits: the two's-complement
    bit pattern of the uint64 word (hi << 32 | lo)."""
    shape = tuple(shape)
    a, b = _bits_pair(k, shape)
    if bits == 32:
        return a ^ b
    if bits == 64:
        return torch.where(a >= 1 << 31, a - (1 << 32), a) * (1 << 32) + b
    raise ValueError(f"random_bits: 32 or 64 bits, got {bits}")


def _words64(word: torch.Tensor):
    """(hi, lo) uint32 words of int64 tensors holding uint64 bit patterns."""
    return (word >> 32) & _M32, word & _M32


def randint_bits(k: torch.Tensor, shape, bits: int) -> torch.Tensor:
    """The two draws of jax's randint (higher, lower) as int64[2, *shape]:
    random_bits of split(k)'s two keys (64-bit words as bit patterns)."""
    k1, k2 = split(k, 2)
    return torch.stack([random_bits(k1, bits, shape),
                        random_bits(k2, bits, shape)])


def randint_from_bits(draws: torch.Tensor, minval, maxval,
                      bits: int) -> torch.Tensor:
    """jax's randint reduction of the draws of `randint_bits` into
    [minval, maxval) (int64 tensor; span 1 where maxval <= minval)."""
    minval = torch.as_tensor(minval, dtype=torch.int64, device=draws.device)
    maxval = torch.as_tensor(maxval, device=draws.device).long()
    span = torch.where(maxval <= minval, 1, maxval - minval)
    if bool((span >= _SPAN_LIMIT).any()):
        raise ValueError("randint: spans of 2^31 or more are not supported")
    higher, lower = draws[0], draws[1]
    if bits == 32:
        mult = ((((1 << 16) % span) ** 2) & _M32) % span
        off = (((higher % span) * mult) & _M32) + lower % span
        off = (off & _M32) % span
    elif bits == 64:
        m32 = (1 << 32) % span
        mult = m32 * m32 % span

        def mod64(word):
            hi, lo = _words64(word)
            return ((hi % span) * m32 + lo % span) % span

        off = (mod64(higher) * mult + mod64(lower)) % span
    else:
        raise ValueError(f"randint: 32 or 64 bits, got {bits}")
    return minval + off


def randint(k: torch.Tensor, shape, minval, maxval,
            dtype=torch.int32) -> torch.Tensor:
    """jax.random.randint(k, shape, minval, maxval, dtype) for int32 or
    int64 (jnp's default int with x64 on, as gms_tpu sets it)."""
    bits = {torch.int32: 32, torch.int64: 64}.get(dtype)
    if bits is None:
        raise TypeError(f"randint: int32 or int64, got {dtype}")
    shape = tuple(shape)
    draws = randint_bits(k, shape, bits)
    maxval = torch.as_tensor(maxval, device=k.device).long()
    return randint_from_bits(draws, minval, maxval.expand(shape),
                             bits).to(dtype)
