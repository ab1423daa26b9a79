"""Threefry-2x32 key derivation in numpy, equal to `jax.random`'s.

The reference search (`repro.synth`) derives its candidate seeds with
`jax.random.randint(fold_in(key(seed), g), (n,), 0, 2**31 - 1)`.  The
port has no jax, so this module recomputes those int32 seeds from the
same Threefry-2x32 hash (Salmon et al., SC'11; 20 rounds, the rotation
and key-schedule constants of `jax._src.prng`), for the jax the
reference runs under (0.9.0):

  * keys are pairs of uint32 words.  In jax's default 32-bit mode an
    integer seed is truncated to 32 bits before it becomes a key, so
    `key(seed)` is `(0, seed mod 2**32)`: the high word is always 0;
  * `fold_in(k, d)` hashes the counter pair (0, d) under `k`;
  * counters are laid out as `jax_threefry_partitionable=True` lays them
    (the default since jax 0.5): element i of a draw hashes the 64-bit
    counter i as the pair (i >> 32, i & 0xffffffff), and `split` is a
    draw of keys; 32-bit random bits are the XOR of the hash's two words;
  * `randint` splits its key in two, draws 32 bits from each, and folds
    the pair into the span with `jax.random._randint`'s multiplier.

All arithmetic is uint32 with wraparound, as XLA's.
"""
from __future__ import annotations

import numpy as np

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << _U32(d)) | (x >> _U32(32 - d))


def threefry2x32(k0, k1, x0: np.ndarray, x1: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 block hash of counter pairs (x0, x1) under the
    key (k0, k1); returns the two uint32 output words."""
    ks = (_U32(k0), _U32(k1), _U32(k0) ^ _U32(k1) ^ _U32(_PARITY))
    x = [np.asarray(x0, _U32) + ks[0], np.asarray(x1, _U32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + _U32(i + 1)
    return x[0], x[1]


def key(seed: int) -> np.ndarray:
    """`jax.random.key(seed)`'s uint32 words in 32-bit mode."""
    return np.array([0, int(seed) & 0xFFFFFFFF], _U32)


def fold_in(k: np.ndarray, data: int) -> np.ndarray:
    """`jax.random.fold_in(k, data)`."""
    h0, h1 = threefry2x32(k[0], k[1], np.zeros(1, _U32),
                          np.array([int(data) & 0xFFFFFFFF], _U32))
    return np.array([h0[0], h1[0]], _U32)


def _counters(n: int) -> tuple[np.ndarray, np.ndarray]:
    i = np.arange(n, dtype=np.uint64)
    return (i >> np.uint64(32)).astype(_U32), \
        (i & np.uint64(0xFFFFFFFF)).astype(_U32)


def split(k: np.ndarray, num: int = 2) -> np.ndarray:
    """`jax.random.split(k, num)`: [num, 2] uint32 keys."""
    h0, h1 = threefry2x32(k[0], k[1], *_counters(num))
    return np.stack([h0, h1], axis=1)


def random_bits32(k: np.ndarray, n: int) -> np.ndarray:
    """[n] uint32 random bits (`jax.random.bits(k, (n,), uint32)`)."""
    h0, h1 = threefry2x32(k[0], k[1], *_counters(n))
    return h0 ^ h1


def randint(k: np.ndarray, n: int, minval: int, maxval: int) -> np.ndarray:
    """`jax.random.randint(k, (n,), minval, maxval)` for int32 bounds:
    [n] int32 values in [minval, maxval)."""
    lo, hi = int(minval), int(maxval)
    if not (-2 ** 31 <= lo <= hi < 2 ** 31):
        raise ValueError(f"randint bounds [{lo}, {hi}) must be int32")
    k1, k2 = split(k, 2)
    higher, lower = random_bits32(k1, n), random_bits32(k2, n)
    span = _U32(max(hi - lo, 1) & 0xFFFFFFFF)
    mult = _U32(2 ** 16) % span
    mult = np.array([mult], _U32) * mult % span      # wraps like lax.mul
    offset = (higher % span * mult + lower % span) % span
    return (np.int64(lo) + offset.astype(np.int64)).astype(np.int32)
