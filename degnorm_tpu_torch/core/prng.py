"""The JAX package's keyed downsample offsets, drawn with numpy.

``degnorm_tpu/engine.py::_ds_starts`` draws the systematic-sampling offsets
of DegNorm iteration ``it`` as

    jax.random.randint(fold_in(PRNGKey(random_state), it), (n_genes,), 0,
                       rate, int32)

This module computes the same integers without jax: the Threefry-2x32 hash
(Salmon et al., "Parallel random numbers: as easy as 1, 2, 3", SC 2011) in
the form jax lowers it, jax's seed and ``fold_in``, its key split and
random-bits paths under ``jax_threefry_partitionable=True`` (the default of
the jax the JAX package runs on, 0.9), and ``randint``'s two draws combined
by a span multiply.  ``tests/test_torch_prng.py`` pins every output to jax's.

The seed is taken as a 64-bit integer (its high word becomes the first key
word), which is what jax does with 64-bit types enabled.  Without them jax
keeps only the low 32 bits of the seed, so the two agree for every seed in
[0, 2**32).
"""
from __future__ import annotations

import numpy as np

_U32 = np.uint32
# the rotation schedule of Threefry-2x32 (jax/_src/prng.py)
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << _U32(r)) | (x >> _U32(32 - r))


def threefry_2x32(k1, k2, x0, x1):
    """Threefry-2x32 with 20 rounds on uint32 counters ``(x0, x1)`` under the
    key ``(k1, k2)``; returns the two output words."""
    k1, k2 = _U32(k1), _U32(k2)
    ks = (k1, k2, k1 ^ k2 ^ _U32(0x1BD11BDA))
    x0 = np.asarray(x0, _U32) + ks[0]
    x1 = np.asarray(x1, _U32) + ks[1]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + _U32(i + 1)
    return x0, x1


def seed_key(seed: int):
    """``jax.random.PRNGKey(seed)``: the seed's 64-bit pattern as (high
    word, low word)."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return _U32(s >> 32), _U32(s & 0xFFFFFFFF)


def fold_in(key, data: int):
    """``jax.random.fold_in(key, data)``: the hash of the counter pair
    (0, data) under ``key``."""
    y0, y1 = threefry_2x32(key[0], key[1], np.zeros(1, _U32),
                           np.full(1, int(data) & 0xFFFFFFFF, _U32))
    return y0[0], y1[0]


def _counters(n: int):
    idx = np.arange(n, dtype=np.uint64)
    return (idx >> np.uint64(32)).astype(_U32), idx.astype(_U32)


def split2(key):
    """``jax.random.split(key)`` under the partitionable flag: key i is the
    hash of the counter pair (0, i)."""
    hi, lo = _counters(2)
    y0, y1 = threefry_2x32(key[0], key[1], hi, lo)
    return (y0[0], y1[0]), (y0[1], y1[1])


def random_bits32(key, n: int) -> np.ndarray:
    """32 random bits for each of ``n`` values under the partitionable flag:
    the two hash words of the counter pair (i >> 32, i), xored."""
    hi, lo = _counters(n)
    y0, y1 = threefry_2x32(key[0], key[1], hi, lo)
    return y0 ^ y1


def randint(key, n: int, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(key, (n,), minval, maxval, int32)``: two draws of
    32 bits from the split key, combined modulo the span with the multiplier
    2**32 mod span (uint32 arithmetic, wrapping as jax's does)."""
    k_hi, k_lo = split2(key)
    higher = random_bits32(k_hi, n)
    lower = random_bits32(k_lo, n)
    span = _U32(maxval - minval) if maxval > minval else _U32(1)
    with np.errstate(over="ignore"):
        mult = _U32(2 ** 16) % span
        mult = (mult * mult) % span
        off = ((higher % span) * mult + (lower % span)) % span
    return (np.int64(minval) + off.astype(np.int64)).astype(np.int32)


def downsample_offsets(seed: int, iteration: int, n_genes: int,
                       rate: int) -> np.ndarray:
    """The keyed offsets of one DegNorm iteration, in the global gene order:
    ``randint(fold_in(PRNGKey(seed), iteration), (n_genes,), 0, rate)``."""
    return randint(fold_in(seed_key(seed), iteration), n_genes, 0, rate)
