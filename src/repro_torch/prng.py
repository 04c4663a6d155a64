"""The reference's counter-based keys, computed on the host.

``threefry_2x32`` is the Threefry-2x32 block cipher (20 rounds) that
``jax.random`` keys are built on; ``prng_key`` and ``fold_in`` give the
same two uint32 words as ``jax.random.PRNGKey`` and
``jax.random.fold_in`` (tests hold them equal).  The port draws its
numbers from ``torch.Generator``s; these keys exist so that the state it
checkpoints (the train state's ``rng`` leaf, the data pipeline's shard
key record) carries the reference's exact values."""
from __future__ import annotations

from typing import Sequence, Tuple

_M = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: int, d: int) -> int:
    return ((x << d) | (x >> (32 - d))) & _M


def threefry_2x32(key: Sequence[int], x: Sequence[int]) -> Tuple[int, int]:
    k0, k1 = int(key[0]) & _M, int(key[1]) & _M
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (int(x[0]) + ks[0]) & _M
    x1 = (int(x[1]) + ks[1]) & _M
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M
    return x0, x1


def prng_key(seed: int) -> Tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed (the high word of
    a 32-bit seed is 0)."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 32):
        raise ValueError(f"seed {seed} does not fit 32 bits")
    return (0, seed & _M)


def fold_in(key: Sequence[int], data: int) -> Tuple[int, int]:
    """``jax.random.fold_in(key, data)``."""
    return threefry_2x32(key, (0, int(data) & _M))
