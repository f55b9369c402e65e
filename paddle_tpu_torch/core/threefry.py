# ported from jax/_src/prng.py and jax/_src/random.py (JAX 0.9.0, threefry_partitionable=True): what paddle_tpu/serving/engine.py:58-92 uses of jax.random
"""Threefry-2x32 counter-based random numbers, bit-equal to ``jax.random``.

The serving sampler keys each draw by ``fold_in(PRNGKey(seed),
position)``, so a sampled stream is a pure function of the request's seed
and the context position. To emit the JAX package's sampled streams the
port needs the same bits: this module is the part of ``jax.random`` that
the sampler calls, written in torch integer ops.

Values are int64 tensors holding unsigned 32-bit words: every add is
masked back to 32 bits and a rotation is two shifts and a mask. A key is a
pair ``(k1, k2)`` of such tensors of one shape (a 0-d pair for one key,
``[B]`` for one key a slot), so ``B`` rows of ``n`` draws come out of one
call as ``[B, n]`` with no host read, which a CUDA graph can capture.

The counter layout is the one JAX uses with ``jax_threefry_partitionable``
on (its default since 0.5): element ``i`` of a 1-D draw hashes the 64-bit
counter ``i`` as the word pair ``(i >> 32, i & 0xFFFFFFFF)`` and its bits
are the XOR of the two output words.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["threefry2x32", "prng_key", "fold_in", "random_bits", "uniform",
           "gumbel", "key_words"]

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
F32_TINY = float(torch.finfo(torch.float32).tiny)

Key = Tuple[torch.Tensor, torch.Tensor]


def _u32(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & M32
    return torch.as_tensor(x, dtype=torch.int64, device=device) & M32


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k1, k2, x1, x2) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of the counter words ``(x1,
    x2)`` under the key ``(k1, k2)``; all four are int64 tensors of 32-bit
    values, broadcast against each other. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [(x1 + ks[0]) & M32, (x2 + ks[1]) & M32]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & M32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & M32
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & M32
    return x[0], x[1]


def prng_key(seed, device=None) -> Key:
    """``jax.random.PRNGKey(seed)`` for 32-bit seeds (an int or an integer
    tensor of any shape): the key words ``(0, seed mod 2**32)``."""
    k2 = _u32(seed, device)
    return torch.zeros_like(k2), k2


def fold_in(key: Key, data) -> Key:
    """``jax.random.fold_in(key, data)``: the hash of the counter pair
    ``(0, data)`` under ``key``; ``data`` broadcasts against the key."""
    k1, k2 = key
    d = _u32(data, k1.device)
    return threefry2x32(k1, k2, torch.zeros_like(d), d)


def random_bits(key: Key, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` as int64 values: shape
    ``key.shape + (n,)``."""
    k1, k2 = key
    lo = torch.arange(int(n), dtype=torch.int64, device=k1.device)
    b1, b2 = threefry2x32(k1[..., None], k2[..., None], torch.zeros_like(lo),
                          lo)
    return b1 ^ b2


def uniform(key: Key, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, maxval)``: the top
    23 bits as the mantissa of a float in [1, 2), minus 1, scaled to
    [minval, maxval) in float32 and floored at ``minval``."""
    bits = random_bits(key, n)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    # filled on the device (a host tensor copied in would not capture)
    lo = torch.full((), minval, dtype=torch.float32, device=f.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=f.device)
    return torch.maximum(lo, f * (hi - lo) + lo)


def gumbel(key: Key, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` (its default
    ``mode="low"``): ``-log(-log(u))`` of a uniform ``u`` in
    [tiny, 1)."""
    return -torch.log(-torch.log(uniform(key, n, F32_TINY, 1.0)))


def key_words(key: Key):
    """The key as a numpy uint32 array ``[..., 2]``, the layout of
    ``jax.random.key_data`` (for tests and logs)."""
    import numpy as np

    return np.stack([key[0].cpu().numpy(), key[1].cpu().numpy()],
                    axis=-1).astype(np.uint32)
