"""Counter-based random numbers that equal jax.random's bit for bit.

The subset of jax.random (threefry2x32 implementation, with
jax_threefry_partitionable on, the default since jax 0.5) that the growth
path needs: PRNGKey, fold_in, split, bits, uniform, randint and
permutation. Quantized training draws its stochastic-rounding noise from
these, feature_fraction its per-tree feature permutation, bynode sampling
its per-slot uniforms and extra_trees its random thresholds, so the port
and the JAX package draw the same numbers under the same key.

A key is an int64 tensor of shape [2] holding two uint32 words, on the
device of the caller; every function here stays on that device, never
reads a value back to the host and never copies one to the device, so a
CUDA graph can capture it. torch's uint32 lacks most arithmetic, so
the words ride in int64 and are masked to 32 bits after each add and
shift.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch

__all__ = ["threefry2x32", "PRNGKey", "fold_in", "split", "bits", "uniform",
           "randint", "permutation"]

Shape = Union[int, Sequence[int]]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011, as
    jax._src.prng.threefry2x32): the two uint32 count words (x0, x1),
    int64 tensors of one shape, enciphered under key [2]."""
    ks = (key[0], key[1], key[0] ^ key[1] ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def _word(v: int, device) -> torch.Tensor:
    """A 0-dim int64 word filled on `device` (no host-to-device copy, so
    it can be captured in a CUDA graph)."""
    return torch.full((), v & _MASK, dtype=torch.int64, device=device)


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """jax.random.PRNGKey(seed): the words [seed >> 32, seed & 0xFFFFFFFF]."""
    return torch.stack([_word(seed >> 32, device), _word(seed, device)])


def fold_in(key: torch.Tensor, data: Union[int, torch.Tensor]
            ) -> torch.Tensor:
    """jax.random.fold_in: threefry2x32(key, (0, uint32(data))). A tensor
    `data` (an int32 scalar: the bit pattern of an f32 sum, or an
    iteration or pass index that a CUDA graph replays) stays on the
    device; its uint32 cast wraps negative values."""
    if isinstance(data, torch.Tensor):
        d = data.to(torch.int64).reshape(()) & _MASK
    else:
        d = _word(int(data), key.device)
    x0, x1 = threefry2x32(key, torch.zeros_like(d), d)
    return torch.stack([x0, x1])


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """jax.random.split (fold-like under jax_threefry_partitionable): key
    i of the [num, 2] result is threefry2x32(key, (0, i))."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    x0, x1 = threefry2x32(key, torch.zeros_like(i), i)
    return torch.stack([x0, x1], dim=1)


def bits(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """jax.random.bits(key, shape) (uint32): x0 ^ x1 of threefry2x32(key,
    (0, i)) over the row-major flat counter i, held in int64."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    i = torch.arange(math.prod(shape), dtype=torch.int64, device=key.device)
    x0, x1 = threefry2x32(key, torch.zeros_like(i), i)
    return (x0 ^ x1).reshape(shape)


def uniform(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """jax.random.uniform(key, shape) in float32 on [0, 1): the top 23 of
    each element's 32 random bits as the mantissa of a float in [1, 2),
    minus one."""
    b = (bits(key, shape) >> 9) | 0x3F800000
    return b.to(torch.int32).view(torch.float32) - 1.0


def randint(key: torch.Tensor, shape: Shape, minval: int,
            maxval: int) -> torch.Tensor:
    """jax.random.randint(key, shape, minval, maxval) for int32: two
    32-bit draws under split(key), combined modulo the span as jax's
    _randint does, (hi % span) * (2^32 % span) + lo % span, in uint32
    arithmetic."""
    if not -2 ** 31 <= minval <= maxval - 1 < 2 ** 31 - 1:
        raise ValueError(f"randint: [{minval}, {maxval}) is empty or "
                         "outside int32")
    k1, k2 = split(key)
    hi, lo = bits(k1, shape), bits(k2, shape)
    span = maxval - minval
    mult = ((2 ** 16 % span) ** 2 & _MASK) % span
    off = ((hi % span) * mult + lo % span) & _MASK
    return (minval + off % span).to(torch.int32)


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """jax.random.permutation(key, n) (int32): jax's _shuffle, num_rounds
    rounds of split, 32 random bits per element and a stable sort of the
    elements by those bits."""
    x = torch.arange(n, dtype=torch.int32, device=key.device)
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(_MASK))
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(bits(sub, n), stable=True).indices
        x = x[order]
    return x
