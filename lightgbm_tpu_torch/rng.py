"""Counter-based random numbers that equal jax.random's bit for bit.

The subset of jax.random (threefry2x32 implementation, with
jax_threefry_partitionable on, the default since jax 0.5) that the growth
path needs: PRNGKey, fold_in, split and uniform. Quantized training draws
its stochastic-rounding noise from these, so the port and the JAX package
quantize the same gradients to the same integers under the same key.

A key is an int64 tensor of shape [2] holding two uint32 words, on the
device of the caller; every function here stays on that device and never
reads a value back to the host. torch's uint32 lacks most arithmetic, so
the words ride in int64 and are masked to 32 bits after each add and
shift.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

__all__ = ["threefry2x32", "PRNGKey", "fold_in", "split", "uniform"]

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


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """jax.random.PRNGKey(seed): the words [seed >> 32, seed & 0xFFFFFFFF]."""
    return torch.tensor([(seed >> 32) & _MASK, seed & _MASK],
                        dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data: Union[int, torch.Tensor]
            ) -> torch.Tensor:
    """jax.random.fold_in: threefry2x32(key, (0, uint32(data))). A tensor
    `data` (an int32 scalar, e.g. the bit pattern of an f32 sum) stays on
    the device; its uint32 cast wraps negative values."""
    if isinstance(data, torch.Tensor):
        d = data.to(torch.int64).reshape(()) & _MASK
    else:
        d = torch.tensor(int(data) & _MASK, dtype=torch.int64,
                         device=key.device)
    x0, x1 = threefry2x32(key, torch.zeros_like(d), d)
    return torch.stack([x0, x1])


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """jax.random.split (fold-like under jax_threefry_partitionable): key
    i of the [num, 2] result is threefry2x32(key, (0, i))."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    x0, x1 = threefry2x32(key, torch.zeros_like(i), i)
    return torch.stack([x0, x1], dim=1)


def uniform(key: torch.Tensor, n: int) -> torch.Tensor:
    """jax.random.uniform(key, (n,)) in float32 on [0, 1): 32 random bits
    per element (x0 ^ x1 of threefry2x32(key, (0, i))), the top 23 as the
    mantissa of a float in [1, 2), minus one."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    x0, x1 = threefry2x32(key, torch.zeros_like(i), i)
    bits = ((x0 ^ x1) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0
