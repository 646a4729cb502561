"""The stateless keep hash that every DropEdge and dropout mask of the
flagship is drawn from, frozen.

An id ``gid`` (an edge's position in the graph's edge arrays, or an
element's flat index) is kept under a seed ``s`` iff

    (mix(mix(gid ^ s) + s) >> 8) * 2^-24 < keep,   keep = float32(1 - rate),

with ``mix`` the murmur3 fmix32 round, all in uint32 arithmetic (held in
int64 here). A kept value is scaled by ``float32(1) / keep``.
"""
from __future__ import annotations

import numpy as np
import torch


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & 0xFFFFFFFF


def mix32(x: torch.Tensor) -> torch.Tensor:
    x = _mul32(x, 0x9E3779B9)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def keep_probability(rate: float) -> float:
    return float(np.float32(1.0 - float(rate)))


def keep_scale(rate: float) -> float:
    return float(np.float32(1.0) / np.float32(keep_probability(rate)))


def keep_bits(gid: torch.Tensor, seed: torch.Tensor, rate: float) -> torch.Tensor:
    """Boolean keep mask of the ids ``gid`` under the one-element integer
    tensor ``seed``."""
    s = seed.reshape(()).to(device=gid.device, dtype=torch.int64) & 0xFFFFFFFF
    x = gid.to(torch.int64) & 0xFFFFFFFF
    x = mix32((mix32(x ^ s) + s) & 0xFFFFFFFF)
    return (x >> 8).to(torch.float32) * 2.0**-24 < keep_probability(rate)


def keep_scaled(gid: torch.Tensor, seed: torch.Tensor, rate: float) -> torch.Tensor:
    """float32 ``1 / keep`` where an id is kept, 0 where it is dropped."""
    return keep_bits(gid, seed, rate).to(torch.float32) * keep_scale(rate)
