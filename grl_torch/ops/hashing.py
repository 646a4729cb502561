"""K0: the stateless DropEdge hash shared by K1, K2 and K5.

Counterpart of ``grl_tpu/ops/pallas/csr_spmm.py`` · ``_mix32`` and
``_hash_keep`` (:179-213). An edge (or an element of a dense adjacency)
is kept iff

    (mix(mix(gid ^ s) + s) >> 8) * 2^-24 < keep,   s = seed mod 2^32,

with ``mix`` the murmur3 fmix32 round and ``keep = 1 - rate`` rounded to
float32. The seed goes in twice, by xor and by add: a single xor makes
every mask an xor-translate of one fixed set (``csr_spmm.py:196-204``).

torch has no full ``uint32`` arithmetic, so the values are held in int64
and every product is reduced mod 2^32 (:func:`_mul32`). The CUDA kernels
compute the same bits with ``grl_torch/csrc/hash.cuh``.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

Seed = Union[int, torch.Tensor]


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2^32`` for int64 ``x`` in ``[0, 2^32)``, in two halves
    of ``c`` so that no int64 product overflows."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & 0xFFFFFFFF


def mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 round on uint32 values held in int64."""
    x = _mul32(x, 0x9E3779B9)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def keep_probability(rate: float) -> float:
    """``1 - rate`` rounded to float32, as the kernels compare with it."""
    rate = float(rate)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"DropEdge rate must be in [0, 1); got {rate}")
    return float(np.float32(1.0 - rate))


def keep_scale(rate: float) -> float:
    """``1 / keep`` as float32 division gives it: the value a kept edge
    carries, in the kernels and in ``_hash_keep``."""
    return float(np.float32(1.0) / np.float32(keep_probability(rate)))


def keep_bits(gid: torch.Tensor, seed: Seed, rate: float) -> torch.Tensor:
    """Boolean keep mask of the ids ``gid`` (any integer dtype; negative
    int32 ids wrap to uint32 as in ``_hash_keep``)."""
    keep = keep_probability(rate)
    s = int(seed) & 0xFFFFFFFF
    x = gid.to(torch.int64) & 0xFFFFFFFF
    x = mix32((mix32(x ^ s) + s) & 0xFFFFFFFF)
    u = (x >> 8).to(torch.float32) * 2.0**-24
    return u < keep


def hash_keep(gid: torch.Tensor, seed: Seed, rate: float) -> torch.Tensor:
    """``_hash_keep(gid, seed, rate)``: float32 ``1/keep`` where an id is
    kept, 0 where it is dropped."""
    return keep_bits(gid, seed, rate).to(torch.float32) * keep_scale(rate)
