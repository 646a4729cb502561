"""The model's weights, made by the benchmark from the run's seed.

One ``torch.randn`` on a generator on the card, split into the leaves the
configuration's reference lists (its ``leaves``: each name in the
program's state dict, its shape and the spread of its initialisation),
each scaled by its spread. The same tensors go to the program
(``load_state_dict``) and to the reference.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

# (name, shape, standard deviation)
Leaf = Tuple[str, Tuple[int, ...], float]


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for one purpose of the run, from ``--seed``."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF] + [ord(c) for c in tag]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def make_weights(torch, leaves: List[Leaf], seed: int, device) -> Dict[str, "torch.Tensor"]:
    sizes = [int(np.prod(shape)) for _, shape, _ in leaves]
    generator = torch.Generator(device=device).manual_seed(derive(seed, "weights"))
    flat = torch.randn(sum(sizes), generator=generator, device=device, dtype=torch.float32)
    out = {}
    for (name, shape, std), part in zip(leaves, torch.split(flat, sizes)):
        out[name] = (part * std).reshape(shape).contiguous()
    return out
