"""Launch counts of the port's kernels, as the device ran them.

Every kernel wrapper adds one to :data:`ran` where it launches its kernel,
under the kernel's name and, for K3, K2 and K7, under its route too
(:func:`count`). A wrapper called while a CUDA graph is being captured adds
as well, but then the kernel is recorded, not run, and it runs once at each
replay of the graph: so the graph runner (:mod:`grl_torch.trainer.captured`)
takes what a capture recorded back out of :data:`ran` and adds it again at
every replay. :data:`ran` then holds the launches the device ran: the eager
ones plus each graph's recorded launches times its replays.

Names: ``K3`` (and ``K3 sm90``, ``K3 ragged``, ``K3 float32`` by route),
``K1``, ``K2`` (``K2 sm90``, ``K2 float32``), ``K5 forward``, ``K5
backward``, ``K4``, ``K4b receivers`` and ``K4b senders`` (K4's backward,
two launches), ``D forward`` and ``D backward`` (dropout), ``K6
<direction>`` for each of :data:`grl_torch.ops.ell.DIRECTIONS`, and ``K7``
with ``K7 <direction>`` and ``K7 <route>`` (:data:`grl_torch.ops.tile.ROUTES`'
persistent routes).
"""
from __future__ import annotations

from collections import Counter

ran: Counter = Counter()


def count(*names: str) -> None:
    """One launch under each of ``names``."""
    ran.update(names)


def device_counts() -> Counter:
    """The launches the device ran, by name (0 for a kernel that never
    launched)."""
    return Counter(ran)


def reset() -> None:
    """Every count to 0."""
    ran.clear()
