"""The process-group runtime: one process per device, and the collectives
the port's parallel paths call.

Counterpart of ``grl_tpu/parallel/distributed.py`` (:31-83). ``grl_tpu``
runs one process per host and lets XLA route collectives over all of its
devices. The port runs one process per device (a rank) under
``torch.distributed``; a ``grl_tpu`` mesh of D devices is a world of D
processes here.

Launch contract (one process per device)::

    GRL_COORDINATOR_ADDRESS=host0:9977 GRL_NUM_PROCESSES=2 \\
    GRL_PROCESS_ID=0 python -m grl_torch.demo_training --config ...

or a ``parallel.distributed`` config block with the same keys
(``coordinator_address``, ``num_processes``, ``process_id``, and
``timeout`` in seconds). ``auto: true`` reads the ``env://`` variables a
launcher such as ``torchrun`` sets (``MASTER_ADDR``, ``MASTER_PORT``,
``RANK``, ``WORLD_SIZE``).

The backend is chosen up front from the world size and the device
(:func:`choose_backend`), never by catching a failure: NCCL where every
rank has a card of its own, gloo on the CPU and where ranks share a card.
Gloo runs ``all_reduce`` and ``broadcast`` on CUDA tensors itself; its
point-to-point sends, ``all_gather`` and ``reduce_scatter`` take host
tensors, so :func:`all_gather`, :func:`reduce_scatter` and :func:`shift`
stage CUDA tensors through page-locked host buffers there (the
transport, :func:`transport`). Every computation stays on the card.
"""
from __future__ import annotations

import os
import time
from collections import defaultdict
from datetime import timedelta
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from grl_torch.utils.device import DeviceLike
from grl_torch.utils.logging import get_logger
from grl_torch.utils.platform import ensure_platform

ENV_COORDINATOR = "GRL_COORDINATOR_ADDRESS"
ENV_NUM_PROCESSES = "GRL_NUM_PROCESSES"
ENV_PROCESS_ID = "GRL_PROCESS_ID"

# Seconds a collective may wait before the world fails (every process
# group is made with it), so a rank that died or diverged fails the run
# instead of hanging it.
DEFAULT_TIMEOUT_S = 300.0

# Bytes, calls and (with ``timing`` on) milliseconds of the collectives by
# kind, for the measurement scripts: ``comm_stats[kind]``.
comm_stats: Dict[str, Dict[str, float]] = defaultdict(lambda: {"calls": 0, "bytes": 0, "ms": 0.0})
timing = False


def choose_backend(world_size: int, device_type: str, device_count: int) -> str:
    """NCCL where each of ``world_size`` ranks has a card of its own
    (``device_count >= world_size``); gloo on the CPU, and where ranks must
    share a card (NCCL refuses two ranks on one GPU)."""
    if device_type == "cuda" and device_count >= world_size:
        return "nccl"
    return "gloo"


def transport(backend: str, device_type: str) -> str:
    """How the collectives of a rank's tensors travel: NCCL on the card,
    gloo on the host, or gloo with host-staged point-to-point, all_gather
    and reduce_scatter for CUDA tensors."""
    if backend == "gloo" and device_type == "cuda":
        return "gloo: all_reduce/broadcast on CUDA tensors, P2P/all_gather/reduce_scatter staged through pinned host buffers"
    return f"{backend}: direct"


def initialize_distributed(config: Optional[Any] = None, device: DeviceLike = None) -> Tuple[int, int, str]:
    """Start the process group if one is configured; return
    ``(host_id, num_hosts, backend)``, the rank, the world size and the
    backend (``""`` single-process).

    Resolution order: ``config.parallel.distributed``, then the ``GRL_*``
    variables, then ``auto: true`` (``env://``). Single-process when
    nothing is configured. Idempotent: a second call reports the live
    group. ``device="cpu"`` runs the world on the CPU over gloo; otherwise
    each rank takes its card (:func:`grl_torch.utils.platform.ensure_platform`)
    before the group starts. Writes ``host_id`` / ``num_hosts`` into
    ``config`` (``grl_tpu``'s :81-83).
    """
    logger = get_logger("distributed")
    spec: Dict[str, Any] = {}
    if config is not None and hasattr(config, "get_path"):
        spec = dict(config.get_path("parallel.distributed") or {})
    coordinator = spec.get("coordinator_address") or os.environ.get(ENV_COORDINATOR)
    num_processes = spec.get("num_processes") or os.environ.get(ENV_NUM_PROCESSES)
    process_id = spec.get("process_id", os.environ.get(ENV_PROCESS_ID))
    auto = bool(spec.get("auto", False))
    timeout = timedelta(seconds=float(spec.get("timeout", DEFAULT_TIMEOUT_S)))
    platform = "cpu" if device is not None and torch.device(device).type == "cpu" else None

    if not dist.is_initialized():
        if auto:
            world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
            init_method = "env://"
        elif coordinator and num_processes and int(num_processes) > 1:
            world, rank = int(num_processes), int(process_id or 0)
            init_method = f"tcp://{coordinator}"
        else:
            world = 0
        if world > 1:
            local_rank = int(os.environ.get("LOCAL_RANK", rank))
            rank_device = ensure_platform(platform, local_rank)
            count = torch.cuda.device_count() if rank_device.type == "cuda" else 0
            backend = choose_backend(world, rank_device.type, count)
            dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                                    timeout=timeout)
            logger.info(
                f"multi-process runtime: process {rank}/{world} on {rank_device}, backend {backend} "
                f"({transport(backend, rank_device.type)}), timeout {timeout.total_seconds():.0f} s"
            )
    host_id, num_hosts = (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)
    backend = dist.get_backend() if dist.is_initialized() else ""
    if config is not None:
        # The DataLoader reads these for the per-host batch shard.
        config["host_id"] = host_id
        config["num_hosts"] = num_hosts
    return host_id, num_hosts, backend


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------
# The single-tensor all_gather and reduce_scatter under their current names
# (older torch releases have only the ``*_tensor`` ones).
_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def _staged(t: torch.Tensor, group) -> bool:
    """True where gloo must take ``t`` on the host."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _host(t: torch.Tensor) -> torch.Tensor:
    """A page-locked host copy of CUDA tensor ``t`` (the copy waits for it)."""
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out


class _Timed:
    """Counts a collective's calls and bytes under ``kind``; with ``timing``
    on, also its milliseconds, the device synchronized on both sides."""

    def __init__(self, kind: str, t: torch.Tensor):
        self.kind, self.t = kind, t

    def __enter__(self):
        stats = comm_stats[self.kind]
        stats["calls"] += 1
        stats["bytes"] += self.t.numel() * self.t.element_size()
        if timing:
            if self.t.is_cuda:
                torch.cuda.synchronize(self.t.device)
            self.start = time.perf_counter()

    def __exit__(self, *exc):
        if timing and exc[0] is None:
            if self.t.is_cuda:
                torch.cuda.synchronize(self.t.device)
            comm_stats[self.kind]["ms"] += (time.perf_counter() - self.start) * 1e3


def all_reduce_(t: torch.Tensor, group, kind: str = "all_reduce") -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (gloo takes CUDA tensors here)."""
    with _Timed(kind, t):
        dist.all_reduce(t, group=group)
    return t


def broadcast_(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """``t`` from global rank ``src``, in place."""
    with _Timed("broadcast", t):
        dist.broadcast(t, src, group=group)
    return t


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (one shape), concatenated along ``dim`` in the
    group's rank order."""
    size = dist.get_world_size(group)
    src = t.movedim(dim, 0).contiguous()
    staged = _staged(src, group)
    if staged:
        src = _host(src)
    out = torch.empty((size * src.shape[0], *src.shape[1:]), dtype=src.dtype, device=src.device)
    with _Timed("all_gather", src):
        _ALL_GATHER(out, src, group=group)
    if staged:
        out = out.to(t.device, non_blocking=True)
    return out.movedim(0, dim)


def reduce_scatter(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The sum over ``group`` of ``t``, this rank's part of ``dim`` (split
    evenly in the group's rank order)."""
    size = dist.get_world_size(group)
    src = t.movedim(dim, 0).contiguous()
    staged = _staged(src, group)
    if staged:
        src = _host(src)
    out = torch.empty((src.shape[0] // size, *src.shape[1:]), dtype=src.dtype, device=src.device)
    with _Timed("reduce_scatter", src):
        _REDUCE_SCATTER(out, src, group=group)
    if staged:
        out = out.to(t.device, non_blocking=True)
    return out.movedim(0, dim)


class Shift:
    """A ring shift in flight (:func:`shift`): :meth:`wait` gives the tensor
    received. With ``timing`` on, the milliseconds from the start of the
    shift to the received tensor on the device (the host staging included,
    and whatever the caller ran meanwhile) count as the shift's."""

    def __init__(self, requests: List[Any], received: torch.Tensor, device: torch.device, staged: bool,
                 start: Optional[float]):
        self.requests, self.received, self.device, self.staged = requests, received, device, staged
        self.start = start

    def wait(self) -> torch.Tensor:
        for request in self.requests:
            request.wait()
        out = self.received.to(self.device, non_blocking=True) if self.staged else self.received
        if self.start is not None:
            if out.is_cuda:
                torch.cuda.synchronize(out.device)
            comm_stats["shift"]["ms"] += (time.perf_counter() - self.start) * 1e3
        return out


def shift(t: torch.Tensor, group, ranks: Sequence[int], index: int, offset: int = 1) -> Shift:
    """Start sending ``t`` to the rank ``offset`` places on in the ring
    ``ranks`` (global ranks in ring order; this rank is ``ranks[index]``)
    while receiving the same shape from the rank ``offset`` places back: one
    paired ``batch_isend_irecv``, so every rank issues its shifts in the
    same order and none blocks on a send before its receive."""
    D = len(ranks)
    src = t.contiguous()
    stats = comm_stats["shift"]
    stats["calls"] += 1
    stats["bytes"] += src.numel() * src.element_size()
    start = None
    if timing:
        if src.is_cuda:
            torch.cuda.synchronize(src.device)
        start = time.perf_counter()
    staged = _staged(src, group)
    if staged:
        src = _host(src)
    received = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, ranks[(index + offset) % D], group),
           dist.P2POp(dist.irecv, received, ranks[(index - offset) % D], group)]
    return Shift(dist.batch_isend_irecv(ops), received, t.device, staged, start)


def share_numpy_state() -> None:
    """numpy's global generator set on every rank to the first rank's
    state (that rank's unchanged): host processors that draw from it
    (``SSLLabeling``'s pairs) then label every rank's copy of a global
    batch alike, as every rank reads the whole batch and keeps its rows."""
    if world_size() <= 1:
        return
    name, keys, pos, has_gauss, gauss = np.random.get_state()
    device = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" else None
    words = broadcast_(torch.tensor(np.concatenate([keys.astype(np.int64), [pos, has_gauss]]), device=device), 0)
    cached = broadcast_(torch.tensor([gauss], dtype=torch.float64, device=device), 0)
    words = words.cpu().numpy()
    np.random.set_state((name, words[:-2].astype(np.uint32), int(words[-2]), int(words[-1]), float(cached[0])))


_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def equal_across(tensors: Sequence[torch.Tensor], group=None) -> bool:
    """True when every rank of ``group`` holds the same bits in
    ``tensors``: their bits as integers, reduced elementwise as MAX and as
    MIN (MAX of the negation) over the group, must agree."""
    words = [t.detach().contiguous().view(-1).view(_BITS[t.element_size()]).to(torch.int64) for t in tensors]
    flat = torch.cat(words) if words else torch.zeros(0, dtype=torch.int64)
    both = torch.cat([flat, -flat])
    if dist.get_backend(group) == "gloo":
        both = both.cpu()
    dist.all_reduce(both, op=dist.ReduceOp.MAX, group=group)
    return bool(torch.equal(both[:flat.numel()], -both[flat.numel():]))
