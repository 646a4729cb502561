"""K4: fused edge-restricted attention (SDDMM + softmax + SpMM).

Counterpart of ``grl_tpu/ops/pallas/sparse_attention.py``:
``SparseAttentionKernel(senders, receivers, num_nodes)`` plans a static
edge set once on the host, and ``attend(f, g, h)`` returns, for every
receiver ``r``,

    out[r] = sum over edges s -> r of softmax_s(f[r] . g[s]) * h[s]

in h's dtype, computed in float32; a receiver with no edge gets zeros.
Differentiable in ``f``, ``g`` and ``h``.

The plan is a receiver-major CSR (row pointers and senders, in the stable
order of the edge list) and its transpose. The forward is K4 (``grl_torch/csrc/
sparse_attention.cu``): one launch for every receiver, whatever its
degree, where the TPU split receivers into degree buckets and sent hubs
wider than ``MAX_PALLAS_WIDTH = 32`` to XLA (:188-191). How it is laid
out on the card (lanes a receiver, column slices of h sized for the L2,
blocks) is :func:`attention_launch`, a pure function of
the shapes and the card's L2 and SM count. The backward, ``attend_bwd``
(:206-259, XLA on the TPU), is K4b (``grl_torch/csrc/
sparse_attention_bwd.cu``), scatter-free in both directions as
``attend_bwd`` is: a receiver-major walk recomputes the scores and alpha,
``dalpha = <dout[r], h[s]>`` and ``dscore = alpha (dalpha - sum alpha
dalpha)``, writes ``df`` and one ``(dscore, alpha)`` pair per edge; a
sender-major walk over the transposed CSR gathers the pairs through
``t_edge`` (each edge's receiver-major position, as ``gids=fwd.edge_flat``
is on the TPU, :157-164) and writes ``dg`` and ``dh``. Its layout is
:func:`backward_launch`.

:func:`attend_forward` takes the plain version (:func:`attend_reference`,
the segment path of ``SparseNodeSelfAtten``, ``layers.py:292-299``) for
CPU tensors and launches K4 for CUDA tensors, or raises; it counts launches
as ``K4`` in :mod:`grl_torch.ops.launches`. :func:`attend_grad` does the
same for the backward: :func:`attend_backward_walks` on the CPU, K4b's two
launches (``K4b receivers``, ``K4b senders``) on CUDA.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from grl_torch.ops import _build, launches
from grl_torch.ops.segment import segment_max, segment_softmax, segment_sum
from grl_torch.ops.sparse import gather_slices, l2_bytes, slice_grid, sm_count

_DTYPE_CODES = {getattr(torch, name): code for name, code in _build.DTYPE_CODES.items()}
_MAX_K = 1024
THREADS = 256  # a block of K4
# Blocks of K4 an SM holds at once: the kernel is built for at most 64
# registers a thread (256 threads a block), and its rings take at most
# 32 KB of shared memory a block. The plan's grid is one wave of them.
BLOCKS_PER_SM = 4
# The narrowest slice row of h that K4's plan takes. Every slice walks the
# receivers again and scores them again from g: on an H100 at the arxiv
# shape (K = 16, F = 128) slice rows under 256 bytes lost to 256 in both
# dtypes, also where they fitted the L2 with g and 256 did not (PERF.md;
# python grl_torch/probes/attention.py).
MIN_SLICE_BYTES = 256
# K4 slices h only where a slice of h and all of g take at most this many
# times the L2. On an H100 (the same probe, on the arxiv graph tiled with
# senders spread over every copy) slices of 256-byte rows beat one slice
# at 49-54 MB and 97.5 MB of slice and g, and lost at 108 MB and more
# (by 5-16%): past that each slice misses the L2 about as often as one
# slice does, and its extra walk costs more than the misses it saves.
SLICED_L2_MULTIPLE = 2


class AttentionPlan(NamedTuple):
    """Receiver-major CSR of an edge set and its transpose, on one device."""

    rowptr: torch.Tensor  # int32 (num_nodes + 1,)
    senders: torch.Tensor  # int32 (E,), grouped by receiver
    receivers: torch.Tensor  # int32 (E,), non-decreasing
    num_nodes: int
    # The sender-major CSR of the same edges (grl_tpu's ``bwd`` tables,
    # sparse_attention.py:157-164), which K4b's sender walk takes.
    colptr: torch.Tensor  # int32 (num_nodes + 1,)
    t_receivers: torch.Tensor  # int32 (E,), grouped by sender
    t_edge: torch.Tensor  # int32 (E,), each edge's position in the receiver-major order


def plan_attention(senders: np.ndarray, receivers: np.ndarray, num_nodes: int,
                   device=None) -> AttentionPlan:
    """Host planner: a stable sort of the edges by receiver, then of that
    order by sender."""
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    order = np.argsort(receivers, kind="stable")
    by_receiver = senders[order], receivers[order]
    t_edge = np.argsort(by_receiver[0], kind="stable")

    def pointers(ids):
        ptr = np.zeros(num_nodes + 1, np.int64)
        np.cumsum(np.bincount(ids, minlength=num_nodes), out=ptr[1:])
        return ptr

    def put(array):
        return torch.from_numpy(np.ascontiguousarray(array)).to(dtype=torch.int32, device=device)

    return AttentionPlan(put(pointers(receivers)), put(by_receiver[0]), put(by_receiver[1]), int(num_nodes),
                         put(pointers(senders)), put(by_receiver[1][t_edge]), put(t_edge))


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------
def _alpha(f32: torch.Tensor, g32: torch.Tensor, plan: AttentionPlan) -> torch.Tensor:
    s, r = plan.senders.long(), plan.receivers.long()
    scores = (f32[r] * g32[s]).sum(-1)
    return segment_softmax(scores, r, plan.num_nodes)


def attend_reference(f: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
                     plan: AttentionPlan) -> torch.Tensor:
    """Plain K4: scores, segment softmax and the weighted segment sum in
    float32, cast once to h's dtype."""
    alpha = _alpha(f.float(), g.float(), plan)
    messages = h.float()[plan.senders.long()] * alpha[:, None]
    return segment_sum(messages, plan.receivers.long(), plan.num_nodes).to(h.dtype)


def attend_backward(f: torch.Tensor, g: torch.Tensor, h: torch.Tensor, dout: torch.Tensor,
                    plan: AttentionPlan) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(df, dg, dh)`` of :func:`attend_reference` for ``dout``, each in
    its input's dtype (``attend_bwd``, ``sparse_attention.py:206-259``)."""
    s, r, N = plan.senders.long(), plan.receivers.long(), plan.num_nodes
    f32, g32, h32, dout32 = f.float(), g.float(), h.float(), dout.float()
    alpha = _alpha(f32, g32, plan)
    dalpha = (dout32[r] * h32[s]).sum(-1)
    dscore = alpha * (dalpha - segment_sum(alpha * dalpha, r, N)[r])
    df = segment_sum(dscore[:, None] * g32[s], r, N)
    dg = segment_sum(dscore[:, None] * f32[r], s, N)
    dh = segment_sum(alpha[:, None] * dout32[r], s, N)
    return df.to(f.dtype), dg.to(g.dtype), dh.to(h.dtype)


def receiver_walk(f: torch.Tensor, g: torch.Tensor, h: torch.Tensor, dout: torch.Tensor,
                  plan: AttentionPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K4b, launch 1: ``(df, pairs)``, df in f's dtype and the
    float32 ``(E, 2)`` pairs ``(dscore, alpha)`` in receiver-major order,
    with the kernel's arithmetic: ``m = max score``, ``p = exp(score - m)``,
    ``l = sum p``, ``u = sum p dalpha``, ``alpha = p / l`` and
    ``dscore = alpha (dalpha - u / l)``."""
    s, r, N = plan.senders.long(), plan.receivers.long(), plan.num_nodes
    f32, g32 = f.float(), g.float()
    scores = (f32[r] * g32[s]).sum(-1)
    p = torch.exp(scores - segment_max(scores, r, N)[r])
    dalpha = (dout.float()[r] * h.float()[s]).sum(-1)
    inv = 1.0 / segment_sum(p, r, N)[r]
    alpha = p * inv
    dscore = alpha * (dalpha - segment_sum(p * dalpha, r, N)[r] * inv)
    df = segment_sum(dscore[:, None] * g32[s], r, N)
    return df.to(f.dtype), torch.stack([dscore, alpha], dim=-1)


def sender_walk(f: torch.Tensor, dout: torch.Tensor, pairs: torch.Tensor,
                plan: AttentionPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K4b, launch 2: ``(dg, dh)``, each a float32 sum over a
    sender's edges in the transposed CSR, whose pairs are gathered through
    ``t_edge`` (``dg[s] = sum dscore f[r]``, ``dh[s] = sum alpha
    dout[r]``), cast once to f's and dout's dtype."""
    N = plan.num_nodes
    owner = torch.repeat_interleave(torch.arange(N, device=pairs.device), (plan.colptr[1:] - plan.colptr[:-1]).long())
    pair, r = pairs[plan.t_edge.long()], plan.t_receivers.long()
    dg = segment_sum(pair[:, :1] * f.float()[r], owner, N)
    dh = segment_sum(pair[:, 1:] * dout.float()[r], owner, N)
    return dg.to(f.dtype), dh.to(dout.dtype)


def attend_backward_walks(f: torch.Tensor, g: torch.Tensor, h: torch.Tensor, dout: torch.Tensor,
                          plan: AttentionPlan) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`attend_backward` as K4b computes it, in its two walks
    (:func:`receiver_walk`, then :func:`sender_walk`): in float32, each
    output cast once to its input's dtype where f and g share one dtype
    and h and dout another, as on every path of the port."""
    df, pairs = receiver_walk(f, g, h, dout, plan)
    dg, dh = sender_walk(f, dout, pairs, plan)
    return df, dg.to(g.dtype), dh.to(h.dtype)


# ---------------------------------------------------------------------------
# Launching the kernel
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built K4 library with its C signature declared (once)."""
    lib = _build.load_library("sparse_attention")
    lib.grl_sparse_attention.argtypes = (
        [ctypes.c_void_p] * 6  # rowptr, senders, f, g, h, out
        + [ctypes.c_int] * 8  # N, K, F, slice_cols, num_slices, group_log2, blocks, dtype
        + [ctypes.c_int, ctypes.c_void_p]  # device, stream
    )
    lib.grl_sparse_attention.restype = ctypes.c_int
    return lib


class AttentionLaunch(NamedTuple):
    """How K4 is laid out on the card."""

    group: int  # lanes that own one receiver: a power of two, 1..32
    slices: List[Tuple[int, int]]  # column slices (col0, cols) of h, as sparse.slice_grid takes them
    blocks: int  # blocks of THREADS threads in each slice's grid row


def attention_launch(N: int, K: int, F: int, itemsize: int, l2_bytes: int, sm_count: int) -> AttentionLaunch:
    """K4's layout for ``N`` receivers, ``(N, K)`` f and g and
    ``(N, F)`` h of ``itemsize``-byte elements on a card with an L2 of
    ``l2_bytes`` and ``sm_count`` SMs.

    h is walked in the column slices of :func:`~grl_torch.ops.sparse.gather_slices`,
    with all of g counted beside each slice, since every slice scores its
    receivers again from g, and widened to rows of ``MIN_SLICE_BYTES`` at
    least; in one slice where such a slice and g take more than
    ``SLICED_L2_MULTIPLE`` times the L2. A group has a lane for
    each 16-byte vector of a slice row, rounded up to a power of two and at
    most 32. The grid row is one wave of blocks, or fewer where the
    receivers need fewer. No part of it depends on the degrees.
    """
    g_bytes = N * K * itemsize
    cols = max(gather_slices(N, F, itemsize, l2_bytes, resident_bytes=g_bytes)[0][1], MIN_SLICE_BYTES // itemsize)
    if N * cols * itemsize + g_bytes > SLICED_L2_MULTIPLE * l2_bytes:
        cols = F
    slices = [(c0, min(cols, F - c0)) for c0 in range(0, F, cols)]
    vecs = slices[0][1] * itemsize // 16
    group = min(32, 1 << (vecs - 1).bit_length())
    blocks = max(1, min(-(-N // (THREADS // group)), sm_count * BLOCKS_PER_SM))
    return AttentionLaunch(group, slices, blocks)


def _launch(f: torch.Tensor, g: torch.Tensor, h: torch.Tensor, plan: AttentionPlan,
            launch: Optional[AttentionLaunch] = None) -> torch.Tensor:
    """Launch K4 on the current stream, once, laid out by ``launch`` (by
    default :func:`attention_launch` for this card; the tests and
    ``chip_smoke.py`` force one slice or several); no synchronisation."""
    if h.dtype not in _DTYPE_CODES or f.dtype != h.dtype or g.dtype != h.dtype:
        raise TypeError(f"CUDA K4 takes f, g, h all float32 or all bfloat16; got "
                        f"{f.dtype}, {g.dtype}, {h.dtype}")
    N, K = f.shape
    F = h.shape[-1]
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in (f, g, h)):
        raise ValueError("CUDA K4 needs contiguous, 16-byte aligned f, g and h")
    if F % 8 or not 1 <= K <= _MAX_K:
        raise ValueError(f"CUDA K4 needs F a multiple of 8 and 1 <= K <= {_MAX_K}; got F={F}, K={K}")
    if plan.rowptr.device != h.device:
        raise ValueError(f"plan on {plan.rowptr.device} but h on {h.device}")
    itemsize = h.element_size()
    if launch is None:
        launch = attention_launch(N, K, F, itemsize, l2_bytes(h.device.index), sm_count(h.device.index))
    slice_cols, num_slices = slice_grid(launch.slices, F, itemsize)
    group = launch.group
    if group < 1 or group > 32 or group & (group - 1) or launch.blocks < 1:
        raise ValueError(f"K4 cannot launch {launch}")
    out = torch.empty(N, F, dtype=h.dtype, device=h.device)
    if out.numel() == 0:
        return out
    lib = _library()
    err = lib.grl_sparse_attention(
        plan.rowptr.data_ptr(), plan.senders.data_ptr(), f.data_ptr(), g.data_ptr(),
        h.data_ptr(), out.data_ptr(), N, K, F, slice_cols, num_slices, group.bit_length() - 1,
        launch.blocks, _DTYPE_CODES[h.dtype],
        h.device.index, torch.cuda.current_stream(h.device).cuda_stream,
    )
    _build.check_launch(lib, err, "K4")
    return out


# Elements of an f, g, df or dg row that one lane of K4b holds
# (kKPerLane in csrc/sparse_attention_bwd.cu): a group covers K.
K_PER_LANE = 4


class BackwardLaunch(NamedTuple):
    """How K4b's two launches are laid out on the card."""

    group: int  # lanes that own one receiver (launch 1) or sender (launch 2): a power of two, 1..32
    blocks: int  # blocks of THREADS threads


def backward_launch(N: int, K: int, F: int, itemsize: int, sm_count: int) -> BackwardLaunch:
    """K4b's layout for ``N`` nodes, ``(N, K)`` f and g and ``(N, F)`` h
    and dout of ``itemsize``-byte elements on a card of ``sm_count`` SMs:
    a group has a lane for each 16-byte vector of an h row and at least one
    for every ``K_PER_LANE`` elements of K, rounded up to a power of two
    and at most 32 (a wider row takes several passes of the group); the
    grid is one wave of blocks, or fewer where the nodes need fewer."""
    need = max(F * itemsize // 16, -(-K // K_PER_LANE), 1)
    group = min(32, 1 << (need - 1).bit_length())
    blocks = max(1, min(-(-N // (THREADS // group)), sm_count * BLOCKS_PER_SM))
    return BackwardLaunch(group, blocks)


@functools.lru_cache(maxsize=None)
def _backward_library() -> ctypes.CDLL:
    """The built K4b library with its C signatures declared (once)."""
    lib = _build.load_library("sparse_attention_bwd")
    tail = [ctypes.c_int] * 6 + [ctypes.c_int, ctypes.c_void_p]  # N, K, F, group_log2, blocks, dtype; device, stream
    # rowptr, senders, f, g, h, dout, pairs, df
    lib.grl_attention_bwd_receivers.argtypes = [ctypes.c_void_p] * 8 + tail
    # colptr, t_receivers, t_edge, pairs, f, dout, dg, dh
    lib.grl_attention_bwd_senders.argtypes = [ctypes.c_void_p] * 8 + tail
    lib.grl_attention_bwd_receivers.restype = lib.grl_attention_bwd_senders.restype = ctypes.c_int
    return lib


def _backward_layout(f: torch.Tensor, dout: torch.Tensor, others, plan: AttentionPlan,
                     launch: Optional[BackwardLaunch]) -> BackwardLaunch:
    """Checks K4b's operands (f (N, K), dout (N, F) and ``others`` of
    f's or dout's shape, all float32 or all bfloat16, contiguous, 16-byte
    aligned, on the plan's device) and returns ``launch``, by default
    :func:`backward_launch` for this card."""
    tensors = (f, dout, *others)
    if dout.dtype not in _DTYPE_CODES or any(t.dtype != dout.dtype for t in tensors):
        raise TypeError(f"CUDA K4b takes operands all float32 or all bfloat16; got {[t.dtype for t in tensors]}")
    N, K = f.shape
    F = dout.shape[-1]
    if dout.shape != (N, F) or any(t.shape not in ((N, K), (N, F)) for t in others) or N != plan.num_nodes:
        raise ValueError(f"K4b needs (N, K) and (N, F) operands for the plan's {plan.num_nodes} nodes; got "
                         f"{[tuple(t.shape) for t in tensors]}")
    if any(not t.is_contiguous() or t.data_ptr() % 16 or t.device != dout.device for t in tensors):
        raise ValueError("CUDA K4b needs contiguous, 16-byte aligned operands on one device")
    if plan.colptr.device != dout.device:
        raise ValueError(f"plan on {plan.colptr.device} but dout on {dout.device}")
    if F % 8 or not 1 <= K <= 32 * K_PER_LANE:
        raise ValueError(f"CUDA K4b needs F a multiple of 8 and 1 <= K <= {32 * K_PER_LANE}; got F={F}, K={K}")
    if launch is None:
        launch = backward_launch(N, K, F, dout.element_size(), sm_count(dout.device.index))
    group = launch.group
    if group < 1 or group > 32 or group & (group - 1) or group * K_PER_LANE < K or launch.blocks < 1:
        raise ValueError(f"K4b cannot launch {launch} at K={K}")
    return launch


def _launch_receivers(f: torch.Tensor, g: torch.Tensor, h: torch.Tensor, dout: torch.Tensor,
                      plan: AttentionPlan, launch: Optional[BackwardLaunch] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K4b's receiver walk on the current stream, once: ``(df,
    pairs)`` as :func:`receiver_walk` gives them; no synchronisation."""
    launch = _backward_layout(f, dout, (g, h), plan, launch)
    N, K = f.shape
    df = torch.empty_like(f)
    pairs = torch.empty(plan.senders.numel(), 2, dtype=torch.float32, device=f.device)
    if N == 0:
        return df, pairs
    lib = _backward_library()
    err = lib.grl_attention_bwd_receivers(
        plan.rowptr.data_ptr(), plan.senders.data_ptr(), f.data_ptr(), g.data_ptr(), h.data_ptr(),
        dout.data_ptr(), pairs.data_ptr(), df.data_ptr(), N, K, dout.shape[-1], launch.group.bit_length() - 1,
        launch.blocks, _DTYPE_CODES[f.dtype], f.device.index, torch.cuda.current_stream(f.device).cuda_stream,
    )
    _build.check_launch(lib, err, "K4b receivers")
    return df, pairs


def _launch_senders(f: torch.Tensor, dout: torch.Tensor, pairs: torch.Tensor, plan: AttentionPlan,
                    launch: Optional[BackwardLaunch] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K4b's sender walk on the current stream, once: ``(dg, dh)``
    as :func:`sender_walk` gives them; no synchronisation."""
    launch = _backward_layout(f, dout, (), plan, launch)
    E = plan.t_edge.numel()
    if pairs.dtype != torch.float32 or pairs.shape != (E, 2) or not pairs.is_contiguous() or pairs.device != f.device:
        raise ValueError(f"K4b's sender walk takes the receiver walk's float32 ({E}, 2) pairs; got "
                         f"{pairs.dtype} {tuple(pairs.shape)} on {pairs.device}")
    N, K = f.shape
    dg, dh = torch.empty_like(f), torch.empty_like(dout)
    if N == 0:
        return dg, dh
    lib = _backward_library()
    err = lib.grl_attention_bwd_senders(
        plan.colptr.data_ptr(), plan.t_receivers.data_ptr(), plan.t_edge.data_ptr(), pairs.data_ptr(),
        f.data_ptr(), dout.data_ptr(), dg.data_ptr(), dh.data_ptr(), N, K, dout.shape[-1],
        launch.group.bit_length() - 1, launch.blocks, _DTYPE_CODES[f.dtype], f.device.index,
        torch.cuda.current_stream(f.device).cuda_stream,
    )
    _build.check_launch(lib, err, "K4b senders")
    return dg, dh


def attend_forward(f: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
                   plan: AttentionPlan) -> torch.Tensor:
    """``(N, F)`` attention output in h's dtype: the plain version for CPU
    tensors, K4 for CUDA tensors (counted as ``K4`` in
    :mod:`grl_torch.ops.launches`)."""
    if h.device.type == "cpu":
        return attend_reference(f, g, h, plan)
    if h.device.type != "cuda":
        raise ValueError(f"K4 runs on CUDA or CPU tensors, not {h.device}")
    out = _launch(f, g, h, plan)
    launches.count("K4")
    return out


def attend_grad(f: torch.Tensor, g: torch.Tensor, h: torch.Tensor, dout: torch.Tensor,
                plan: AttentionPlan) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(df, dg, dh)`` of the attention for ``dout``, each in its input's
    dtype: the plain walks for CPU tensors, K4b's two launches for CUDA
    tensors (counted as ``K4b receivers`` and ``K4b senders`` in
    :mod:`grl_torch.ops.launches`)."""
    if h.device.type == "cpu":
        return attend_backward_walks(f, g, h, dout, plan)
    if h.device.type != "cuda":
        raise ValueError(f"K4b runs on CUDA or CPU tensors, not {h.device}")
    df, pairs = _launch_receivers(f, g, h, dout, plan)
    launches.count("K4b receivers")
    dg, dh = _launch_senders(f, dout, pairs, plan)
    launches.count("K4b senders")
    return df, dg, dh


class _Attend(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f, g, h, plan: AttentionPlan):
        ctx.save_for_backward(f, g, h)
        ctx.plan = plan
        return attend_forward(f, g, h, plan)

    @staticmethod
    def backward(ctx, dout):
        f, g, h = ctx.saved_tensors
        df, dg, dh = attend_grad(f, g, h, dout.contiguous(), ctx.plan)
        return df, dg, dh, None


class SparseAttentionKernel:
    """A static edge set planned for fused attention
    (``sparse_attention.py:127-270``), held on ``device``."""

    def __init__(self, senders: np.ndarray, receivers: np.ndarray, num_nodes: int, device=None):
        self.num_nodes = int(num_nodes)
        self.plan = plan_attention(senders, receivers, self.num_nodes, device)

    @property
    def num_edges(self) -> int:
        return int(self.plan.senders.numel())

    def attend(self, f: torch.Tensor, g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """``(num_nodes, F)`` in h's dtype for query and key projections
        ``f``, ``g (num_nodes, K)`` and values ``h (num_nodes, F)``."""
        if f.shape[0] != self.num_nodes:
            raise ValueError(
                f"attend expects (num_nodes={self.num_nodes}, K) projections, got {tuple(f.shape)}"
            )
        return _Attend.apply(f.contiguous(), g.contiguous(), h.contiguous(), self.plan)
