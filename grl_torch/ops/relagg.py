"""K3, K1 and K2: relational neighbor aggregation, hand-written in CUDA.

The kernels are compiled for ``sm_90a`` at first use
(:mod:`grl_torch.ops._build`) and called through ``ctypes``:

* ``grl_torch/csrc/dropedge_sm90.cu`` holds the bfloat16 K1/K2 (TMA rings,
  ``wgmma``, and a split-K for K2 reduced inside a thread-block cluster),
  laid out by :func:`dropedge_plan`, and the bfloat16 K3 at N % 8 == 0 and
  F % 8 == 0, which is K1's kernel with the mask compiled out, laid out by
  :func:`aggregate_plan`;
* ``grl_torch/csrc/relagg_ragged.cu`` holds the bfloat16 K3 for the shapes
  TMA cannot read (the "ragged" route): the same ``wgmma`` consumer
  (``csrc/sm90.cuh``) fed by the threads' own ``cp.async`` copies, laid
  out by :func:`ragged_plan`;
* ``grl_torch/csrc/dropedge_f32.cu`` holds the float32 K2 and the float32
  K1/K3 (one kernel, the mask compiled in or out, in 3xTF32 on ``wgmma``):
  ``cp.async`` rings, a split-K over a cluster for K2 and a persistent
  schedule for the forward, laid out by :func:`dropedge_f32_plan` and
  :func:`dropedge_f32_forward_plan`.

The route is fixed by the dtype and, for the bfloat16 K3, by the shape
(:func:`k3_route`): N % 8 == 0 and F % 8 == 0 take ``dropedge_sm90.cu``,
other shapes ``relagg_ragged.cu``. A launch that fails raises; it never
turns to another route.

* K3 replaces ``grl_tpu/ops/pallas/relagg.py`` · ``pallas_neighbor_aggregate``
  (``_agg_forward`` :92-123, body ``_agg_kernel`` :76-89)::

      out[b, n, l, :] = sum_m A[b, n, l, m] * V[b, m, :]

* K1 replaces ``pallas_dropedge_aggregate`` (``_dropedge_forward``
  :213-248, body ``_dropedge_kernel`` :157-180): the same product with
  DropEdge fused into A, ``A * keep(gid) / keep``; the mask is drawn in
  the kernel and never stored.
* K2 replaces its backward ``_dropedge_bwd`` (:272-311, body
  ``_dropedge_bwd_kernel`` :183-210)::

      dV[b, m, :] = sum_{n, l} A[b, n, l, m] * keep(gid) / keep * g[b, n, l, :]

``V (B, N, F)``, ``A (B, N, L, N)`` and ``g (B, N, L, F)`` are all float32
or all bfloat16; results come back in the operand dtype with float32
accumulation.

The DropEdge mask is a pure function of the seed and the element's index
``gid = ((b*N + n)*L + l)*N + m`` in A (:func:`dropedge_keep_mask`), the
two-injection murmur hash of ``grl_tpu/ops/pallas/csr_spmm.py:_hash_keep``
(:mod:`grl_torch.ops.hashing`, shared with K5).
The TPU kernels draw per-tile bits from the TPU's hardware PRNG instead,
which no other device reproduces; keyed on the element, K1 and K2 see one
mask whatever their tiling, and the plain versions here compute the
identical mask, so the kernels are held to them exactly in the mask.

What bounds them on an H100: at the flagship's shape B=8, N=256, L=6,
F=256 each call is ~1.6 GFLOP against ~13.6 MB moved in bf16, ~120
FLOP/byte — below the card's bf16 ridge of ~295 FLOP/byte, so
device-memory bandwidth is the floor. The kernels read A in the dataset
layout with no transpose and write their output in place in the operand
dtype, so each operand crosses device memory once (see the notes at the
top of the sources).

Every wrapper takes its plain version for CPU tensors and launches its
kernel for CUDA tensors, or raises; it counts its launches in
:mod:`grl_torch.ops.launches`:

* :func:`neighbor_aggregate` — K3. Its backward is the plain einsums of
  ``relagg.py:136-142`` (XLA on the TPU, not Pallas).
* :func:`dropedge_aggregate` — K1 (``rate == 0`` is K3, as in
  ``grl_tpu``); its backward is :func:`dropedge_aggregate_grad` — K2.

K3 and K2 also count their launches by route (``K3 sm90`` and so on).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Tuple

import torch

from grl_torch.ops import _build, launches
from grl_torch.ops.hashing import Seed, keep_bits, keep_probability, seed_tensor

_MAX_GRID_YZ = 65535
_TILE_ROWS = 64  # output rows per block of the bf16 kernels (kTile in csrc/sm90.cuh)
# dropedge_f32.cu: a block's 128 x 128 output tile and 32-row (K2) or
# 32-column (K1/K3) reduction steps.
_F32_TILE = 128
_F32_STEP = 32
_MAX_ELEMENTS = 2**32  # gid is a uint32 in the kernels
# dropedge_sm90.cu: wgmma's widest N and the portable cluster size.
_MAX_BN = 256
_MAX_SPLITS = 8
# K2's split aims at one block for every two of the H100's 132 SMs: past
# that, the cluster's sum of S partials costs more than the shorter walk
# saves (chip_smoke.py times K2 under every S at the main shape).
_SPLIT_BLOCKS = 132 // 2
# The float32 kernels' shared memory (128 KB for K2, 205 KB for K1/K3) holds one block
# an SM, so at most 132 blocks run at once; clusters of S must each fit in
# one GPC, so fewer may (``f32_capacity`` and ``f32_forward_slots`` ask the card).
_F32_SLOTS = 132


# ---------------------------------------------------------------------------
# The DropEdge mask
# ---------------------------------------------------------------------------
def dropedge_keep_mask(seed: Seed, shape, rate: float, device=None) -> torch.Tensor:
    """Boolean keep mask over a tensor of ``shape``: element ``gid`` (its
    row-major index) is kept iff
    ``(mix(mix(gid ^ s) + s) >> 8) * 2^-24 < keep`` with ``s = seed mod 2^32``
    (``seed`` an int or a one-element int32 tensor, read on the device).
    """
    numel = math.prod(shape)
    if numel >= _MAX_ELEMENTS:
        raise ValueError(f"DropEdge mask over {numel} elements: the element index must fit 32 bits")
    gid = torch.arange(numel, dtype=torch.int64, device=device).reshape(tuple(shape))
    return keep_bits(gid, seed, rate)


def _masked_float(A: torch.Tensor, seed: Seed, rate: float) -> torch.Tensor:
    return torch.where(dropedge_keep_mask(seed, A.shape, rate, A.device), A.float(), 0.0)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------
def neighbor_aggregate_reference(V: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """Plain K3: one float32 batched matmul, cast to V's dtype."""
    B, N, L, _ = A.shape
    F = V.shape[-1]
    out = torch.matmul(A.float().reshape(B, N * L, N), V.float())
    return out.reshape(B, N, L, F).to(V.dtype)


def dropedge_aggregate_reference(V: torch.Tensor, A: torch.Tensor, seed: Seed,
                                 rate: float) -> torch.Tensor:
    """Plain K1: the mask applied in float32, ``1/keep`` on the float32
    product, cast once to V's dtype. Differentiable in V."""
    B, N, L, _ = A.shape
    F = V.shape[-1]
    out = torch.matmul(_masked_float(A, seed, rate).reshape(B, N * L, N), V.float())
    out = out * (1.0 / keep_probability(rate))
    return out.reshape(B, N, L, F).to(V.dtype)


def dropedge_aggregate_grad_reference(g: torch.Tensor, A: torch.Tensor, seed: Seed,
                                      rate: float) -> torch.Tensor:
    """Plain K2: ``dV (B, N, F)`` in g's dtype, mask applied in float32."""
    B, N, L, _ = A.shape
    F = g.shape[-1]
    A_m = _masked_float(A, seed, rate).reshape(B, N * L, N)
    dV = torch.matmul(A_m.transpose(1, 2), g.float().reshape(B, N * L, F))
    return (dV * (1.0 / keep_probability(rate))).to(g.dtype)


# ---------------------------------------------------------------------------
# The launch plans of dropedge_sm90.cu (bfloat16 K3, K1, K2),
# relagg_ragged.cu (bfloat16 K3 at other shapes) and dropedge_f32.cu
# (float32 K1, K2, K3)
# ---------------------------------------------------------------------------
def check_sm90_shape(N: int, F: int) -> None:
    """bf16 K1/K2 (and K3's sm90 route) read A, V and g through TMA, whose
    global strides must be multiples of 16 bytes: raise ``ValueError``
    unless N % 8 == 0 and F % 8 == 0."""
    unmet = [f"{name} % 8 == 0 (got {name}={value})" for name, value in (("N", N), ("F", F)) if value % 8]
    if unmet:
        raise ValueError(
            "bfloat16 K1/K2 read their operands through TMA, whose global strides are "
            "multiples of 16 bytes: they need " + " and ".join(unmet)
        )


def k3_route(dtype: torch.dtype, N: int, F: int) -> str:
    """The kernel K3 launches for CUDA tensors: ``"sm90"`` (bfloat16, N % 8
    == 0 and F % 8 == 0: dropedge_sm90.cu), ``"ragged"`` (other bfloat16
    shapes: relagg_ragged.cu, any N and F) or ``"float32"``
    (dropedge_f32.cu's forward, any N and F)."""
    if dtype != torch.bfloat16:
        return "float32"
    return "ragged" if N % 8 or F % 8 else "sm90"


@dataclasses.dataclass(frozen=True)
class AggregatePlan:
    """How dropedge_sm90.cu tiles K3 (and K1, :class:`DropEdgePlan`) for A
    (B, N, L, N) and F feature columns: 64 x 64 tiles of A's (N*L, N) view
    and output tiles of 64 rows by ``BN`` columns. ``forward_grid`` =
    (f_tiles, row_tiles, B): block (x, y, z) owns output rows 64y.. of batch
    z's N*L and columns BN*x.., over the ceil(N / 64) column steps of A."""

    B: int
    N: int
    L: int
    F: int
    BN: int

    @property
    def f_tiles(self) -> int:
        return -(-self.F // self.BN)

    @property
    def row_tiles(self) -> int:
        return -(-self.N * self.L // _TILE_ROWS)

    @property
    def m_tiles(self) -> int:
        return -(-self.N // _TILE_ROWS)

    @property
    def forward_grid(self) -> Tuple[int, int, int]:
        return (self.f_tiles, self.row_tiles, self.B)


@functools.lru_cache(maxsize=256)
def aggregate_plan(B: int, N: int, L: int, F: int) -> AggregatePlan:
    """The width and grid of K3 on dropedge_sm90.cu for A (B, N, L, N):
    ``BN`` = min(F, 256) rounded up to a multiple of 64 (TMA zero-fills the
    F edge; the epilogue masks it), no split. Raises ``ValueError`` for
    N % 8, F % 8 (:func:`check_sm90_shape`) or a grid past the card's
    limits. Cached: the wrapper asks at every launch."""
    _check_grid(B, N, L, F, _TILE_ROWS)
    check_sm90_shape(N, F)
    return AggregatePlan(B, N, L, F, _forward_width(F))


def _forward_width(F: int) -> int:
    """BN of the bf16 forward kernels: F rounded up to a multiple of 64
    (the 128-byte swizzle atom of V's MN-major boxes), at most 256."""
    return min(-(-F // 64) * 64, _MAX_BN)


def _check_grid(B: int, N: int, L: int, F: int, rows: int) -> None:
    if min(B, N, L, F) < 1:
        raise ValueError(f"empty shape B={B}, N={N}, L={L}, F={F}")
    if B > _MAX_GRID_YZ or -(-N * L // rows) > _MAX_GRID_YZ:
        raise ValueError(f"shape B={B}, N*L={N * L} exceeds the kernel's grid limits")


@dataclasses.dataclass(frozen=True)
class RaggedPlan(AggregatePlan):
    """How relagg_ragged.cu tiles K3 (bf16, any N and F): K1's forward
    layout (:class:`AggregatePlan`), with A copied by the threads instead of
    TMA. ``vec`` is the copy width in elements the shape allows (2, 4-byte
    copies: N and F even; else 1, 2-byte loads); ``v_tma``: V is read
    through TMA (F % 8 == 0), else copied like A. The launcher narrows both
    where an operand's alignment forbids them."""

    @property
    def vec(self) -> int:
        return 1 if self.N % 2 or self.F % 2 else 2

    @property
    def v_tma(self) -> bool:
        return self.F % 8 == 0


@functools.lru_cache(maxsize=256)
def ragged_plan(B: int, N: int, L: int, F: int) -> RaggedPlan:
    """The width and grid of K3 on relagg_ragged.cu for A (B, N, L, N), any
    N and F: ``BN`` as the sm90 route's (F rounded up to 64, at most 256;
    the copies zero-fill past F, the epilogue stores columns < F), no split.
    Raises ``ValueError`` for an empty shape or a grid past the card's
    limits. Cached: the wrapper asks at every launch."""
    _check_grid(B, N, L, F, _TILE_ROWS)
    return RaggedPlan(B, N, L, F, _forward_width(F))


@dataclasses.dataclass(frozen=True)
class DropEdgePlan(AggregatePlan):
    """How dropedge_sm90.cu tiles K1 and K2 for A (B, N, L, N) and F
    feature columns.

    Both kernels step through A's (N*L, N) view in 64 x 64 tiles and write
    output tiles of 64 rows by ``BN`` columns.

    * K1, ``forward_grid``: as K3's (:class:`AggregatePlan`).
    * K2, ``backward_grid`` = (splits * f_tiles, m_tiles, B) in clusters of
      ``cluster`` = (splits, 1, 1): the blocks of a cluster share output
      rows 64y.. of batch z's N and columns BN*(x // splits)..; block
      x % splits walks ``steps // splits`` consecutive 64-row steps of the
      N*L reduction rows and the cluster sums the partials.
    """

    splits: int

    @property
    def steps(self) -> int:
        """K2's 64-row steps over the N*L reduction rows."""
        return self.row_tiles

    @property
    def backward_grid(self) -> Tuple[int, int, int]:
        return (self.splits * self.f_tiles, self.m_tiles, self.B)

    @property
    def cluster(self) -> Tuple[int, int, int]:
        return (self.splits, 1, 1)


@functools.lru_cache(maxsize=256)
def dropedge_plan(B: int, N: int, L: int, F: int) -> DropEdgePlan:
    """The tiles, split and grids of the bfloat16 K1/K2 for A (B, N, L, N).

    ``BN`` = min(F, 256) rounded up to a multiple of 64 (TMA zero-fills the
    F edge; the epilogues mask it). K2 splits its ceil(N*L / 64) row steps
    ``S`` ways, S a divisor of the step count and at most 8: the smallest S
    whose grid reaches 66 blocks, half the H100's 132 SMs, else the largest.
    Raises ``ValueError`` for N % 8, F % 8 (:func:`check_sm90_shape`) or a
    grid past the card's limits. Cached: the wrappers ask at every launch.
    """
    forward = aggregate_plan(B, N, L, F)
    steps = forward.row_tiles
    tiles = B * forward.m_tiles * forward.f_tiles
    divisors = [s for s in range(1, _MAX_SPLITS + 1) if steps % s == 0]
    splits = next((s for s in divisors if tiles * s >= _SPLIT_BLOCKS), divisors[-1])
    return DropEdgePlan(B, N, L, F, forward.BN, splits)


@dataclasses.dataclass(frozen=True)
class DropEdgeF32Plan:
    """How dropedge_f32.cu tiles the float32 K2 for A (B, N, L, N) and g
    (B, N, L, F): output tiles of 128 x 128 (rows m of batch z's N, columns
    f), reduction steps of 32 of A's N*L rows. ``grid`` = (splits * f_tiles,
    m_tiles, B) in clusters of ``cluster`` = (splits, 1, 1): the blocks of a
    cluster share output rows 128y.. and columns 128*(x // splits)..; block
    x % splits walks ``steps // splits`` consecutive steps and the cluster
    sums the partials. ``vec`` is the copy width in floats the shape allows
    (4: N % 4 == 0 and F % 4 == 0; else 1); the launcher takes 1 also where
    an operand is not 16-byte aligned."""

    B: int
    N: int
    L: int
    F: int
    splits: int

    @property
    def f_tiles(self) -> int:
        return -(-self.F // _F32_TILE)

    @property
    def m_tiles(self) -> int:
        return -(-self.N // _F32_TILE)

    @property
    def steps(self) -> int:
        return -(-self.N * self.L // _F32_STEP)

    @property
    def vec(self) -> int:
        return 1 if self.N % 4 or self.F % 4 else 4

    @property
    def grid(self) -> Tuple[int, int, int]:
        return (self.splits * self.f_tiles, self.m_tiles, self.B)

    @property
    def cluster(self) -> Tuple[int, int, int]:
        return (self.splits, 1, 1)


@functools.lru_cache(maxsize=256)
def dropedge_f32_plan(B: int, N: int, L: int, F: int,
                      capacity: Tuple[int, ...] = (_F32_SLOTS,) * _MAX_SPLITS) -> DropEdgeF32Plan:
    """The split and grid of the float32 K2 for A (B, N, L, N), any N and F.

    S divides the ceil(N*L / 32) reduction steps and is at most 8, so every
    split walks whole steps. ``capacity[S - 1]`` is how many blocks the card
    runs at once in clusters of S (:func:`f32_capacity` on the card; by
    default one an SM of the H100's 132), so a grid of T * S blocks takes
    ceil(T * S / capacity) waves of blocks that each walk 1/S of the steps:
    S minimises that, the smaller S on a tie (its cluster sums fewer
    partials). Raises ``ValueError`` for an empty shape or a grid past the
    card's limits. Cached: the wrapper asks at every launch.
    """
    if min(B, N, L, F) < 1:
        raise ValueError(f"empty shape B={B}, N={N}, L={L}, F={F}")
    plan = DropEdgeF32Plan(B, N, L, F, 1)
    if B > _MAX_GRID_YZ or plan.m_tiles > _MAX_GRID_YZ:
        raise ValueError(f"shape B={B}, N={N} exceeds the kernel's grid limits")
    tiles = B * plan.m_tiles * plan.f_tiles
    divisors = [s for s in range(1, _MAX_SPLITS + 1) if plan.steps % s == 0]
    splits = min(divisors, key=lambda s: (-(-tiles * s // max(capacity[s - 1], 1)) / s, s))
    return dataclasses.replace(plan, splits=splits)


@dataclasses.dataclass(frozen=True)
class DropEdgeF32ForwardPlan:
    """How dropedge_f32.cu runs the float32 K1 and K3 for A (B, N, L, N) and
    V (B, N, F): output tiles of 128 x 128 (rows of a batch's N*L, columns
    f), ``tiles`` of them, reduction steps of 32 of A's N columns (V's
    rows), on ``grid`` = (blocks, 1, 1): block c walks tiles c, c + blocks,
    ... as one stream of stages, so a tile's copies overlap the one before
    it."""

    B: int
    N: int
    L: int
    F: int
    blocks: int

    @property
    def f_tiles(self) -> int:
        return -(-self.F // _F32_TILE)

    @property
    def row_tiles(self) -> int:
        return -(-self.N * self.L // _F32_TILE)

    @property
    def tiles(self) -> int:
        return self.B * self.row_tiles * self.f_tiles

    @property
    def steps(self) -> int:
        return -(-self.N // _F32_STEP)

    @property
    def vec(self) -> int:
        """The copy width in floats the shape allows: 4 (16-byte copies) where
        N % 4 == 0 and F % 4 == 0, 2 where both are even, else 1."""
        return 4 if self.N % 4 == 0 and self.F % 4 == 0 else 2 if self.N % 2 == 0 and self.F % 2 == 0 else 1

    @property
    def grid(self) -> Tuple[int, int, int]:
        return (self.blocks, 1, 1)


@functools.lru_cache(maxsize=256)
def dropedge_f32_forward_plan(B: int, N: int, L: int, F: int, slots: int = _F32_SLOTS) -> DropEdgeF32ForwardPlan:
    """The grid of the float32 K1/K3 for A (B, N, L, N), any N and F: one
    block for each of the ``slots`` the card runs at once
    (:func:`f32_forward_slots`; by default one an SM of the H100's 132), or
    one a tile where there are fewer tiles. Raises ``ValueError`` for an
    empty shape or a grid past the card's limits. Cached: the wrapper asks
    at every launch."""
    _check_grid(B, N, L, F, _F32_TILE)
    plan = DropEdgeF32ForwardPlan(B, N, L, F, 1)
    return dataclasses.replace(plan, blocks=max(min(plan.tiles, slots), 1))


# ---------------------------------------------------------------------------
# Launching the kernels
# ---------------------------------------------------------------------------
def _check(V: torch.Tensor, A: torch.Tensor) -> None:
    if V.dim() != 3 or A.dim() != 4:
        raise ValueError(
            f"expected V (B,N,F) and A (B,N,L,N); got {tuple(V.shape)} and {tuple(A.shape)}"
        )
    B, N, F = V.shape
    if A.shape[0] != B or A.shape[1] != N or A.shape[3] != N:
        raise ValueError(
            f"A {tuple(A.shape)} does not match V {tuple(V.shape)}: need A (B,N,L,N)"
        )
    if A.dtype != V.dtype:
        raise TypeError(f"A and V must share a dtype; got {A.dtype} and {V.dtype}")
    if A.device != V.device:
        raise ValueError(f"A on {A.device} but V on {V.device}")


def _check_grad(g: torch.Tensor, A: torch.Tensor) -> None:
    B, N, L, _ = A.shape
    if g.dim() != 4 or tuple(g.shape[:3]) != (B, N, L):
        raise ValueError(f"g {tuple(g.shape)} does not match A {tuple(A.shape)}: need g (B,N,L,F)")
    if g.dtype != A.dtype:
        raise TypeError(f"g and A must share a dtype; got {g.dtype} and {A.dtype}")
    if g.device != A.device:
        raise ValueError(f"A on {A.device} but g on {g.device}")


def _check_mask(A: torch.Tensor, rate: float) -> None:
    keep_probability(rate)
    if A.numel() >= _MAX_ELEMENTS:
        raise ValueError(
            f"A has {A.numel()} elements; DropEdge keys its mask on a 32-bit element index"
        )


@functools.lru_cache(maxsize=None)
def _sm90_library() -> ctypes.CDLL:
    """dropedge_sm90.cu's library with its C signatures declared (once)."""
    lib = _build.load_library("dropedge_sm90")
    head = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5  # A, X, out, B, N, L, F, BN
    mask = [ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]  # seed (a device pointer), keep, device, stream
    lib.grl_relagg_sm90_forward.argtypes = head + mask[2:]
    lib.grl_dropedge_sm90_forward.argtypes = head + mask
    lib.grl_dropedge_sm90_backward.argtypes = head + [ctypes.c_int] + mask  # ... S
    lib.grl_dropedge_sm90_max_clusters.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    for name in ("grl_relagg_sm90_forward", "grl_dropedge_sm90_forward", "grl_dropedge_sm90_backward",
                 "grl_dropedge_sm90_max_clusters"):
        getattr(lib, name).restype = ctypes.c_int
    return lib


def _launch_aggregate_sm90(A: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """The bfloat16 K3 of dropedge_sm90.cu on the current stream, laid out
    by :func:`aggregate_plan`; no synchronisation. Raises for a shape or an
    operand TMA cannot read."""
    if not (V.is_contiguous() and A.is_contiguous()):
        raise ValueError("CUDA relagg needs contiguous operands (dataset layout)")
    if A.data_ptr() % 16 or V.data_ptr() % 16:
        raise ValueError("bfloat16 K3 at N % 8 == 0 and F % 8 == 0 needs 16-byte aligned operands (TMA)")
    B, N, L, _ = A.shape
    F = V.shape[-1]
    out = torch.empty((B, N, L, F), dtype=V.dtype, device=V.device)
    if out.numel() == 0:
        return out
    plan = aggregate_plan(B, N, L, F)
    lib = _sm90_library()
    stream = torch.cuda.current_stream(V.device).cuda_stream
    err = lib.grl_relagg_sm90_forward(A.data_ptr(), V.data_ptr(), out.data_ptr(), B, N, L, F, plan.BN,
                                      V.device.index, stream)
    _build.check_launch(lib, err, "bf16 K3")
    return out


def _launch_sm90(backward: bool, A: torch.Tensor, X: torch.Tensor, seed: Seed, keep: float,
                 plan: DropEdgePlan = None) -> torch.Tensor:
    """The bfloat16 K1 (``X`` = V) or K2 (``X`` = g) of dropedge_sm90.cu on
    the current stream, laid out by ``plan`` (default
    :func:`dropedge_plan`'s); no synchronisation. ``keep`` 1.0 launches K1
    with no entry dropped. The kernel reads ``seed`` from device memory
    (:func:`~grl_torch.ops.hashing.seed_tensor`)."""
    if not (X.is_contiguous() and A.is_contiguous()):
        raise ValueError("CUDA relagg needs contiguous operands (dataset layout)")
    if A.data_ptr() % 16 or X.data_ptr() % 16:
        raise ValueError("bfloat16 K1/K2 need 16-byte aligned operands (TMA)")
    B, N, L, _ = A.shape
    F = X.shape[-1]
    shape = (B, N, F) if backward else (B, N, L, F)
    if math.prod(shape) == 0:
        return torch.empty(shape, dtype=X.dtype, device=X.device)
    plan = plan or dropedge_plan(B, N, L, F)
    out = torch.empty(shape, dtype=X.dtype, device=X.device)
    lib = _sm90_library()
    stream = torch.cuda.current_stream(X.device).cuda_stream
    head = (A.data_ptr(), X.data_ptr(), out.data_ptr(), B, N, L, F, plan.BN)
    seed = seed_tensor(seed, X.device)
    tail = (seed.data_ptr(), keep, X.device.index, stream)
    if backward:
        err = lib.grl_dropedge_sm90_backward(*head, plan.splits, *tail)
    else:
        err = lib.grl_dropedge_sm90_forward(*head, *tail)
    _build.check_launch(lib, err, "bf16 K2" if backward else "bf16 K1")
    return out


def sm90_max_clusters(plan: DropEdgePlan, device: int = 0) -> int:
    """How many of K2's clusters under ``plan`` the card holds at once
    (``cudaOccupancyMaxActiveClusters``; 0: none launch)."""
    lib = _sm90_library()
    clusters = ctypes.c_int(0)
    err = lib.grl_dropedge_sm90_max_clusters(plan.BN, plan.splits, device, ctypes.byref(clusters))
    _build.check_launch(lib, err, "cudaOccupancyMaxActiveClusters")
    return clusters.value


@functools.lru_cache(maxsize=None)
def _ragged_library() -> ctypes.CDLL:
    """relagg_ragged.cu's library with its C signature declared (once)."""
    lib = _build.load_library("relagg_ragged")
    lib.grl_relagg_ragged_forward.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7  # A, V, out, B, N, L, F, BN, vec, v_tma
        + [ctypes.c_int, ctypes.c_void_p])  # device, stream
    lib.grl_relagg_ragged_forward.restype = ctypes.c_int
    return lib


def _launch_ragged(A: torch.Tensor, V: torch.Tensor, plan: RaggedPlan = None) -> torch.Tensor:
    """The bfloat16 K3 of relagg_ragged.cu on the current stream, laid out
    by ``plan`` (default :func:`ragged_plan`'s); no synchronisation. The
    copy width and V's TMA are the plan's where the operands' alignment
    allows them (4 bytes for 4-byte copies, 16 for TMA), else narrower."""
    if not (V.is_contiguous() and A.is_contiguous()):
        raise ValueError("CUDA relagg needs contiguous operands (dataset layout)")
    B, N, L, _ = A.shape
    F = V.shape[-1]
    out = torch.empty((B, N, L, F), dtype=V.dtype, device=V.device)
    if out.numel() == 0:
        return out
    plan = plan or ragged_plan(B, N, L, F)
    v_tma = plan.v_tma and V.data_ptr() % 16 == 0
    vec = 2 if plan.vec == 2 and A.data_ptr() % 4 == 0 and (v_tma or V.data_ptr() % 4 == 0) else 1
    lib = _ragged_library()
    stream = torch.cuda.current_stream(V.device).cuda_stream
    err = lib.grl_relagg_ragged_forward(A.data_ptr(), V.data_ptr(), out.data_ptr(), B, N, L, F, plan.BN, vec,
                                        int(v_tma), V.device.index, stream)
    _build.check_launch(lib, err, "bf16 K3 (ragged)")
    return out


@functools.lru_cache(maxsize=None)
def _f32_library() -> ctypes.CDLL:
    """dropedge_f32.cu's library with its C signatures declared (once)."""
    lib = _build.load_library("dropedge_f32")
    lib.grl_dropedge_f32_backward.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6  # A, g, dV, B, N, L, F, S, vec
        + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])  # seed pointer, keep, device, stream
    lib.grl_dropedge_f32_forward.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7  # A, V, out, B, N, L, F, blocks, vec, mask
        + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])  # seed pointer, keep, device, stream
    lib.grl_dropedge_f32_max_clusters.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]
    lib.grl_dropedge_f32_forward_slots.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    for name in ("grl_dropedge_f32_backward", "grl_dropedge_f32_forward", "grl_dropedge_f32_max_clusters",
                 "grl_dropedge_f32_forward_slots"):
        getattr(lib, name).restype = ctypes.c_int
    return lib


def _launch_f32_grad(A: torch.Tensor, g: torch.Tensor, seed: Seed, keep: float,
                     plan: DropEdgeF32Plan = None) -> torch.Tensor:
    """The float32 K2 of dropedge_f32.cu on the current stream, laid out by
    ``plan`` (default :func:`dropedge_f32_plan`'s); no synchronisation."""
    if not (g.is_contiguous() and A.is_contiguous()):
        raise ValueError("CUDA relagg needs contiguous operands (dataset layout)")
    B, N, L, _ = A.shape
    F = g.shape[-1]
    dV = torch.empty((B, N, F), dtype=g.dtype, device=g.device)
    if dV.numel() == 0:
        return dV
    plan = plan or dropedge_f32_plan(B, N, L, F, f32_capacity(g.device.index))
    vec = 4 if plan.vec == 4 and not (A.data_ptr() % 16 or g.data_ptr() % 16 or dV.data_ptr() % 16) else 1
    lib = _f32_library()
    stream = torch.cuda.current_stream(g.device).cuda_stream
    seed = seed_tensor(seed, g.device)
    err = lib.grl_dropedge_f32_backward(A.data_ptr(), g.data_ptr(), dV.data_ptr(), B, N, L, F, plan.splits, vec,
                                        seed.data_ptr(), keep, g.device.index, stream)
    _build.check_launch(lib, err, "f32 K2")
    return dV


def _launch_f32_forward(A: torch.Tensor, V: torch.Tensor, seed: Seed, keep: float, mask: bool,
                        plan: DropEdgeF32ForwardPlan = None) -> torch.Tensor:
    """The float32 K1 (``mask``) or K3 of dropedge_f32.cu on the current
    stream, laid out by ``plan`` (default :func:`dropedge_f32_forward_plan`'s);
    no synchronisation. ``keep`` 1.0 with ``mask`` drops nothing and gives
    K3's bits. K1 reads ``seed`` from device memory; K3 takes ``None``."""
    if V.dtype != torch.float32:
        raise TypeError(f"CUDA relagg takes float32 or bfloat16, not {V.dtype}")
    if not (V.is_contiguous() and A.is_contiguous()):
        raise ValueError("CUDA relagg needs contiguous operands (dataset layout)")
    B, N, L, _ = A.shape
    F = V.shape[-1]
    out = torch.empty((B, N, L, F), dtype=V.dtype, device=V.device)
    if out.numel() == 0:
        return out
    plan = plan or dropedge_f32_forward_plan(B, N, L, F, f32_forward_slots(V.device.index))
    vec = next(v for v in (4, 2, 1) if v <= plan.vec and not any(t.data_ptr() % (4 * v) for t in (A, V, out)))
    lib = _f32_library()
    stream = torch.cuda.current_stream(V.device).cuda_stream
    seed = seed_tensor(seed, V.device) if mask else None
    err = lib.grl_dropedge_f32_forward(A.data_ptr(), V.data_ptr(), out.data_ptr(), B, N, L, F, plan.blocks, vec,
                                       int(mask), seed.data_ptr() if mask else None, keep, V.device.index,
                                       stream)
    _build.check_launch(lib, err, "f32 K1" if mask else "f32 K3")
    return out


def f32_max_clusters(splits: int, device: int = 0) -> int:
    """How many of the float32 K2's clusters of ``splits`` blocks the card
    holds at once (``cudaOccupancyMaxActiveClusters``; 0: none launch)."""
    lib = _f32_library()
    clusters = ctypes.c_int(0)
    err = lib.grl_dropedge_f32_max_clusters(splits, device, ctypes.byref(clusters))
    _build.check_launch(lib, err, "cudaOccupancyMaxActiveClusters")
    return clusters.value


@functools.lru_cache(maxsize=None)
def f32_capacity(device: int) -> Tuple[int, ...]:
    """Blocks of the float32 K2 that ``device`` runs at once in clusters of
    S = 1..8: :func:`dropedge_f32_plan`'s ``capacity``, asked once a
    device."""
    return tuple(S * f32_max_clusters(S, device) for S in range(1, _MAX_SPLITS + 1))


@functools.lru_cache(maxsize=None)
def f32_forward_slots(device: int) -> int:
    """Blocks of the float32 K1/K3 that ``device`` runs at once: the
    ``slots`` of :func:`dropedge_f32_forward_plan`, asked once a device."""
    lib = _f32_library()
    slots = ctypes.c_int(0)
    err = lib.grl_dropedge_f32_forward_slots(device, ctypes.byref(slots))
    _build.check_launch(lib, err, "cudaOccupancyMaxActiveBlocksPerMultiprocessor")
    return slots.value


def _by_device(tensor: torch.Tensor) -> str:
    if tensor.device.type not in ("cuda", "cpu"):
        raise ValueError(f"relagg runs on CUDA or CPU tensors, not {tensor.device}")
    return tensor.device.type


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------
class _NeighborAggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, V: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(V, A)
        if _by_device(V) == "cpu":
            return neighbor_aggregate_reference(V, A)
        route = k3_route(V.dtype, A.shape[1], V.shape[-1])
        if route == "sm90":
            out = _launch_aggregate_sm90(A, V)
        elif route == "ragged":
            out = _launch_ragged(A, V)
        else:
            out = _launch_f32_forward(A, V, None, 1.0, mask=False)
        launches.count("K3", f"K3 {route}")
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        V, A = ctx.saved_tensors
        dV = dA = None
        if ctx.needs_input_grad[0]:
            # dV[b,m,f] = sum_{n,l} A[b,n,l,m] g[b,n,l,f]
            dV = torch.einsum("bnlm,bnlf->bmf", A, g).to(V.dtype)
        if ctx.needs_input_grad[1]:
            # dA[b,n,l,m] = g[b,n,l,:] . V[b,m,:]
            dA = torch.einsum("bnlf,bmf->bnlm", g, V).to(A.dtype)
        return dV, dA


def neighbor_aggregate(V: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """``(B,N,L,F)`` neighbor aggregate of ``V (B,N,F)`` by ``A (B,N,L,N)``.

    CPU tensors take :func:`neighbor_aggregate_reference`; CUDA tensors
    launch the K3 kernel of :func:`k3_route` (counted as ``K3`` and by
    route in :mod:`grl_torch.ops.launches`) or raise —
    there is no fallback.
    """
    _check(V, A)
    return _NeighborAggregate.apply(V, A)


# ---------------------------------------------------------------------------
# K1 and K2
# ---------------------------------------------------------------------------
def _dropedge_forward(V: torch.Tensor, A: torch.Tensor, seed: Seed, rate: float) -> torch.Tensor:
    """K1 for CUDA tensors (bfloat16: dropedge_sm90.cu; float32:
    dropedge_f32.cu), its plain version for CPU tensors."""
    if _by_device(V) == "cpu":
        return dropedge_aggregate_reference(V, A, seed, rate)
    if V.dtype == torch.bfloat16:
        out = _launch_sm90(False, A, V, seed, keep_probability(rate))
    else:
        out = _launch_f32_forward(A, V, seed, keep_probability(rate), mask=True)
    launches.count("K1")
    return out


def dropedge_aggregate_grad(g: torch.Tensor, A: torch.Tensor, seed: Seed, rate: float) -> torch.Tensor:
    """``dV (B, N, F)`` of :func:`dropedge_aggregate` for the output
    cotangent ``g (B, N, L, F)``: the K2 kernel on CUDA tensors (bfloat16:
    dropedge_sm90.cu; float32: dropedge_f32.cu; counted as ``K2`` and by
    route in :mod:`grl_torch.ops.launches`), its
    plain version on CPU ones."""
    _check_grad(g, A)
    _check_mask(A, rate)
    if _by_device(g) == "cpu":
        return dropedge_aggregate_grad_reference(g, A, seed, rate)
    if g.dtype == torch.bfloat16:
        dV, route = _launch_sm90(True, A, g, seed, keep_probability(rate)), "sm90"
    elif g.dtype == torch.float32:
        dV, route = _launch_f32_grad(A, g, seed, keep_probability(rate)), "float32"
    else:
        raise TypeError(f"CUDA relagg takes float32 or bfloat16, not {g.dtype}")
    launches.count("K2", f"K2 {route}")
    return dV



class _DropEdgeAggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, V: torch.Tensor, A: torch.Tensor, seed: Seed, rate: float) -> torch.Tensor:
        ctx.save_for_backward(A)
        ctx.seed, ctx.rate = seed, rate
        return _dropedge_forward(V, A, seed, rate)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (A,) = ctx.saved_tensors
        dV = None
        if ctx.needs_input_grad[0]:
            dV = dropedge_aggregate_grad(g.contiguous(), A, ctx.seed, ctx.rate)
        # A is data and the seed an integer: in grl_tpu their cotangents are
        # zeros that are never used (relagg.py:308-311). K2 reads the seed
        # tensor the forward read.
        return dV, None, None, None


def dropedge_aggregate(V: torch.Tensor, A: torch.Tensor, seed: Seed, rate: float) -> torch.Tensor:
    """``(B,N,L,F)`` neighbor aggregate of ``V`` by ``A`` with DropEdge.

    ``seed`` is an int or a one-element int32 tensor on V's device
    (``Rngs.kernel_seed`` draws one there, so a captured CUDA graph draws a
    new one at each replay), and ``rate`` the drop probability. ``rate == 0``
    is exactly K3. Otherwise CPU tensors take
    :func:`dropedge_aggregate_reference`; CUDA tensors launch K1 (counted as
    ``K1`` in :mod:`grl_torch.ops.launches`) or raise. The gradient in V is
    :func:`dropedge_aggregate_grad` (K2 on CUDA).
    """
    _check(V, A)
    _check_mask(A, rate)
    if float(rate) == 0.0:
        return neighbor_aggregate(V, A)
    return _DropEdgeAggregate.apply(V, A, seed, float(rate))

