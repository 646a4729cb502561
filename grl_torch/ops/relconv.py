"""Multi-relational graph convolution aggregation, in plain PyTorch.

Counterpart of ``grl_tpu/ops/relconv.py``: the adjacency ``A (B, N, L, N)``
(node, relation, neighbor — the dataset layout of the heuristic graph
builder) aggregates neighbor features per relation; the identity "self"
relation is applied as the features themselves, never as a dense
identity block. These functions are the ``kernel_impl: "xla"`` path of
the port (one batched ``torch.matmul``) and the plain versions the
hand-written kernels are held against. :func:`drop_edge` is DropEdge on
that path, with ``nn.Dropout`` semantics on the preprocessed operand.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def relational_neighbor_aggregate(V: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """Neighbor-only aggregation ``(B, N, L*F)`` — no self term, no concat.

    ``out[b, n, l*F:(l+1)*F] = sum_m A[b, n, l, m] V[b, m, :]`` as one
    batched ``(N*L, N) x (N, F)`` matmul over the free reshape of ``A``.
    """
    B, N, L, _ = A.shape
    F = V.shape[-1]
    return torch.matmul(A.reshape(B, N * L, N), V).reshape(B, N, L * F)


def relational_aggregate(
    V: torch.Tensor, A: torch.Tensor, self_scale: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """``(B, N, (L+1)*F)`` with layout ``[self | rel_0 | ... | rel_{L-1}]``.

    ``self_scale`` is an optional ``(B, N)`` per-node scale of the self
    term (DropEdge on the identity relation); ``None`` means 1.
    """
    B, N, L, _ = A.shape
    F = V.shape[-1]
    neigh = relational_neighbor_aggregate(V, A)
    self_term = V if self_scale is None else V * self_scale[..., None]
    out = torch.cat([self_term[:, :, None, :], neigh.reshape(B, N, L, F)], dim=2)
    return out.reshape(B, N, (L + 1) * F)


def preprocess_adjacency(A: torch.Tensor) -> torch.Tensor:
    """Materialize the reference's preprocessed operand ``(B, (L+1)N, N)``.

    Parity tests only; the production path never builds the identity block.
    """
    B, N, L, _ = A.shape
    eye = torch.eye(N, dtype=A.dtype, device=A.device)[None, :, None, :]
    stacked = torch.cat([eye.expand(B, N, 1, N), A], dim=2)  # (B, N, L+1, N)
    return stacked.reshape(B, (L + 1) * N, N)


def drop_edge(
    A: torch.Tensor, rate: float, generator: torch.Generator
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """DropEdge with ``nn.Dropout(rate)`` semantics on the preprocessed A.

    Counterpart of ``grl_tpu/ops/relconv.py:drop_edge`` (:97-125): an iid
    keep mask is drawn from ``generator`` over the logical
    ``(B, N, L+1, N)`` tensor, survivors are scaled by ``1/keep``, and
    relation 0's diagonal becomes the returned ``self_scale (B, N)``.
    Returns ``(A_dropped, self_scale)``; ``rate <= 0`` returns ``(A, None)``.
    """
    if rate <= 0.0:
        return A, None
    B, N, L, _ = A.shape
    keep = 1.0 - rate
    draws = torch.rand((B, N, L + 1, N), generator=generator, device=A.device)
    mask = draws < keep
    scale = 1.0 / keep
    A_dropped = A * (mask[:, :, 1:, :].to(A.dtype) * scale)
    diag = torch.diagonal(mask[:, :, 0, :], dim1=1, dim2=2)  # (B, N)
    return A_dropped, diag.to(A.dtype) * scale


def relational_aggregate_dense(V: torch.Tensor, A_pre: torch.Tensor) -> torch.Tensor:
    """Reference-layout aggregation over a preprocessed ``(B, (L+1)N, N)`` A."""
    B, N, _ = V.shape
    out = torch.matmul(A_pre, V)  # (B, (L+1)N, F)
    L1 = A_pre.shape[1] // N
    return out.reshape(B, N, L1 * V.shape[-1])
