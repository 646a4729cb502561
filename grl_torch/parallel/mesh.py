"""The ``data`` x ``model`` mesh over a world of processes, and tensor
parallelism.

Counterpart of ``grl_tpu/parallel/mesh.py`` (:24-107). ``grl_tpu`` lays a
``jax.sharding.Mesh`` over the devices of one program and lets XLA insert
the collectives. Here a mesh of D devices is a world of D processes, one
a device: a :class:`Mesh` holds the axis names and sizes, this rank's
coordinates and one process group per axis line (the ranks that differ
only along that axis), and the port calls the collectives itself.

* ``data``: every rank reads the whole global batch and keeps its rows
  (:func:`shard_batch`); the gradients are summed over the axis.
* ``model``: the wide frozen RanPAC projections are column-sharded and
  the classifier row-sharded (:data:`DEFAULT_TP_RULES`,
  :func:`shard_params`), with Megatron's pair of collectives: a
  column-sharded layer's input passes forward unchanged and its gradient
  is summed over the axis (:func:`copy_to_model`); a row-sharded layer's
  partial outputs are summed forward (:func:`reduce_from_model`), its
  bias added once after the sum.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from grl_torch.parallel import distributed

Spec = Tuple[Optional[str], ...]


class Mesh:
    """Axis names and sizes (``shape``, in order), this rank's coordinate
    on each axis (``coords``), and for each axis the process group of this
    rank's line and its members' global ranks in axis order."""

    def __init__(self, shape: Dict[str, int], rank: int, timeout=None):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        sizes = [self.shape[a] for a in self.axis_names]
        grid = np.arange(int(np.prod(sizes))).reshape(sizes)
        self.rank = rank
        self.coords = dict(zip(self.axis_names, (int(c) for c in np.argwhere(grid == rank)[0])))
        self.groups: Dict[str, Any] = {}
        self.ranks: Dict[str, List[int]] = {}
        # Every rank makes every group, in the same order (dist.new_group
        # is collective over the world).
        for axis_i, axis in enumerate(self.axis_names):
            lines = np.moveaxis(grid, axis_i, -1).reshape(-1, sizes[axis_i])
            for line in lines:
                members = [int(r) for r in line]
                group = dist.new_group(members, timeout=timeout) if len(members) > 1 else None
                if rank in members:
                    self.groups[axis], self.ranks[axis] = group, members

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    def axis_size(self, axis: str) -> int:
        return int(self.shape.get(axis, 1))

    def index(self, axis: str) -> int:
        return int(self.coords.get(axis, 0))

    def group(self, axis: str):
        return self.groups.get(axis)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank} at {self.coords})"


def mesh_sizes(axis_shape: Dict[str, int], world: int) -> Dict[str, int]:
    """``axis_shape`` with a -1 size absorbing the rest of the world."""
    shape = {k: int(v) for k, v in axis_shape.items()}
    if -1 in shape.values():
        known = int(np.prod([s for s in shape.values() if s != -1]))
        axis = next(k for k, v in shape.items() if v == -1)
        shape[axis] = max(1, world // known)
    return shape


def make_mesh(axis_shape: Optional[Dict[str, int]] = None, timeout=None) -> Mesh:
    """The mesh over the live world; default one ``data`` axis over all of
    it. ``axis_shape`` maps axis name -> size, e.g. ``{"data": 2, "model":
    2}``; a -1 size absorbs the rest. A mesh of one device needs no world;
    a mesh over more devices than the world's processes raises, naming the
    launch contract."""
    world = distributed.world_size()
    shape = mesh_sizes(dict(axis_shape or {"data": world}), world)
    total = int(np.prod(list(shape.values())))
    if total > 1 and total != world:
        raise ValueError(
            f"parallel.mesh {shape} spans {total} devices and the world has {world} process(es): the port "
            f"runs one process per device; launch {total} with {distributed.ENV_COORDINATOR}, "
            f"{distributed.ENV_NUM_PROCESSES}={total} and {distributed.ENV_PROCESS_ID}=0..{total - 1} "
            "(README, 'Several processes')."
        )
    return Mesh(shape, distributed.rank(), timeout=timeout)


def fold_seed(seed: int, index: int) -> int:
    """A seed for stream ``index`` of ``seed`` (``jax.random.fold_in``'s
    role): each rank's generators draw masks of their own."""
    return int(np.random.SeedSequence([int(seed), int(index)]).generate_state(1, np.uint64)[0] >> 1)


def replicate(module: torch.nn.Module, mesh: Optional[Mesh] = None) -> torch.nn.Module:
    """Every parameter and buffer of ``module`` broadcast from the world's
    first rank, in place: the replicas start equal bit for bit."""
    if distributed.world_size() > 1:
        for tensor in list(module.parameters()) + list(module.buffers()):
            distributed.broadcast_(tensor.data, 0)
    return module


def shard_batch(tree: Any, mesh: Mesh, axis: str = "data") -> Any:
    """This rank's rows of the leading (batch) dimension of every leaf (a
    dict, list or tuple of arrays or tensors): the global batch split
    evenly over ``axis``, in axis order."""
    size, index = mesh.axis_size(axis), mesh.index(axis)

    def take(leaf):
        rows = leaf.shape[0] // size
        return leaf[index * rows:(index + 1) * rows]

    if isinstance(tree, dict):
        return {k: take(v) for k, v in tree.items()}
    return type(tree)(take(v) for v in tree)


# Default tensor-parallel rules for the GCN family, in the port's names and
# layouts (grl_tpu/parallel/mesh.py:67-73 in flax's): shard the wide frozen
# RanPAC expansions by column and the classifier by row over the model
# axis. A torch Dense keeps ``weight (out, in)``, so flax's row-sharded
# ``kernel (in, out)`` is a weight sharded on its dim 1.
DEFAULT_TP_RULES: Tuple[Tuple[str, Spec], ...] = (
    (r".*w_rand.*kernel", (None, "model")),
    (r".*rp_emb.*kernel", (None, "model")),
    (r".*rp_final.*kernel", (None, "model")),
    (r".*classifier.*weight", (None, "model")),
    (r".*classifier.*bias", (None,)),
)


def placement(shapes: Dict[str, Tuple[int, ...]], model_size: int,
              rules: Sequence[Tuple[str, Spec]] = DEFAULT_TP_RULES) -> Dict[str, Spec]:
    """Each leaf's spec by the first rule whose pattern matches its
    lowercased name: the rule's spec where every sharded dimension exists
    and divides by ``model_size``, else replicated (``()``), as
    ``grl_tpu``'s ``shard_params`` falls back (:76-107)."""
    out: Dict[str, Spec] = {}
    for name, shape in shapes.items():
        spec: Spec = ()
        for pattern, rule in rules:
            if re.fullmatch(pattern, name.lower()):
                ok = len(rule) <= len(shape) and all(
                    axis is None or shape[dim] % model_size == 0 for dim, axis in enumerate(rule))
                spec = rule if ok else ()
                break
        out[name] = spec
    return out


def _sharded_dim(spec: Spec) -> Optional[int]:
    return next((dim for dim, axis in enumerate(spec) if axis == "model"), None)


def module_placement(module: torch.nn.Module, model_size: int,
                     rules: Sequence[Tuple[str, Spec]] = DEFAULT_TP_RULES) -> Dict[str, Tuple[Spec, Optional[str]]]:
    """Each leaf of ``module`` (parameters and buffers) -> ``(spec, kind)``:
    :func:`placement`'s spec where the owning layer carries the
    collectives, a RanPAC ``kernel`` by column (kind ``"column"``) or a
    Dense ``weight`` by row (``"row"``); any other leaf stays whole
    (``((), None)``)."""
    from grl_torch.models.layers import Dense, RanPAC

    leaves = dict(module.named_parameters())
    leaves.update(dict(module.named_buffers()))
    table = placement({name: tuple(t.shape) for name, t in leaves.items()}, model_size, rules)
    owners = dict(module.named_modules())
    out: Dict[str, Tuple[Spec, Optional[str]]] = {}
    for name, spec in table.items():
        dim = _sharded_dim(spec)
        owner_name, _, leaf = name.rpartition(".")
        owner = owners[owner_name]
        kind = ("column" if isinstance(owner, RanPAC) and leaf == "kernel" and dim == 1 else
                "row" if isinstance(owner, Dense) and leaf == "weight" and dim == 1 else None)
        out[name] = (spec, kind) if kind is not None or dim is None else ((), None)
    return out


def shard_params(module: torch.nn.Module, mesh: Mesh,
                 rules: Sequence[Tuple[str, Spec]] = DEFAULT_TP_RULES) -> Dict[str, Spec]:
    """Slice ``module``'s leaves by ``rules`` over the ``model`` axis, in
    place (:func:`module_placement`), and switch the owning layers to their
    tensor-parallel forward; returns the placement table. A RanPAC's
    sharded output is gathered unless the model lists the layer in
    ``TP_SHARDED_OUTPUTS`` (its consumer is the row-sharded classifier); a
    Dropout layer listed there sees one rank's columns and draws from its
    own stream (``Dropout.stream``)."""
    from grl_torch.models.layers import Dropout

    size, index, group = mesh.axis_size("model"), mesh.index("model"), mesh.group("model")
    plan = module_placement(module, size, rules)
    if size <= 1:
        return {name: () for name in plan}
    leaves = dict(module.named_parameters())
    leaves.update(dict(module.named_buffers()))
    owners = dict(module.named_modules())
    keep_sharded = set(getattr(module, "TP_SHARDED_OUTPUTS", ()))
    for name, (spec, kind) in plan.items():
        if kind is None:
            continue
        dim = _sharded_dim(spec)
        owner_name = name.rpartition(".")[0]
        tensor = leaves[name]
        part = tensor.shape[dim] // size
        tensor.data = tensor.data.narrow(dim, index * part, part).clone()
        owners[owner_name].tensor_parallel = TensorParallel(
            kind, group, size, index, gather=kind == "column" and owner_name not in keep_sharded)
    for name in keep_sharded:
        if isinstance(owners.get(name), Dropout):
            owners[name].stream = index
    return {name: spec for name, (spec, _) in plan.items()}


class TensorParallel:
    """A layer's share of the model axis: ``kind`` "column" (RanPAC: its
    output columns; ``gather`` all-gathers them) or "row" (Dense: its input
    rows; partial outputs are summed), the axis group, its size and this
    rank's index."""

    def __init__(self, kind: str, group, size: int, index: int, gather: bool = False):
        self.kind, self.group, self.size, self.index, self.gather = kind, group, size, index, gather


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model axis."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return distributed.all_reduce_(grad.contiguous(), ctx.group, "tp_all_reduce"), None


class _ReduceFromModel(torch.autograd.Function):
    """Partial outputs summed over the model axis; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return distributed.all_reduce_(x.contiguous().clone(), group, "tp_all_reduce")

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    """Column shards all-gathered on the last dimension; the backward keeps
    this rank's columns of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, group, index):
        ctx.index, ctx.width = index, x.shape[-1]
        return distributed.all_gather(x, group, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(-1, ctx.index * ctx.width, ctx.width), None, None


class _ScatterToModel(torch.autograd.Function):
    """This rank's columns of a replicated input; the backward all-gathers
    the gradient's columns."""

    @staticmethod
    def forward(ctx, x, group, size, index):
        ctx.group = group
        width = x.shape[-1] // size
        return x.narrow(-1, index * width, width).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return distributed.all_gather(grad, ctx.group, dim=-1), None, None, None


def copy_to_model(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    return _CopyToModel.apply(x, tp.group)


def reduce_from_model(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    return _ReduceFromModel.apply(x, tp.group)


def gather_from_model(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    return _GatherFromModel.apply(x, tp.group, tp.index)


def scatter_to_model(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    return _ScatterToModel.apply(x, tp.group, tp.size, tp.index)


def sharded_parameters(module: torch.nn.Module) -> List[torch.nn.Parameter]:
    """The parameters of ``module`` that :func:`shard_params` sliced (a
    row-sharded Dense's weight; RanPAC kernels are frozen buffers)."""
    out = []
    for layer in module.modules():
        tp = getattr(layer, "tensor_parallel", None)
        if tp is not None and tp.kind == "row":
            out.append(layer.weight)
    return out


def sharded_state_dims(module: torch.nn.Module) -> Dict[str, int]:
    """State-dict names of the sharded leaves and the dimension they are
    sharded on (1 for both kinds)."""
    out = {}
    for name, layer in module.named_modules():
        tp = getattr(layer, "tensor_parallel", None)
        if tp is not None:
            out[f"{name}.{'kernel' if tp.kind == 'column' else 'weight'}"] = 1
    return out
