"""Full-batch node classification on one large sparse graph (OGB-style).

Counterpart of ``grl_tpu/trainer/procedures/full_graph_procedure.py`` on
one device: a single static COO graph, flat node features, masked
full-batch cross-entropy. At construction the graph is planned once
(:func:`grl_torch.ops.kernels.attach_kernel`): the model's ``kernel_impl``
picks the aggregation kernel (``ell``/``pallas``: K6, ``pallas_csr``: K5)
with the config's ``kernel_plan``, and a model with ``use_attention`` and
``attention_impl: sparse`` gets the fused attention (K4). Where the kernel
reordered the nodes (``node_perm``), features and labels are placed in its
order once. A train step is forward → ``cross_entropy`` with -100 masking →
backward → global-norm clip → Adam, all enqueued without a host sync; an
eval step is the masked accuracy on the validation nodes.

``scan_steps = K`` runs the steps in chunks of ``k_eff = min(K,
remaining)``, with ``grl_tpu``'s step count and eval schedule (eval after
the first chunk, at every crossing of a multiple of 10 steps, and at the
end). ``grl_tpu`` fuses a chunk into one ``lax.scan`` dispatch, compiled
once per ``k_eff`` (``_scan_fn``); here, with K > 1, a chunk is one replay
of a CUDA graph captured once per ``k_eff`` on the card (the first chunk
of a ``k_eff`` runs eagerly, as the warm-up; :mod:`grl_torch.trainer.captured`)
and ``k_eff`` eager steps on the CPU. ``scan_steps: 1`` runs each step
eagerly.

Under ``parallel.mesh`` (``full_graph_procedure.py:76-110, 286-356``) the
graph is node-partitioned over ``data``: the plan
(:func:`grl_torch.parallel.graph_partition.partition_graph`, degree-balanced
with ``parallel.balance_partition``, features and labels then placed
through its ``node_perm``) is made once, each rank keeps its block of
features and labels, and every ``GraphConv`` of the model aggregates by the
ring halo exchange
(:func:`grl_torch.parallel.sharded_flagship.make_partitioned_model_step`).
The partitioned path ignores ``kernel_impl`` as ``grl_tpu``'s does: no
kernel is planned, the ring aggregates (D is its only kernel). Chunks of
``scan_steps`` are captured on NCCL and run step by step on gloo; the
validation accuracy sums the correct and labelled nodes over the world.
"""
from __future__ import annotations

import time
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from grl_torch.config import ConfigDict
from grl_torch.data.large_graph import LargeGraphData, sbm_relational_graph, to_relational_graph
from grl_torch.ops.kernels import attach_kernel
from grl_torch.parallel import distributed
from grl_torch.parallel.graph_partition import partition_graph
from grl_torch.parallel.sharded_flagship import make_partitioned_model_step, pad_node_arrays, scatter_node_arrays
from grl_torch.trainer import optimizers as optim_module
from grl_torch.trainer.losses import cross_entropy
from grl_torch.trainer.procedures.base_procedure import BaseProcedure
from grl_torch.utils.profiling import span


def large_graph_from_config(config: ConfigDict) -> LargeGraphData:
    """The full-batch graph of ``config.data_config.large_graph``:
    ``{type: sbm, args: {...}}`` (synthetic SBM) or ``{type: npz, path: ...}``
    (arrays named like the LargeGraphData fields)."""
    spec = config.get_path("data_config.large_graph")
    if not spec:
        raise ValueError(
            "FullGraphProcedure needs either a `data=` argument or a "
            "config.data_config.large_graph block ({type: sbm|npz, ...})."
        )
    kind = spec.get("type", "sbm")
    if kind == "sbm":
        return sbm_relational_graph(**dict(spec.get("args", {}) or {}))
    if kind == "npz":
        loaded = np.load(spec["path"])
        return LargeGraphData(
            features=loaded["features"].astype(np.float32),
            labels=loaded["labels"].astype(np.int32),
            senders=loaded["senders"].astype(np.int32),
            receivers=loaded["receivers"].astype(np.int32),
            relations=loaded["relations"].astype(np.int32),
            weights=loaded["weights"].astype(np.float32),
            train_mask=loaded["train_mask"].astype(bool),
            val_mask=loaded["val_mask"].astype(bool),
            num_classes=int(loaded["num_classes"]),
            num_relations=int(loaded["num_relations"]),
        )
    raise ValueError(f"Unknown large_graph type: {kind}")


class FullGraphProcedure(BaseProcedure):
    """Train ``model`` on one LargeGraphData graph; returns the best
    validation accuracy. ``losses`` holds each train step's loss as a
    device scalar, read only by the caller."""

    def __init__(self, model: torch.nn.Module, config: ConfigDict,
                 data: Optional[LargeGraphData] = None, **kwargs: Any):
        super().__init__(model, config, **kwargs)
        self.data = data if data is not None else large_graph_from_config(self.config)
        self._scan_k = max(1, int(self.config.get("scan_steps", 1)))
        self.losses: List[torch.Tensor] = []
        self._partitioned = self.mesh is not None
        if self._partitioned:
            self._init_partitioned()
            return
        data = self.data
        labels = np.asarray(data.labels, np.int64)
        graph, features = to_relational_graph(data, device=self.device)
        impl = getattr(model, "kernel_impl", "xla")
        # The attention kernel is planned whenever the model runs sparse
        # attention, whatever the aggregation kernel (kernels.py:68-71).
        plan_atten = bool(
            getattr(model, "use_attention", False)
            and getattr(model, "attention_impl", "") == "sparse"
        )
        if impl != "xla" or plan_atten:
            graph = attach_kernel(
                graph, impl=impl,
                feature_dim=2 * int(getattr(model, "net_size", 256)),
                attention=plan_atten,
                **dict(self.config.get("kernel_plan", {}) or {}),
            )
        self.graph = graph
        features = np.asarray(features, np.float32)
        train_labels = np.where(data.train_mask, labels, -100)
        val_labels = np.where(data.val_mask, labels, -100)
        node_perm = getattr(getattr(graph, "kernel", None), "node_perm", None)
        if node_perm is not None:
            # The kernel reordered the node space at plan time (ELL's
            # reorder: degree): place features and labels there once
            # (full_graph_procedure.py:159-178); the masked accuracy is the
            # same over the permuted label multiset.
            features, train_labels = scatter_node_arrays(node_perm, features, train_labels, len(features))
            _, val_labels = scatter_node_arrays(node_perm, None, val_labels, len(features))
        self.features = torch.from_numpy(features).to(self.device)
        self.train_labels = torch.from_numpy(train_labels).to(self.device)
        self.val_labels = torch.from_numpy(val_labels).to(self.device)

    def _init_partitioned(self) -> None:
        """The node-partitioned plan, once, and this rank's block of
        features and labels (``full_graph_procedure.py:76-110``)."""
        data = self.data
        labels = np.asarray(data.labels, np.int64)
        train_labels = np.where(data.train_mask, labels, -100)
        val_labels = np.where(data.val_mask, labels, -100)
        D, d = self.mesh.axis_size("data"), self.mesh.index("data")
        self.part = partition_graph(
            np.asarray(data.senders), np.asarray(data.receivers), np.asarray(data.relations),
            np.asarray(data.weights), num_nodes=len(data.features), num_relations=data.num_relations,
            num_shards=D, balance=bool(self.config.get_path("parallel.balance_partition", False)),
        )
        features = np.asarray(data.features, np.float32)
        if self.part.node_perm is not None:
            features, train_labels = scatter_node_arrays(self.part.node_perm, features, train_labels,
                                                         self.part.num_nodes)
            _, val_labels = scatter_node_arrays(self.part.node_perm, None, val_labels, self.part.num_nodes)
        else:
            features, train_labels = pad_node_arrays(features, train_labels, self.part.num_nodes)
            _, val_labels = pad_node_arrays(None, val_labels, self.part.num_nodes)
        shard_n = self.part.num_nodes // D
        rows = slice(d * shard_n, (d + 1) * shard_n)
        self.graph = None
        self.features = torch.from_numpy(np.ascontiguousarray(features[rows])).to(self.device)
        self.train_labels = torch.from_numpy(np.ascontiguousarray(train_labels[rows])).to(self.device)
        self.val_labels = torch.from_numpy(np.ascontiguousarray(val_labels[rows])).to(self.device)
        self._partitioned_step = self._partitioned_forward = None

    def num_edges(self) -> int:
        return int(self.part.mask.sum()) if self._partitioned else self.graph.num_edges()

    def _ensure_initialized(self) -> None:
        if self.state is None:
            self.init_state()
            if self._partitioned:
                self._partitioned_step, self._partitioned_forward = make_partitioned_model_step(
                    self.model, self.mesh, self.part, self.state.optimizer, max_grad_norm=self.max_grad_norm,
                    device=self.device, sharded=self.sharded, model_group=self.model_group)
                Ec = self.part.senders.shape[-1]
                self.logger.info(
                    f"partitioned over {self.mesh.axis_size('data')} ranks: nodes={self.part.num_nodes:,} "
                    f"edges={self.num_edges():,} Ec={Ec:,} padding share="
                    f"{1 - self.num_edges() / self.part.mask.size:.3f}"
                )
            else:
                self.logger.info(f"nodes={self.graph.num_nodes:,} edges={self.graph.num_edges():,}")

    def train_step(self) -> torch.Tensor:
        """One full-graph optimizer step; the loss stays on the device."""
        loss = self._step_body()
        self.state.step += 1
        return loss

    def chunk_body(self, k: int) -> Callable[[], torch.Tensor]:
        """The device work of ``k`` optimizer steps, giving their losses."""
        return lambda: torch.stack([self._step_body() for _ in range(k)])

    def train_steps(self, k: int) -> List[torch.Tensor]:
        """``k`` optimizer steps as one chunk: one replay of the graph of
        ``k`` steps on the card (captured at the second chunk of ``k``
        steps), ``k`` eager steps on the CPU. Each step's loss as a device
        scalar of its own."""
        losses = self.chunk_runner().run(k, self.chunk_body(k)).clone()
        self.state.step += k
        return list(losses.unbind())

    def _step_body(self) -> torch.Tensor:
        """One step's device work, with no host read and no host-side
        count: a CUDA graph can capture it."""
        if self._partitioned:
            return self._partitioned_step(self.features, self.train_labels, self.rngs)
        model, optimizer = self.model, self.state.optimizer
        model.train()
        optimizer.zero_grad(set_to_none=True)
        logits = model((self.features, self.graph), rngs=self.rngs)
        loss = cross_entropy(logits, self.train_labels)
        loss.backward()
        if self.max_grad_norm:
            params = [p for group in optimizer.param_groups for p in group["params"]]
            optim_module.clip_by_global_norm_(params, float(self.max_grad_norm))
        optimizer.step()
        return loss.detach()

    def eval_step(self, labels: torch.Tensor) -> torch.Tensor:
        """Masked accuracy of the eval-mode forward on ``labels`` (-100
        marks the nodes left out), as a device scalar; its enqueue is the
        span ``grl.eval``."""
        with span("grl.eval"):
            if self._partitioned:
                logits = self._partitioned_forward(self.features)
            else:
                self.model.eval()
                with torch.no_grad():
                    logits = self.model((self.features, self.graph))
            mask = labels != -100
            correct = ((logits.argmax(dim=-1) == labels) & mask).sum()
            if self._partitioned:
                # Correct and labelled nodes summed over the world.
                counts = distributed.all_reduce_(torch.stack([correct, mask.sum()]).float(),
                                                 self.mesh.group("data"), "eval all_reduce")
                return counts[0] / counts[1].clamp(min=1)
            return correct / mask.sum().clamp(min=1)

    def __call__(self) -> float:
        self._ensure_initialized()
        num_epochs = int(self.config.get("num_epochs", 100))
        best_acc = 0.0
        edges = self.num_edges()
        start = time.time()
        K = self._scan_k
        total = 0
        for first in range(0, num_epochs, K):
            k_eff = min(K, num_epochs - first)
            losses = [self.train_step()] if K == 1 else self.train_steps(k_eff)
            self.losses.extend(losses)
            loss = losses[-1]
            epoch = first + k_eff - 1
            total = epoch + 1
            # Eval after the first chunk, at every crossing of a multiple
            # of 10 steps, and at the end (full_graph_procedure.py:378-396).
            if first == 0 or first // 10 != (first + k_eff) // 10 or first + k_eff >= num_epochs:
                acc = float(self.eval_step(self.val_labels))
                best_acc = max(best_acc, acc)
                self.tb_writer.add_scalar("val_accuracy", acc, epoch)
                self.logger.info(f"epoch {epoch}: loss={float(loss):.4f} val_acc={acc:.4f}")
        elapsed = time.time() - start
        edges_per_sec = edges * total / max(elapsed, 1e-9)
        self.logger.info(
            f"full-graph training: {edges_per_sec:,.0f} edges/s ({total} epochs, {elapsed:.1f}s)"
        )
        self.tb_writer.close()
        return best_acc
