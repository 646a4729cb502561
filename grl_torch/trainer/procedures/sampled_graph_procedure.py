"""Neighbor-sampled minibatch training on one large graph (BASELINE
config 4: a graph whose full adjacency does not fit one device).

Counterpart of ``grl_tpu/trainer/procedures/sampled_graph_procedure.py``
(:33-429) on one device. Minibatches come from
:class:`grl_torch.data.neighbor_sampler.NeighborSampler` as static-shape
sampling trees, drawn on the host by a background thread
(:func:`grl_torch.data.dataloader.prefetch_iter`, ``sampler.prefetch``
batches ahead, by default ``max(2, scan_steps)``) from
``RandomState(config.seed)``: the whole training epoch, then the
validation batches, as in ``grl_tpu``. ``groups`` trees stack on a
leading axis. The features stay on the device as float32; a step ships
the trees' node ids, weights and relations and gathers the rows on the
device, padding slots (-1) exact zeros.

``sampler.tree_aggregation`` (default true) runs ``GraphConv`` on the
tree's implied edges (:class:`grl_torch.ops.tree.TreeGraph`: a reshape and
an einsum a level); false takes the COO route (``batch_relational_coo``).
With ``sampler.head_slice`` (default true) and a model whose ``forward``
takes ``head_rows``, only the level-0 target rows go through the RanPAC
head and the classifier, the labels sliced to match. A train step is
forward → ``cross_entropy`` (-100 ignored) → backward → global-norm clip
→ optimizer.

``scan_steps = K`` runs K host batches as one chunk: every sampled batch
has the same shapes, so one key serves a whole run. The K batches stack in
numpy into page-locked memory and cross with one copy per array into the
chunk's static tensors; on the card the chunk is one replay of a CUDA graph
(:mod:`grl_torch.trainer.captured`; the first chunk runs eagerly, as the
warm-up) and on the CPU K eager steps. The loss is read once per chunk;
the batches left over at the end of an epoch run step by step. Validation
runs eagerly on the same static shapes and gives ``correct / total`` over
the level-0 labels.

Under ``parallel.mesh`` (``sampled_graph_procedure.py:47-50, 322-356``)
``groups`` becomes ``max(groups, data)``: every rank samples the same
global step from the same seed and keeps its share of the groups (the
group axis padded to a multiple of ``data`` with empty trees), the step
sums the gradients over ``data``, and validation sums the correct and
labelled targets over the world.
"""
from __future__ import annotations

import inspect
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from grl_torch.config import ConfigDict
from grl_torch.data.dataloader import prefetch_iter
from grl_torch.data.large_graph import LargeGraphData
from grl_torch.data.neighbor_sampler import NeighborSampler, SampledBatch
from grl_torch.ops.sparse import batch_relational_coo
from grl_torch.ops.tree import TreeGraph
from grl_torch.trainer.losses import cross_entropy
from grl_torch.parallel import distributed
from grl_torch.trainer.procedures.base_procedure import BaseProcedure
from grl_torch.trainer.procedures.full_graph_procedure import large_graph_from_config

# A batch's arrays on each route, with their device dtypes.
TREE_ARRAYS = {"nodes": torch.int32, "labels": torch.int64, "relations": torch.int32, "weights": torch.float32}
COO_ARRAYS = {**TREE_ARRAYS, "senders": torch.int32, "receivers": torch.int32, "mask": torch.bool}


class SampledGraphProcedure(BaseProcedure):
    """Train ``model`` (sparse mode) on neighbor-sampled minibatches;
    returns the best validation accuracy. ``losses`` holds each train
    step's loss (a float, read once per chunk)."""

    def __init__(self, model: torch.nn.Module, config: ConfigDict,
                 data: Optional[LargeGraphData] = None, **kwargs: Any):
        super().__init__(model, config, **kwargs)
        self.data = data if data is not None else large_graph_from_config(self.config)
        cfg = dict(self.config.get("sampler", {}) or {})
        groups = int(cfg.get("groups", 0))
        if self.mesh is not None:
            groups = max(groups, self.mesh.axis_size("data"))
        self.sampler = NeighborSampler(
            self.data,
            fanouts=tuple(cfg.get("fanouts", (10, 10))),
            batch_size=int(cfg.get("batch_size", 256)),
            groups=max(1, groups),
            # The rows are gathered on the device from the resident
            # features: a step ships node ids, not rows.
            with_features=False,
        )
        self.features = torch.from_numpy(np.asarray(self.data.features, np.float32)).to(self.device)
        self._scan_k = max(1, int(self.config.get("scan_steps", 1)))
        # The default depth covers one chunk: while a chunk runs, the
        # producer can sample the whole next one.
        self._prefetch = int(cfg.get("prefetch", max(2, self._scan_k)))
        self._use_tree = bool(cfg.get("tree_aggregation", True))
        self._arrays = TREE_ARRAYS if self._use_tree else COO_ARRAYS
        self._head_slice = bool(cfg.get("head_slice", True)) and (
            "head_rows" in inspect.signature(type(model).forward).parameters
        )
        self._np_rng = np.random.RandomState(self.seed)
        # Each chunk size's static device tensors and page-locked staging,
        # and the event after which the staging may be written again.
        self._slots: Dict[int, Dict[str, Any]] = {}
        self.losses: List[float] = []

    # ------------------------------------------------------------------
    def _ensure_initialized(self) -> None:
        if self.state is None:
            self.init_state()
            self.logger.info(
                f"tree nodes/group={self.sampler.num_nodes:,} edges/group={self.sampler.num_edges:,} "
                f"groups={self.sampler.groups} route={'tree' if self._use_tree else 'coo'} "
                f"head_slice={self._head_slice}"
            )

    def host_arrays(self, batch: SampledBatch) -> Dict[str, np.ndarray]:
        """The arrays of ``batch`` a step reads, ``(G, ...)`` each, in
        their device dtypes; under a mesh this rank's groups."""
        numpy_dtype = {torch.int32: np.int32, torch.int64: np.int64, torch.float32: np.float32, torch.bool: bool}
        arrays = {name: np.asarray(getattr(batch, name), numpy_dtype[dtype]) for name, dtype in self._arrays.items()}
        # Padding groups are empty trees: no node, no label, no edge weight.
        return self.place_batch(arrays, pad_values={"nodes": -1, "labels": -100})

    def device_arrays(self, batch: SampledBatch) -> Dict[str, torch.Tensor]:
        """``batch``'s arrays on the device, a copy each."""
        return {name: torch.from_numpy(a).to(self.device) for name, a in self.host_arrays(batch).items()}

    def graph(self, t: Dict[str, torch.Tensor]):
        """The step's adjacency from its device arrays: a
        :class:`TreeGraph`, or the flat COO graph of the G trees."""
        if self._use_tree:
            return TreeGraph(weights=t["weights"], relations=t["relations"],
                             level_sizes=tuple(self.sampler.level_sizes), fanouts=self.sampler.fanouts,
                             num_relations=self.data.num_relations)
        return batch_relational_coo(t["senders"], t["receivers"], t["relations"], t["weights"], t["mask"],
                                    nodes_per_sample=self.sampler.num_nodes,
                                    num_relations=self.data.num_relations)

    def _materialize(self, nodes: torch.Tensor) -> torch.Tensor:
        """The feature rows of the tree slots, gathered from the resident
        table; padding slots (-1) are exact zeros (``:136-141``)."""
        nodes = nodes.reshape(-1)
        V = self.features.index_select(0, nodes.clamp(min=0))
        return V * (nodes >= 0).to(V.dtype)[:, None]

    def _head(self, labels: torch.Tensor) -> Tuple[Dict[str, Any], torch.Tensor]:
        """The model's ``head_rows`` argument and the labels it scores."""
        if not self._head_slice:
            return {}, labels
        keep = self.sampler.batch_size
        return {"head_rows": (labels.shape[0], self.sampler.num_nodes, keep)}, labels[:, :keep]

    def _logits(self, t: Dict[str, torch.Tensor], **kwargs: Any) -> Tuple[torch.Tensor, torch.Tensor]:
        head, labels = self._head(t["labels"])
        logits = self.model((self._materialize(t["nodes"]), self.graph(t)), **head, **kwargs)
        return logits.reshape(*labels.shape, -1), labels

    def _step_body(self, t: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One step's device work on its device arrays, with no host read
        and no host-side count: a CUDA graph can capture it."""
        optimizer = self.state.optimizer
        self.model.train()
        optimizer.zero_grad(set_to_none=True)
        logits, labels = self._logits(t, rngs=self.rngs)
        loss = cross_entropy(logits, labels)
        return self.update([(loss, cross_entropy, labels)], [p for g in optimizer.param_groups for p in g["params"]])[0]

    def train_step(self, batch: SampledBatch) -> torch.Tensor:
        """One optimizer step on ``batch``; the loss stays on the device."""
        self._ensure_initialized()
        loss = self._step_body(self.device_arrays(batch))
        self.state.step += 1
        return loss

    def eval_step(self, batch: SampledBatch) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(correct, total)`` over ``batch``'s labeled level-0 slots, as
        device scalars."""
        self._ensure_initialized()
        self.model.eval()
        with torch.no_grad():
            logits, labels = self._logits(self.device_arrays(batch))
        mask = labels != -100
        counts = torch.stack([((logits.argmax(dim=-1) == labels) & mask).sum(), mask.sum()])
        if self.mesh is not None and self.mesh.axis_size("data") > 1:
            # The world's counts, the same on every rank.
            counts = distributed.all_reduce_(counts.float(), self.mesh.group("data"), "eval all_reduce").long()
        return counts[0], counts[1].clamp(min=1)

    # ------------------------------------------------------------------
    def load_chunk(self, batches: List[SampledBatch]) -> Callable[[], torch.Tensor]:
        """K host batches stacked into page-locked memory and copied, one
        copy per array, into the static tensors of a chunk of K; returns
        the chunk's body: the K steps in order, giving their losses."""
        self._ensure_initialized()
        K = len(batches)
        per_batch = [self.host_arrays(b) for b in batches]
        slots = self._slots.get(K)
        if slots is None:
            pin = self.device.type == "cuda"
            staged = {name: torch.empty((K, *a.shape), dtype=self._arrays[name], pin_memory=pin)
                      for name, a in per_batch[0].items()}
            slots = self._slots[K] = {
                "staged": staged,
                "static": {name: torch.empty(s.shape, dtype=s.dtype, device=self.device) for name, s in staged.items()},
                "copied": torch.cuda.Event() if pin else None,
            }
        if slots["copied"] is not None:
            # The last chunk's copies out of the staging must be done.
            slots["copied"].synchronize()
        for name, staged in slots["staged"].items():
            np.stack([arrays[name] for arrays in per_batch], out=staged.numpy())
            slots["static"][name].copy_(staged, non_blocking=True)
        if slots["copied"] is not None:
            slots["copied"].record()
        static = slots["static"]

        def chunk() -> torch.Tensor:
            return torch.stack([self._step_body({name: t[k] for name, t in static.items()}) for k in range(K)])

        return chunk

    def run_chunk(self, batches: List[SampledBatch]) -> torch.Tensor:
        """K host batches as one chunk of K steps (:meth:`load_chunk`): one
        graph replay on the card, K eager steps on the CPU. Returns the K
        losses on the device (after a replay, the graph's own output:
        read it before the next chunk)."""
        # load_chunk first: it may make the train state, which starts a new
        # runner.
        body = self.load_chunk(batches)
        losses = self.chunk_runner().run(len(batches), body)
        self.state.step += len(batches)
        return losses

    # ------------------------------------------------------------------
    def _batches(self, mask: np.ndarray) -> Iterator[SampledBatch]:
        """The sampler's batches over ``mask``'s nodes, ``prefetch`` ahead
        on a background thread (0: in the caller's thread)."""
        it = self.sampler.epoch_batches(self._np_rng, mask)
        return prefetch_iter(it, self._prefetch) if self._prefetch > 0 else it

    def _eval_accuracy(self) -> float:
        """``correct / total`` over the validation nodes (``:370-379``)."""
        correct = total = 0
        for batch in self._batches(self.data.val_mask):
            c, t = self.eval_step(batch)
            correct += int(c)
            total += int(t)
        return correct / max(total, 1)

    def __call__(self) -> float:
        self._ensure_initialized()
        num_epochs = int(self.config.get("num_epochs", 10))
        best_acc = 0.0
        start = time.time()
        steps = 0
        K = self._scan_k
        for epoch in range(num_epochs):
            losses: List[float] = []
            buffer: List[SampledBatch] = []
            for batch in self._batches(self.data.train_mask):
                steps += 1
                if K == 1:
                    losses.append(float(self.train_step(batch)))
                    continue
                buffer.append(batch)
                if len(buffer) == K:
                    losses.extend(self.run_chunk(buffer).tolist())
                    buffer = []
            # The leftover batches (fewer than K) run step by step.
            losses.extend(float(self.train_step(batch)) for batch in buffer)
            self.losses.extend(losses)
            acc = self._eval_accuracy()
            best_acc = max(best_acc, acc)
            self.tb_writer.add_scalar("val_accuracy", acc, epoch)
            self.logger.info(f"epoch {epoch}: loss={np.mean(losses):.4f} val_acc={acc:.4f}")
        elapsed = time.time() - start
        nodes = steps * self.sampler.groups * self.sampler.batch_size
        self.logger.info(
            f"sampled training: {nodes / max(elapsed, 1e-9):,.0f} target nodes/s ({steps} steps, {elapsed:.1f}s)"
        )
        self.tb_writer.close()
        return best_acc

