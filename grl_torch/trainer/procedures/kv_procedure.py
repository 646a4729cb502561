"""KV node-classification training procedure — the main epoch loop.

Counterpart of ``grl_tpu/trainer/procedures/kv_procedure.py`` (:35-482),
stepwise:

* one train step per batch (forward + backward + clip + update +
  confusion counts on the device); the host reads the loss and the
  ``C x C`` matrix once per step, as ``grl_tpu`` does, and derives macro
  P/R/F1 from it. Where chunks are captured (the card, not a gloo world)
  the single step (``_train_fn``) replays a one-step CUDA graph of its
  batch shape (:meth:`KVProcedure._replayed_step`), recorded in set-up's
  first step of a shape where the train loader pads to buckets, else at
  the shape's second step; elsewhere it runs eagerly;
* ``scan_steps = K > 1`` is ``grl_tpu``'s ``_train_epoch_scanned``
  (:meth:`KVProcedure._train_epoch_scanned`; this class's own step only,
  :meth:`KVProcedure._use_scan`): batches wait in buffers by
  shape until K of one shape are ready, then run as one chunk, which on
  the card is one replay of a CUDA graph captured once for that shape
  (:mod:`grl_torch.trainer.captured`; the first chunk of a shape runs
  eagerly, as the warm-up), and on the CPU K eager steps; the leftovers
  of an epoch run step by step, each through the single step (so on the
  card replayed from its shape's one-step graph);
* the per-step cosine RanPAC lambda is passed to the model as a device
  scalar, filled in place (a chunk holds one a step);
* a batch from ``SparseBucketPadding`` (``coo_*`` keys) reaches the model
  as flat features ``(B*N, F)`` and one batched
  :class:`~grl_torch.ops.sparse.RelationalGraph` with ``batch_shape (B, N)``
  (``kv_procedure.py:108-129``); its chunks are keyed by the edge bucket
  too;
* validation sums the confusion matrices of the epoch for the epoch
  report;
* checkpoints hold model, optimizer and step (BatchNorm's running
  statistics are buffers of the model), saved on the best validation loss
  and every ``save_interval`` steps;
* :meth:`KVProcedure.visualize_representation_space` plots a t-SNE of the
  trunk's node embeddings;
* under an active ``torch.profiler`` (``logging.profile``) the host work
  between chunks and steps is named by spans
  (:func:`grl_torch.utils.profiling.span`): ``grl.chunk`` around a chunk,
  holding ``grl.chunk.load``, ``grl.chunk.replay`` and
  ``grl.chunk.readback``; ``grl.step.replay`` (a single step's copy-in
  and graph launch) or ``grl.step.eager`` (a single step run eagerly),
  ``grl.step.lambda``, ``grl.step.scores`` and ``grl.step.log`` for each
  step; and ``grl.checkpoint`` where a step checkpoint is saved. The
  counter ``single_steps`` holds how many single steps were replayed and
  run eagerly, and how many one-step graphs were recorded.

Under ``parallel.mesh`` (``kv_procedure.py:155-176, 294-296``) every rank
reads the whole global batch and keeps its rows
(:meth:`~grl_torch.trainer.procedures.base_procedure.BaseProcedure.place_batch`),
so every rank buckets the same shapes and buffers its chunks by the same
keys; the step sums the gradients over ``data``
(:meth:`~grl_torch.trainer.procedures.base_procedure.BaseProcedure.build_train_body`)
and the validation loss and confusion matrix too, so every rank sees the
same F1 and saves at the same step. Chunks and one-step graphs are
captured where the world's backend is NCCL, and steps run one by one,
eagerly, on gloo (``BaseProcedure.captures``); COO batches under a mesh
step one at a time, as in ``grl_tpu``. Only the first rank writes
checkpoints and summaries; every rank loads. The subclasses that run a
train step of their own
(self-supervised, joint, graph classification) place their batches and
reduce their steps through the same ``place_batch`` and ``update``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from grl_torch.config import ConfigDict
from grl_torch.data.collate import BucketPadding, SparseBucketPadding
from grl_torch.data.dataloader import BaseDataLoader
from grl_torch.models.gcn_family import GCNTrunk
from grl_torch.ops.relagg import check_sm90_shape
from grl_torch.ops.sparse import RelationalGraph, batch_relational_coo
from grl_torch.trainer.lr_schedulers import cosine_schedule_lambda
from grl_torch.trainer.metrics import macro_scores, per_class_report
from grl_torch.trainer.procedures.base_procedure import BaseProcedure
from grl_torch.utils.device import optional_dtype
from grl_torch.utils.metric_tracker import Dictlist
from grl_torch.utils.profiling import Profiler, span


# The tensors of a COO batch's graph, each copied into a chunk's static
# tensors; the rest of a RelationalGraph is its static metadata.
COO_LEAVES = ("senders", "receivers", "relations", "weights", "mask")


def adjacency_leaves(A: Any) -> Dict[str, torch.Tensor]:
    """The tensors of a batch's adjacency by name: a dense ``A``, or a COO
    graph's edge arrays."""
    if isinstance(A, RelationalGraph):
        return {name: getattr(A, name) for name in COO_LEAVES}
    return {"A": A}


def with_leaves(A: Any, leaves: Dict[str, torch.Tensor]) -> Any:
    """``A`` with its tensors replaced by ``leaves``
    (:func:`adjacency_leaves`' names), its metadata kept."""
    if isinstance(A, RelationalGraph):
        return dataclasses.replace(A, **leaves)
    return leaves["A"]


def adjacency_to(A: Any, device: torch.device) -> Any:
    """``A``'s tensors copied to ``device``."""
    return with_leaves(A, {name: t.to(device) for name, t in adjacency_leaves(A).items()})


class KVProcedure(BaseProcedure):
    def __init__(self, model: torch.nn.Module, config: ConfigDict, **kwargs: Any):
        super().__init__(model, config, **kwargs)
        self._scan_k = max(1, int(self.config.get("scan_steps", 1)))
        self.global_step = 0
        self.train_loader, self.val_loader, self.class_names = self._init_dataloaders()
        self._check_dropedge_shapes()
        args = self.config.get_path("data_config.dataset.args", ConfigDict())
        self.pad_value = int(args.get("node_label_padding_value", -100))
        other = args.get("other_class_index")
        self.other_class_index = None if other is None else int(other)
        self.num_classes = int(getattr(self.model, "output_dim"))
        self._ignore = tuple(
            v for v in (self.pad_value, self.other_class_index) if v is not None
        )
        self._train_fn = None
        self._train_body = None
        self._eval_fn = None
        # The chunks' static inputs on the device, by shape key.
        self._slots: Dict[tuple, Dict[str, Any]] = {}
        self._lam = None
        self._last_ckpt_step = 0
        profile_cfg = self.config.get_path("logging.profile", {}) or {}
        self.profiler = Profiler(
            self.config.get("output_dir", "."),
            start_step=int(profile_cfg.get("start_step", -1)),
            num_steps=int(profile_cfg.get("num_steps", 0)),
        )
        self.save_interval = self.config.get("save_interval")

    # ------------------------------------------------------------------
    def _init_dataloaders(self) -> Tuple[Any, Any, Tuple[str, ...]]:
        """(reference: kv_procedure.py:30-59)."""
        loader_factory = BaseDataLoader(self.config)
        dataset_type = self.config.get_path("data_config.dataset.type", "DatapileDataset")
        train_ds = loader_factory._load_dataset(
            dataset_type, self.config.data_config.training, data_type="training"
        )
        train_loader = loader_factory._get_dataloader(train_ds, self.config.data_config.training)
        val_ds = loader_factory._load_dataset(
            dataset_type, self.config.data_config.validation, data_type="validation"
        )
        val_loader = loader_factory._get_dataloader(val_ds, self.config.data_config.validation)
        pairs = sorted(train_ds.id_to_class.items())
        class_names = tuple(["other"] + ["_".join(names) for _, names in pairs])
        return train_loader, val_loader, class_names

    def _check_dropedge_shapes(self) -> None:
        """Refuse, when the config is read, padding that bf16 K1/K2 cannot
        take: with ``kernel_impl: pallas``, DropEdge on and bfloat16, every
        padded node count N (BucketPadding's quantum and buckets) and every
        width F of the trunk's convolutions must be divisible by 8
        (:func:`grl_torch.ops.relagg.check_sm90_shape`). A training collate
        chain with no BucketPadding leaves N to each batch's pages, which
        nothing here can check, so it is refused too. (Validation runs K3,
        which takes any N.)"""
        trunks = [m for m in self.model.modules() if isinstance(m, GCNTrunk)
                  and m.kernel_impl == "pallas" and m.edge_dropout_rate > 0.0 and m.dtype == torch.bfloat16]
        if not trunks or any(isinstance(p, SparseBucketPadding) for p in self.train_loader.collate_chain):
            # COO batches never reach K1/K2: a kernel-less RelationalGraph
            # takes kernel_impl: xla, and the model refuses any other.
            return
        if not any(isinstance(p, BucketPadding) for p in self.train_loader.collate_chain):
            raise ValueError(
                "kernel_impl: pallas in bfloat16 with DropEdge needs BucketPadding in the training "
                "data_collate: bf16 K1/K2 read through TMA and need every padded node count N with "
                "N % 8 == 0, which only a BucketPadding quantum (and buckets) divisible by 8 guarantees"
            )
        pads = [p for loader in (self.train_loader, self.val_loader) for p in loader.collate_chain
                if isinstance(p, BucketPadding)]
        sizes = sorted({p.quantum for p in pads} | {b for p in pads for b in p.buckets})
        widths = sorted({conv.h_weights.shape[0] // (conv.num_relations + 1)
                         for trunk in trunks for conv in (trunk.gcn1, trunk.gcn2, trunk.gcn3)})
        for N in sizes:
            for F in widths:
                try:
                    check_sm90_shape(N, F)
                except ValueError as err:
                    raise ValueError(
                        f"kernel_impl: pallas in bfloat16 with DropEdge pads to N={N} (BucketPadding "
                        f"quantum/buckets) at width F={F}: {err}"
                    ) from None

    # ------------------------------------------------------------------
    def _host_batch(self, batch: Dict[str, Any], pin: bool = False):
        """``(V, A, labels)`` on the host, features and adjacency cast to
        the compute dtype (half the bytes under bf16, and no cast pass on
        the device); in page-locked memory with ``pin``, for a copy to the
        device that does not wait. A COO batch (``coo_*`` keys) gives flat
        ``V (B*N, F)`` and a :class:`RelationalGraph` with ``batch_shape
        (B, N)``: int32 indices, weights in the compute dtype, a bool mask
        (``kv_procedure.py:108-129``)."""
        dtype = optional_dtype(getattr(self.model, "compute_dtype", None)) or torch.float32

        def host(array, to_dtype):
            tensor = torch.from_numpy(np.ascontiguousarray(array)).to(to_dtype)
            return tensor.pin_memory() if pin else tensor

        if self.mesh is not None:
            # This rank's rows of the global batch.
            used = [k for k in batch if k in ("textline_encoding", "node_label", "adjacency_matrix")
                    or k.startswith("coo_")]
            batch = self.place_batch({k: np.asarray(batch[k]) for k in used},
                                     pad_values={"node_label": self.pad_value})
        V, labels = host(batch["textline_encoding"], dtype), host(batch["node_label"], torch.int64)
        if "coo_senders" not in batch:
            return V, host(batch["adjacency_matrix"], dtype), labels
        B, N = labels.shape
        graph = batch_relational_coo(
            *(torch.from_numpy(np.asarray(batch[f"coo_{name}"])).to(torch.int32)
              for name in ("senders", "receivers", "relations")),
            torch.from_numpy(np.asarray(batch["coo_weights"])).to(dtype),
            torch.from_numpy(np.asarray(batch["coo_mask"])).to(torch.bool),
            nodes_per_sample=N, num_relations=int(self.model.num_edges),
        )
        if pin:
            graph = with_leaves(graph, {name: t.pin_memory() for name, t in adjacency_leaves(graph).items()})
        return V.reshape(B * N, -1), graph, labels

    def _prepare_batch(self, batch: Dict[str, Any]):
        """``(V, A, labels)`` on the device, with one copy each (a copy
        per edge array of a COO graph)."""
        V, A, labels = self._host_batch(batch)
        return V.to(self.device), adjacency_to(A, self.device), labels.to(self.device)

    def _ensure_initialized(self) -> None:
        if self.state is None:
            self.init_state()
            # Resume: continue the host-side step counters from the
            # restored step so the lambda schedule and the checkpoint
            # cadence pick up where the earlier run stopped.
            restored = self.state.step
            if restored and self.global_step == 0:
                self.global_step = restored
                self._last_ckpt_step = restored
        if self._train_fn is None:
            self._train_fn = self.build_train_step(self.num_classes, self._ignore)
            if self.captures:
                self._train_fn = self._replayed_step(self._train_fn)
            self._train_body = self.build_train_body(self.num_classes, self._ignore)
            self._eval_fn = self.build_eval_step(self.num_classes, self._ignore)
            self._lam = torch.zeros((), dtype=torch.float32, device=self.device)

    def _use_scan(self) -> bool:
        """Chunks of ``scan_steps`` steps (``kv_procedure.py:152-162``) run
        the plain KV step only: a subclass that overrides
        ``_run_train_batch`` (self-supervised, joint, graph classification)
        keeps one step a batch, since a chunk would run the KV step's body
        in place of its own."""
        return self._scan_k > 1 and type(self)._run_train_batch is KVProcedure._run_train_batch

    def _lambda_value(self, epoch: int) -> float:
        """Per-step cosine lambda (reference: kv_procedure.py:201-204)."""
        with span("grl.step.lambda"):
            steps_per_epoch = max(1, len(self.train_loader))
            lam = cosine_schedule_lambda(
                self.global_step,
                total_steps=int(self.config.get("num_epochs", 1)) * steps_per_epoch,
                base_value=1e-4,
                max_value=1.0,
                warmup_steps=5 * steps_per_epoch,
            )
            self.tb_writer.add_scalar("RP/Lambda", lam, self.global_step)
            if self.ems_exp:
                self.ems_exp["RP/Lambda"].append(lam)
            return lam

    def _scores_from_cm(self, cm: np.ndarray, loss: float,
                        item_name: str = "Node classification") -> Dict[str, float]:
        with span("grl.step.scores"):
            scores = macro_scores(cm)
            out = {f"{item_name}_{k}": v for k, v in scores.items()}
            out["loss"] = float(loss)
            return out

    # ------------------------------------------------------------------
    def _run_train_batch(self, batch: Dict[str, Any], epoch: int) -> Dict[str, float]:
        self._ensure_initialized()
        V, A, labels = self._prepare_batch(batch)
        self._lam.fill_(self._lambda_value(epoch))
        loss, cm = self._train_fn(V, A, labels, self.rngs, self._lam)
        return self._scores_from_cm(cm.cpu().numpy(), float(loss))

    def _run_val_batch(self, batch: Dict[str, Any]) -> Tuple[Dict[str, float], np.ndarray]:
        self._ensure_initialized()
        V, A, labels = self._prepare_batch(batch)
        loss, cm, _ = self._eval_fn(V, A, labels, 1.0)
        cm = cm.cpu().numpy()
        return self._scores_from_cm(cm, float(loss)), cm

    def _train_epoch_stepwise(self, epoch: int, train_metrics: Dictlist) -> int:
        """One step per batch; returns the number of (padded) nodes seen."""
        num_nodes = 0
        for batch in self.train_loader:
            self.profiler.maybe_start(self.global_step)
            step_scores = self._run_train_batch(batch, epoch)
            self.profiler.maybe_stop(self.global_step)
            self._log_train_step(step_scores, train_metrics, self.global_step)
            self.global_step += 1
            num_nodes += int(np.prod(np.shape(batch["textline_encoding"])[:2]))
            self._maybe_step_checkpoint(epoch)
        return num_nodes

    def load_chunk(self, items: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor, float]]
                   ) -> Tuple[tuple, Callable[[], Tuple[torch.Tensor, torch.Tensor]]]:
        """K buffered batches of one shape, ``(V, A, labels, lambda)`` each
        on the host, copied into the static inputs of their shape. Returns
        the chunk's key and its body: the K steps in arrival order on those
        inputs, giving the K losses and confusion matrices on the device."""
        self._ensure_initialized()
        with span("grl.chunk.load"):
            key, slots, chunk = self._load([item[:3] for item in items])
            slots["lam"].copy_(torch.tensor([lam for *_, lam in items], dtype=torch.float32))
        return key, chunk

    def _load(self, batches: List[Tuple[torch.Tensor, Any, torch.Tensor]]
              ) -> Tuple[tuple, Dict[str, Any], Callable[[], Tuple[torch.Tensor, torch.Tensor]]]:
        """:meth:`load_chunk` but the lambdas: K batches ``(V, A, labels)``
        copied into their shape's static inputs. Returns the key ``(K,
        *shape_key)``, the static inputs (``slots["lam"]`` for the caller to
        fill) and the chunk's body."""
        K = len(batches)
        V0, A0, labels0 = batches[0]
        key = (K, *self.shape_key(V0, A0, labels0))
        slots = self._slots.get(key)
        if slots is None:
            def static(like):
                return torch.empty(like.shape, dtype=like.dtype, device=self.device)

            leaves = [{name: static(t) for name, t in adjacency_leaves(A0).items()} for _ in range(K)]
            slots = self._slots[key] = {
                "V": [static(V0) for _ in range(K)], "leaves": leaves,
                "A": [with_leaves(A0, leaves[k]) for k in range(K)],
                "labels": [static(labels0) for _ in range(K)],
                "lam": torch.zeros(K, dtype=torch.float32, device=self.device),
            }
        for k, (V, A, labels) in enumerate(batches):
            slots["V"][k].copy_(V, non_blocking=True)
            for name, leaf in adjacency_leaves(A).items():
                slots["leaves"][k][name].copy_(leaf, non_blocking=True)
            slots["labels"][k].copy_(labels, non_blocking=True)
        body = self._train_body

        def chunk():
            out = [body(slots["V"][k], slots["A"][k], slots["labels"][k], self.rngs, slots["lam"][k])
                   for k in range(K)]
            return torch.stack([loss for loss, _ in out]), torch.stack([cm for _, cm in out])

        return key, slots, chunk

    def _replayed_step(self, eager: Callable) -> Callable:
        """The single train step where chunks are captured: ``eager``'s
        signature and results (:meth:`build_train_step`), each step replayed
        from a one-step graph of its batch shape, run by the step runner
        (:meth:`step_runner`). A step copies its batch into the one-step
        static inputs of its shape (:meth:`_load` with one batch; ``lam``,
        a device scalar, by a copy on the device) and replays; the loss and
        confusion matrix come back as copies, since the next replay
        overwrites the graph's. ``rngs`` must be ``self.rngs``, whose
        generator the graphs register. After every step the parameters'
        ``.grad`` hold that step's gradients, as after the eager step: a
        capture leaves them on its graph's outputs, so the step points them
        at the warm-up's after recording and at the graph's after a replay.

        A shape's graph is recorded in the step that warms it up, eagerly on
        the runner's stream, as soon as the shape is known to repeat: at its
        first step where the train loader pads to buckets
        (``BucketPadding``, ``SparseBucketPadding``), which bound the shapes,
        else at its second, so that a shape met once costs no capture and no
        static inputs; before that, ``eager`` runs the step. A replayed step
        is the span ``grl.step.replay`` (copy-in and launch), a warm-up
        ``grl.step.eager``; ``single_steps`` counts them (``"replayed"``,
        ``"eager"``) and the graphs recorded."""
        bucketed = any(isinstance(p, (BucketPadding, SparseBucketPadding)) for p in self.train_loader.collate_chain)
        params = list(self.model.parameters())
        seen, grads = set(), {}

        def train_step(V, A, labels, rngs, lam):
            key = (1, *self.shape_key(V, A, labels))
            runner = self.step_runner()
            replay = key in runner.graphs
            if not replay and not bucketed and key not in seen:
                seen.add(key)
                return eager(V, A, labels, rngs, lam)
            with span("grl.step.replay" if replay else "grl.step.eager"):
                key, slots, step = self._load([(V, A, labels)])
                slots["lam"].fill_(lam)
                losses, cms = runner.run(key, step)
                if not replay:
                    warmed = [p.grad for p in params]
                    runner.record(key, step)
                    grads[key] = [p.grad for p in params]
                for p, grad in zip(params, grads[key] if replay else warmed):
                    p.grad = grad
                self.state.step += 1
            self.single_steps.update({"replayed": 1} if replay else {"eager": 1, "recorded": 1})
            return losses[0].clone(), cms[0].clone()

        return train_step

    @staticmethod
    def shape_key(V: torch.Tensor, A: Any, labels: torch.Tensor) -> tuple:
        """The shapes that select a chunk's graph: V's, the adjacency's
        tensors' (a COO graph's edge bucket) and the labels'
        (``kv_procedure.py:310-316``)."""
        return (tuple(V.shape), tuple(tuple(t.shape) for t in adjacency_leaves(A).values()),
                tuple(labels.shape))

    def run_chunk(self, items: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor, float]]
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """K buffered batches of one shape as one chunk of K steps
        (:meth:`load_chunk`), run by the chunk runner: one graph replay on
        the card. Returns the K losses and confusion matrices, read back
        once (the span ``grl.chunk.readback``: the host's wait for the
        chunk's end, and the copy)."""
        with span("grl.chunk"):
            key, chunk = self.load_chunk(items)
            losses, cms = self.chunk_runner().run(key, chunk)
            self.state.step += len(items)
            with span("grl.chunk.readback"):
                return losses.cpu().numpy(), cms.cpu().numpy()

    def _train_epoch_scanned(self, epoch: int, train_metrics: Dictlist) -> int:
        """``scan_steps = K``: ``grl_tpu``'s ``_train_epoch_scanned``
        (``kv_procedure.py:260-336``). Batches wait in buffers keyed by
        their ``(V, A, labels)`` shapes until K are ready, then run as one
        chunk (:meth:`run_chunk`); within a shape the updates keep the
        arrival order, across shapes they are grouped. The profiler hooks
        bracket the chunk, and each step is logged under its batch's own
        ``global_step``. At the end of the epoch the leftover buffers drain
        step by step through ``_train_fn`` (on the card each a replay of
        its shape's one-step graph, :meth:`_replayed_step`), and the drain
        gets its checkpoint opportunity. Returns the (padded) nodes seen."""
        K = self._scan_k
        buffers: Dict[tuple, list] = {}
        num_nodes = 0

        def flush(items) -> None:
            self.profiler.maybe_start(self.state.step)
            losses, cms = self.run_chunk([item[:4] for item in items])
            self.profiler.maybe_stop(self.state.step)
            for loss, cm, item in zip(losses, cms, items):
                self._log_train_step(self._scores_from_cm(cm, float(loss)), train_metrics, item[4])
            self._maybe_step_checkpoint(epoch)

        for batch in self.train_loader:
            self._ensure_initialized()
            V, A, labels = self._host_batch(batch, pin=self.device.type == "cuda")
            num_nodes += int(np.prod(np.shape(batch["textline_encoding"])[:2]))
            lam = self._lambda_value(epoch)
            gstep = self.global_step
            self.global_step += 1
            if self.mesh is not None and isinstance(A, RelationalGraph):
                # Mesh-sharded COO batches step one at a time, as in
                # grl_tpu (kv_procedure.py:294-296).
                self._lam.fill_(lam)
                loss, cm = self._train_fn(V.to(self.device), adjacency_to(A, self.device),
                                          labels.to(self.device), self.rngs, self._lam)
                self._log_train_step(self._scores_from_cm(cm.cpu().numpy(), float(loss)), train_metrics, gstep)
                continue
            key = self.shape_key(V, A, labels)
            buffers.setdefault(key, []).append((V, A, labels, lam, gstep))
            if len(buffers[key]) == K:
                flush(buffers.pop(key))
        for items in buffers.values():
            for V, A, labels, lam, gstep in items:
                self._lam.fill_(lam)
                loss, cm = self._train_fn(V.to(self.device), adjacency_to(A, self.device),
                                          labels.to(self.device), self.rngs, self._lam)
                self._log_train_step(self._scores_from_cm(cm.cpu().numpy(), float(loss)), train_metrics, gstep)
        self._maybe_step_checkpoint(epoch)
        return num_nodes

    def _log_train_step(self, step_scores: Dict[str, float],
                        train_metrics: Dictlist, gstep: int) -> None:
        with span("grl.step.log"):
            train_metrics.update_metrics(step_scores)
            self.tb_writer.add_scalar("Train_step_loss", step_scores["loss"], gstep)
            if self.ems_exp:
                self.ems_exp["Train/step_loss"].append(step_scores["loss"])

    def _maybe_step_checkpoint(self, epoch: int) -> None:
        """Step checkpoint every ``save_interval`` applied steps."""
        if not self.save_interval:
            return
        if self.state.step - self._last_ckpt_step >= int(self.save_interval):
            with span("grl.checkpoint"):
                self._last_ckpt_step = self.state.step
                self.checkpointer.save_checkpoint(
                    self.state.state_dict(), self.model_dir,
                    meta={"epoch": epoch, "global_step": self.state.step},
                )

    def _optimize_per_epoch(self, epoch: int) -> Dict[str, float]:
        """(reference: kv_procedure.py:180-244)."""
        train_metrics = Dictlist()
        epoch_start = time.time()
        if self._use_scan():
            num_nodes = self._train_epoch_scanned(epoch, train_metrics)
        else:
            num_nodes = self._train_epoch_stepwise(epoch, train_metrics)
        elapsed = time.time() - epoch_start
        train_result = train_metrics.result()
        train_result["nodes_per_sec"] = round(num_nodes / max(elapsed, 1e-9), 1)
        self.logger.info(
            f"Training epoch: {epoch} step: {self.global_step} metrics: {train_result}"
        )
        self.tb_writer.add_scalars(train_result, epoch, prefix="Train ")
        if self.ems_exp:
            for metric_name, score in train_result.items():
                self.ems_exp[f"Train/{metric_name}"].append(score)

        # Validation: per-step macro averages + epoch-level report from the
        # summed confusion matrix (reference: kv_procedure.py:213-244).
        val_metrics = Dictlist()
        epoch_cm = np.zeros((self.num_classes, self.num_classes), np.float64)
        for batch in self.val_loader:
            scores, cm = self._run_val_batch(batch)
            val_metrics.update_metrics(scores)
            epoch_cm += cm

        val_result = val_metrics.result() if val_metrics else {"loss": float("nan")}
        self.logger.info(f"Validation metrics: {val_result}")
        self.tb_writer.add_scalars(val_result, epoch, prefix="Val ")
        if self.ems_exp:
            for metric_name, score in val_result.items():
                self.ems_exp[f"Validation/{metric_name}"].append(score)

        macro_val = macro_scores(epoch_cm)
        self.tb_writer.add_scalars(macro_val, epoch, prefix="Macro Val ")
        if self.ems_exp:
            for metric_name, score in macro_val.items():
                self.ems_exp[f"Macro Validation/{metric_name}"].append(score)
        self.logger.info("Classification report\n" + per_class_report(epoch_cm, self.class_names))
        macro_val["loss"] = val_result["loss"]
        return macro_val

    def _log_parameter_histograms(self, epoch: int) -> None:
        """Per-parameter histogram each epoch (reference:
        kv_procedure.py:357-359), only when the tensorboard sink is on."""
        if self.state is None or not getattr(self.tb_writer, "_tb", None):
            return
        for name, param in self.model.named_parameters():
            self.tb_writer.add_histogram(name.replace(".", "/"), param.detach().float().cpu().numpy(), epoch)

    # ------------------------------------------------------------------
    def visualize_representation_space(self, loader=None, out_path: Optional[str] = None) -> Optional[str]:
        """2-D t-SNE plot of the trunk's node embeddings (``kv_procedure.py:418-459``):
        the output of ``model.trunk``, read through a forward hook over an
        eval-mode pass of ``loader`` (the validation loader by default),
        padded nodes left out, written as a JPEG (``out_path``, else
        ``<output_dir>/representation_space.jpg``), whose path it returns.
        Needs sklearn and matplotlib: without them it logs a warning and
        returns ``None``."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            from sklearn.manifold import TSNE
        except Exception as err:
            self.logger.warning(f"t-SNE viz unavailable: {err}")
            return None
        self._ensure_initialized()
        loader = loader or self.val_loader
        captured: List[torch.Tensor] = []
        handle = self.model.trunk.register_forward_hook(
            lambda module, inputs, output: captured.append(output.detach()))
        reps, labels = [], []
        try:
            self.model.eval()
            with torch.no_grad():
                for batch in loader:
                    V, A, y = self._prepare_batch(batch)
                    self.model((V, A))
                    emb = captured.pop()
                    reps.append(emb.float().cpu().numpy().reshape(-1, emb.shape[-1]))
                    labels.append(y.cpu().numpy().reshape(-1))
        finally:
            handle.remove()
        reps = np.concatenate(reps)
        labels = np.concatenate(labels)
        keep = labels != self.pad_value
        reduced = TSNE(n_components=2, random_state=42).fit_transform(reps[keep])
        plt.figure(figsize=(10, 8))
        sc = plt.scatter(reduced[:, 0], reduced[:, 1], c=labels[keep], cmap="jet", alpha=0.6)
        plt.colorbar(sc, label="Class Labels")
        plt.title("2D Visualization of Representation Space using t-SNE")
        out_path = out_path or f"{self.config.get('output_dir', '.')}/representation_space.jpg"
        plt.savefig(out_path)
        plt.close()
        return out_path

    # ------------------------------------------------------------------
    def __call__(self) -> float:
        """Epoch loop; returns the final validation macro F1 (reference:
        kv_procedure.py:346-377)."""
        self._ensure_initialized()
        best_loss = float("inf")
        self.logger.info("Start optimizing ...")
        metrics: Dict[str, float] = {"f1-score": 0.0}
        num_epochs = int(self.config.get("num_epochs", 1))
        for epoch in range(num_epochs):
            metrics = self._optimize_per_epoch(epoch)
            self._update_learning_rate(epoch, self.global_step)
            self._log_parameter_histograms(epoch)
            if metrics["loss"] < best_loss:
                best_loss = metrics["loss"]
                self.checkpointer.save_checkpoint(
                    self.state.state_dict(),
                    self.model_dir,
                    meta={
                        "epoch": epoch,
                        "config": self.config.to_dict(),
                        "meta_data": metrics,
                    },
                )
        self.logger.info("Finish optimizing!")
        self.tb_writer.close()
        return metrics["f1-score"]
