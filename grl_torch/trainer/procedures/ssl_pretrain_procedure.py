"""Self-supervised pretraining over a task list.

Counterpart of ``grl_tpu/trainer/procedures/ssl_pretrain_procedure.py``
(:26-236). One step sums every configured task's loss, each from its own
forward of the trunk with its own dropout draws (``graph_edit_distance``
and ``dgi`` run the trunk twice), and takes one optimizer step on the sum.
With ``dgi`` in ``tasks`` the train state is the :class:`DGI` wrapper, so
the optimizer covers the encoder and the discriminator and the checkpoint
holds ``encoder.*`` and ``discriminator.*``, as ``grl_tpu``'s tree does.
After the update, a forward of the updated encoder in eval mode feeds the
node-classification confusion matrix that the step reports
(reference: ssl_pretrain_procedure.py:105-120).

One step a batch: the procedure overrides ``_run_train_batch``, so
``scan_steps`` does not chunk it (``KVProcedure._use_scan``).

Under ``parallel.mesh`` every rank keeps its rows of the global batch
(``place_batch``: targets padded with -100, everything else with 0), and
the step's task losses go through the multi-term
:meth:`~grl_torch.trainer.procedures.base_procedure.BaseProcedure.update`,
so that every rank applies the single-device step's gradient; the
monitoring forward's counts are summed over ``data``. Without ``dgi``
the tensor-parallel rules place ``SSLGCN``'s RanPAC and classifier; with
it the DGI tree stays whole on every rank, as ``grl_tpu``'s
``_ensure_initialized`` builds its state without ``shard_params``
(:48-68).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from grl_torch.config import ConfigDict
from grl_torch.models.base import count_parameters
from grl_torch.models.ssl_gcn import DGI, PAIR_TASKS
from grl_torch.parallel.mesh import replicate
from grl_torch.trainer import losses
from grl_torch.trainer.losses import IGNORE_INDEX
from grl_torch.trainer.metrics import confusion_matrix
from grl_torch.trainer.procedures.base_procedure import TrainState
from grl_torch.trainer.procedures.kv_procedure import KVProcedure

SSL_CRITERIONS = {
    "node_property": losses.masked_mse,
    "edge_mask": losses.binary_cross_entropy_with_logits,
    "pairwise_distance": losses.cross_entropy,
    "pairwise_similarity": losses.masked_mse,
    "graph_edit_distance": losses.masked_mse,
    "dgi": losses.binary_cross_entropy_with_logits,
}


def is_target(key: str) -> bool:
    """Whether a batch array is a task's target, padded with -100 (the
    value ``BucketPadding`` and ``NumpyPadding`` give them) so that the
    masked losses and counts drop a padded row."""
    return key in ("node_label", "node_property", "graph_edit_distance", "dgi") or key.endswith("_targets")


def task_arrays(batch: Dict[str, Any], keys, device: torch.device, place: Callable) -> Dict[str, torch.Tensor]:
    """The arrays ``keys`` of a host batch that it holds, on ``device``:
    float16 and float64 cast to float32, as ``grl_tpu`` casts them, and
    each cut to this rank's rows by ``place`` (``BaseProcedure.place_batch``),
    targets padded with -100 and the rest with 0."""
    arrays = {}
    for key in keys:
        if key in batch:
            value = np.asarray(batch[key])
            if value.dtype in (np.float16, np.float64):
                value = value.astype(np.float32)
            arrays[key] = value
    arrays = place(arrays, {key: IGNORE_INDEX for key in arrays if is_target(key)})
    return {key: torch.from_numpy(np.ascontiguousarray(value)).to(device) for key, value in arrays.items()}


def task_target(task: str, target: torch.Tensor) -> torch.Tensor:
    """Class ids for ``pairwise_distance``, float32 for the others."""
    return target.long() if task == "pairwise_distance" else target.float()


class SSLPretrainProcedure(KVProcedure):
    def __init__(self, model: torch.nn.Module, config: ConfigDict, tasks: List[str], **kwargs: Any):
        super().__init__(model, config, **kwargs)
        self.tasks = list(tasks)
        self.emb_dim = int(self.config.get_path("network.args.net_size", model.net_size)) // 2
        self.dgi = DGI(self.model, self.emb_dim, device=self.device,
                       generator=torch.Generator().manual_seed(self.seed))
        self._ssl_fn = None

    # ------------------------------------------------------------------
    def init_state(self) -> TrainState:
        """With ``dgi``, the state is the DGI wrapper's: the optimizer takes
        the encoder's and the discriminator's parameters. Under a mesh the
        replicas start from the first rank's, and no leaf is sharded."""
        if "dgi" not in self.tasks:
            return super().init_state()
        self.logger.info(f"Num parameters (incl. DGI head): {count_parameters(self.dgi):,}")
        if self.mesh is not None:
            replicate(self.dgi)
        self.sharded, self.model_group = [], None
        params = [p for p in self.dgi.parameters() if p.requires_grad]
        self.state = TrainState(self.dgi, self.optimizer_factory.make(params))
        self._load_prev_checkpoint(self.state)
        self._steps = None
        return self.state

    def _ensure_initialized(self) -> None:
        super()._ensure_initialized()
        if self._ssl_fn is None:
            self._ssl_fn = self._build_ssl_train_step()

    def _task_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Device tensors of everything the configured tasks read, this
        rank's rows under a mesh."""
        wanted = {"textline_encoding", "adjacency_matrix", "node_label", "node_mask"}
        for task in self.tasks:
            if task == "node_property":
                wanted.add("node_property")
            elif task in PAIR_TASKS:
                wanted.update({f"{task}_indices", f"{task}_targets"})
            elif task == "graph_edit_distance":
                wanted.update({"graph_edit_distance", "aug_textline_encoding", "aug_adjacency_matrix"})
            elif task == "dgi":
                wanted.update({"dgi", "negative_textline_encoding", "negative_adjacency_matrix"})
        return task_arrays(batch, wanted, self.device, self.place_batch)

    def _task_loss(self, task: str, data: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Callable, torch.Tensor]:
        """One task's loss term ``(loss, criterion, target)``, from its own
        forward(s) of the trunk."""
        model, rngs = self.model, self.rngs
        inputs = (data["textline_encoding"], data["adjacency_matrix"])
        criterion = SSL_CRITERIONS.get(task)
        if task == "node_property":
            pred, target = model(inputs, rngs=rngs, task=task), data[task].float()
        elif task in PAIR_TASKS:
            pred = model(inputs, rngs=rngs, task=task, edges=data[f"{task}_indices"])
            target = task_target(task, data[f"{task}_targets"])
        elif task == "graph_edit_distance":
            pred = model(inputs + (data["aug_textline_encoding"], data["aug_adjacency_matrix"]),
                         rngs=rngs, task=task)
            target = data["graph_edit_distance"].float()
        elif task == "dgi":
            pos, neg = model(inputs + (data["negative_textline_encoding"], data["negative_adjacency_matrix"]),
                             rngs=rngs, task=task)
            pred = self.dgi.forward_contrastive(pos, neg)
            if "node_mask" in data:
                # Padded nodes are excluded: -100 is masked out of the BCE.
                mask = data["node_mask"] > 0
                ignore = torch.full_like(data["node_mask"], -100.0)
                target = torch.cat([torch.where(mask, 1.0, ignore), torch.where(mask, 0.0, ignore)], dim=1)
            else:
                target = data["dgi"].float()
        else:
            raise ValueError(f"Unknown SSL task {task!r}; tasks: {sorted(SSL_CRITERIONS)}")
        return criterion(pred, target), criterion, target

    def _build_ssl_train_step(self) -> Callable[[Dict[str, torch.Tensor]], Tuple[torch.Tensor, torch.Tensor]]:
        """``step(data) -> (loss, cm)``: the summed task losses, one update
        (:meth:`update`, a term a task), then the monitoring forward of the
        updated model; both results stay on the device, the whole batch's
        under a mesh (the monitoring counts summed over ``data``)."""
        model, state = self.model, self.state
        params = [p for group in state.optimizer.param_groups for p in group["params"]]

        def train_step(data):
            model.train()
            state.optimizer.zero_grad(set_to_none=True)
            total, _ = self.update([self._task_loss(task, data) for task in self.tasks], params)
            state.step += 1
            model.eval()
            with torch.no_grad():
                logits = model((data["textline_encoding"], data["adjacency_matrix"]))
            cm = confusion_matrix(logits.argmax(dim=-1), data["node_label"].long(), self.num_classes, self._ignore)
            return total, self.data_sum(cm, "monitor all_reduce")

        return train_step

    def _run_train_batch(self, batch: Dict[str, Any], epoch: int) -> Dict[str, float]:
        self._ensure_initialized()
        loss, cm = self._ssl_fn(self._task_batch(batch))
        self._lambda_value(epoch)
        return self._scores_from_cm(cm.cpu().numpy(), float(loss))

    def _run_val_batch(self, batch: Dict[str, Any]) -> Tuple[Dict[str, float], np.ndarray]:
        if "dgi" not in self.tasks:
            return super()._run_val_batch(batch)
        self._ensure_initialized()
        V, A, labels = self._prepare_batch(batch)
        self.model.eval()
        with torch.no_grad():
            logits = self.model((V, A))
        loss = losses.cross_entropy(logits, labels)
        cm = confusion_matrix(logits.argmax(dim=-1), labels, self.num_classes, self._ignore)
        loss, cm = self.reduce_eval(loss, cm, losses.cross_entropy, labels)
        cm = cm.cpu().numpy()
        return self._scores_from_cm(cm, float(loss)), cm
