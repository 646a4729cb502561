"""Joint supervised + self-supervised multi-task training.

Counterpart of ``grl_tpu/trainer/procedures/joint_training_procedure.py``
(:26-152): the KV cross-entropy plus auxiliary SSL losses on batches of a
second pair of loaders (``data_config.ssl_training`` / ``ssl_validation``).
The SSL iterator wraps around, so an epoch is as long as the KV loader;
one step sums the supervised loss and every task's loss and takes one
optimizer step. Without an SSL loader a step is the supervised loss alone.
One step a batch (``KVProcedure._use_scan``).

Under ``parallel.mesh`` both loaders read the whole global batch on every
rank, which keeps its rows of each (``place_batch``), and the KV term and
each task's term go through the multi-term
:meth:`~grl_torch.trainer.procedures.base_procedure.BaseProcedure.update`;
a step without SSL data is one term.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from grl_torch.config import ConfigDict
from grl_torch.data.dataloader import BaseDataLoader
from grl_torch.trainer import losses
from grl_torch.trainer.metrics import confusion_matrix
from grl_torch.trainer.procedures.kv_procedure import KVProcedure
from grl_torch.trainer.procedures.ssl_pretrain_procedure import task_arrays, task_target

JOINT_CRITERIONS = {
    "node_property": losses.masked_mse,
    "edge_mask": losses.binary_cross_entropy_with_logits,
    "pairwise_distance": losses.cross_entropy,
    "pairwise_similarity": losses.masked_mse,
}


class JointTrainingProcedure(KVProcedure):
    def __init__(self, model: torch.nn.Module, config: ConfigDict, tasks: List[str], **kwargs: Any):
        super().__init__(model, config, **kwargs)
        self.tasks = list(tasks)
        self.ssl_train_loader, self.ssl_val_loader = self._init_ssl_dataloaders()
        self._ssl_iter = None
        self._joint_fn = None

    def _init_ssl_dataloaders(self):
        factory = BaseDataLoader(self.config)
        dataset_type = self.config.get_path("data_config.dataset.type", "DatapileDataset")
        loaders = []
        for split in ("ssl_training", "ssl_validation"):
            split_cfg = self.config.get_path(f"data_config.{split}")
            if split_cfg is None:
                loaders.append(None)
                continue
            ds = factory._load_dataset(dataset_type, split_cfg, data_type=split)
            loaders.append(factory._get_dataloader(ds, split_cfg))
        return loaders

    def _next_ssl_batch(self) -> Optional[Dict[str, Any]]:
        if self.ssl_train_loader is None:
            return None
        if self._ssl_iter is None:
            self._ssl_iter = iter(self.ssl_train_loader)
        try:
            return next(self._ssl_iter)
        except StopIteration:
            self._ssl_iter = iter(self.ssl_train_loader)
            return next(self._ssl_iter)

    def _ssl_arrays(self, batch: Optional[Dict[str, Any]]) -> Optional[Dict[str, torch.Tensor]]:
        if batch is None:
            return None
        keys = {"textline_encoding", "adjacency_matrix"}
        for task in self.tasks:
            keys.update({task} if task == "node_property" else {f"{task}_indices", f"{task}_targets"})
        return task_arrays(batch, keys, self.device, self.place_batch)

    def _build_joint_train_step(self) -> Callable:
        """``step(V, A, labels, ssl_data) -> (loss, cm)``; ``ssl_data``
        ``None`` is a step without SSL losses."""
        model, criterion, state, tasks = self.model, self.criterion, self.state, self.tasks
        params = [p for group in state.optimizer.param_groups for p in group["params"]]

        def train_step(V, A, labels, ssl_data):
            model.train()
            state.optimizer.zero_grad(set_to_none=True)
            logits = model((V, A), rngs=self.rngs)
            terms = [(criterion(logits, labels), criterion, labels)]
            if ssl_data is not None:
                inputs = (ssl_data["textline_encoding"], ssl_data["adjacency_matrix"])
                for task in tasks:
                    edges = None if task == "node_property" else ssl_data[f"{task}_indices"]
                    pred = model(inputs, rngs=self.rngs, task=task, edges=edges)
                    target = task_target(task, ssl_data[task if task == "node_property" else f"{task}_targets"])
                    terms.append((JOINT_CRITERIONS[task](pred, target), JOINT_CRITERIONS[task], target))
            cm = confusion_matrix(logits.detach().argmax(dim=-1), labels, self.num_classes, self._ignore)
            total, summed = self.update(terms, params, cm.reshape(-1))
            state.step += 1
            return total, summed.reshape(cm.shape)

        return train_step

    def _run_train_batch(self, batch: Dict[str, Any], epoch: int) -> Dict[str, float]:
        self._ensure_initialized()
        if self._joint_fn is None:
            self._joint_fn = self._build_joint_train_step()
        V, A, labels = self._prepare_batch(batch)
        ssl_data = self._ssl_arrays(self._next_ssl_batch())
        self._lambda_value(epoch)
        loss, cm = self._joint_fn(V, A, labels, ssl_data)
        return self._scores_from_cm(cm.cpu().numpy(), float(loss))
