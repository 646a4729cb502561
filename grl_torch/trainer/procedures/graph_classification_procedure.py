"""Graph-level classification procedure.

Counterpart of ``grl_tpu/trainer/procedures/graph_classification_procedure.py``
(:25-108): the KV machinery with per-graph targets (``graph_label``) and
the model called in ``graph_classification`` task mode where it has
``n_graph_classes`` (``SSLGCN``), else taken to emit ``(B, 1, C)`` graph
logits; either is read as ``(B, C)``. The class count comes from
``procedure.args.n_graph_classes``, else the model's. It inherits the
fine-tune's partial backbone load, and runs one step a batch
(``KVProcedure._use_scan``). Under ``parallel.mesh`` a rank's graph
labels are its rows of the batch's (padded rows -100), its step goes
through :meth:`~grl_torch.trainer.procedures.base_procedure.BaseProcedure.update`
and its eval sums loss and counts over ``data``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from grl_torch.config import ConfigDict
from grl_torch.trainer.losses import IGNORE_INDEX
from grl_torch.trainer.metrics import confusion_matrix
from grl_torch.trainer.procedures.finetune_kv_procedure import FinetuneKVProcedure


class GraphClassificationProcedure(FinetuneKVProcedure):
    def __init__(self, model: torch.nn.Module, config: ConfigDict, **kwargs: Any):
        super().__init__(model, config, **kwargs)
        self.num_classes = int(
            self.config.get_path(
                "procedure.args.n_graph_classes",
                getattr(self.model, "n_graph_classes", getattr(self.model, "output_dim")),
            )
        )

    def _graph_labels(self, batch: Dict[str, Any]) -> torch.Tensor:
        """The batch's graph labels, this rank's rows under a mesh."""
        labels = self.place_batch({"graph_label": np.asarray(batch["graph_label"]).astype(np.int64).reshape(-1)},
                                  {"graph_label": IGNORE_INDEX})["graph_label"]
        return torch.from_numpy(np.ascontiguousarray(labels)).to(self.device)

    def _forward_kwargs(self) -> Dict[str, str]:
        return {"task": "graph_classification"} if hasattr(self.model, "n_graph_classes") else {}

    def build_train_body(self, num_classes: int, ignore_values: Tuple[int, ...]) -> Callable:
        model, criterion, state = self.model, self.criterion, self.state
        params = [p for group in state.optimizer.param_groups for p in group["params"]]
        kwargs = self._forward_kwargs()

        def body(V, A, labels, rngs, lam):
            model.train()
            state.optimizer.zero_grad(set_to_none=True)
            logits = model((V, A), rngs=rngs, **kwargs).reshape(labels.shape[0], -1)  # (B,1,C) -> (B,C)
            loss = criterion(logits, labels)
            cm = confusion_matrix(logits.detach().argmax(dim=-1), labels, num_classes, ignore_values)
            loss, summed = self.update([(loss, criterion, labels)], params, cm.reshape(-1))
            return loss, summed.reshape(cm.shape)

        return body

    def build_eval_step(self, num_classes: int, ignore_values: Tuple[int, ...]) -> Callable:
        model, criterion = self.model, self.criterion
        kwargs = self._forward_kwargs()

        def eval_step(V, A, labels, lam):
            model.eval()
            with torch.no_grad():
                logits = model((V, A), **kwargs).reshape(labels.shape[0], -1)
                loss = criterion(logits, labels)
            preds = logits.argmax(dim=-1)
            loss, cm = self.reduce_eval(loss, confusion_matrix(preds, labels, num_classes, ignore_values),
                                        criterion, labels)
            return loss, cm, preds

        return eval_step

    def _run_train_batch(self, batch: Dict[str, Any], epoch: int) -> Dict[str, float]:
        self._ensure_initialized()
        V, A, _ = self._prepare_batch(batch)
        self._lam.fill_(self._lambda_value(epoch))
        loss, cm = self._train_fn(V, A, self._graph_labels(batch), self.rngs, self._lam)
        return self._scores_from_cm(cm.cpu().numpy(), float(loss))

    def _run_val_batch(self, batch: Dict[str, Any]) -> Tuple[Dict[str, float], np.ndarray]:
        self._ensure_initialized()
        V, A, _ = self._prepare_batch(batch)
        loss, cm, _ = self._eval_fn(V, A, self._graph_labels(batch), 1.0)
        cm = cm.cpu().numpy()
        return self._scores_from_cm(cm, float(loss)), cm
