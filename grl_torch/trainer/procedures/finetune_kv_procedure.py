"""Finetune: KVProcedure with a shape-matched partial backbone load.

Counterpart of ``grl_tpu/trainer/procedures/finetune_kv_procedure.py``
(:20-66): the tensors of a pretrained checkpoint (``optimize_settings.
ssl_pretrain_path``) are merged into the fresh model wherever the name
exists and the shape matches; everything else (a new classifier head,
say) keeps its fresh initialization. Module names are flax's paths, so a
state-dict name matches where ``grl_tpu``'s nested path does: an
``SSLGCN`` checkpoint gives the flagship its trunk (and its classifier and
RanPAC buffer where the widths agree), and a ``DGI`` one, whose names all
start ``encoder.`` or ``discriminator.``, gives it nothing, as in
``grl_tpu``.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from grl_torch.config import ConfigDict
from grl_torch.trainer.procedures.base_procedure import TrainState
from grl_torch.trainer.procedures.kv_procedure import KVProcedure


def merge_matching_leaves(target: Mapping[str, torch.Tensor], source: Optional[Mapping[str, Any]],
                          logger=None) -> Tuple[Dict[str, torch.Tensor], int]:
    """``target`` with each tensor replaced by ``source``'s of the same name
    and shape; returns (merged, num_loaded). A name ``source`` lacks and a
    shape that differs keep the target's tensor, with a warning when a
    ``logger`` is given."""
    source = source or {}
    merged: Dict[str, torch.Tensor] = {}
    loaded = 0
    for name, value in target.items():
        if name not in source:
            merged[name] = value
            if logger:
                logger.warning(f"Not found pre-trained parameters for {name}")
        elif tuple(source[name].shape) == tuple(value.shape):
            merged[name] = source[name]
            loaded += 1
        else:
            merged[name] = value
            if logger:
                logger.warning(f"Shape mismatch for {name}: kept fresh init")
    return merged, loaded


class FinetuneKVProcedure(KVProcedure):
    def __init__(self, model: torch.nn.Module, config: ConfigDict, **kwargs: Any):
        super().__init__(model, config, **kwargs)
        self._backbone_path = self.config.get_path("optimize_settings.ssl_pretrain_path")
        # Tensors the last merge loaded: (parameters, buffers).
        self.loaded = (0, 0)

    def init_state(self) -> TrainState:
        """The base state (and any ``checkpoint_path`` or resume), then the
        backbone merged in, before any step or capture: parameters and
        buffers (``grl_tpu``'s ``constants``: the RanPAC kernel) apart, as
        ``grl_tpu`` merges its two collections, each copied into the
        model's own tensor so that the optimizer keeps its references;
        under tensor parallelism, this rank's share of each sharded leaf."""
        state = super().init_state()
        if not self._backbone_path:
            self.logger.info("Not found any pretrained model!")
            return state
        self.logger.info("Restoring pretrained backbone ...")
        source = self.checkpointer.restore_checkpoint(self._backbone_path, map_location=self.device)["model"]
        # Under tensor parallelism the whole checkpoint's sharded leaves are
        # cut to this rank's share first, so they match by shape as
        # grl_tpu's global arrays do.
        source = state.share_of(source)
        params = dict(self.model.named_parameters())
        buffers = dict(self.model.named_buffers())
        merged_params, n_params = merge_matching_leaves(params, source, self.logger)
        merged_buffers, n_buffers = merge_matching_leaves(buffers, source)
        with torch.no_grad():
            for tensors, merged in ((params, merged_params), (buffers, merged_buffers)):
                for name, tensor in tensors.items():
                    if merged[name] is not tensor:
                        tensor.copy_(merged[name])
        self.loaded = (n_params, n_buffers)
        self.logger.info(f"Loaded {n_params} pretrained parameter tensors.")
        return state
