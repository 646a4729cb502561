"""Checkpointing: ``torch.save`` of a state-dict tree + JSON metadata.

Same API as ``grl_tpu.utils.checkpoint.CheckpointHandler`` (save,
restore, ``.meta.json`` sidecar, ``model_latest`` naming). The state is a
nested dict of tensors (e.g. ``{"model": state_dict}``) written with
``torch.save`` and read back with ``torch.load(weights_only=True)``, so a
checkpoint can never run code on load. A ``grl_tpu`` checkpoint crosses
over as numpy arrays through :mod:`grl_torch.models.convert`.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch

from grl_torch.utils.logging import get_logger


class CheckpointHandler:
    LATEST = "model_latest"

    def __init__(self, writes: bool = True):
        """``writes=False`` (the ranks after the first of a world) names the
        checkpoint a save would write and writes nothing."""
        self.logger = get_logger(self.__class__.__name__)
        self.writes = writes

    def make_checkpoint_name(self, name: str, epoch: Optional[int] = None,
                             step: Optional[int] = None) -> str:
        if epoch is None or step is None:
            return f"{name}_latest"
        return f"{name}_epoch_{epoch}_minibatch_{step}"

    def save_checkpoint(
        self,
        state: Any,
        output_dir: str,
        epoch: Optional[int] = None,
        step: Optional[int] = None,
        meta: Optional[Dict[str, Any]] = None,
        name: str = "model",
    ) -> str:
        """Save a state tree + JSON sidecar metadata; returns the path."""
        os.makedirs(output_dir, exist_ok=True)
        ckpt_name = self.make_checkpoint_name(name, epoch, step)
        path = os.path.abspath(os.path.join(output_dir, ckpt_name))
        if not self.writes:
            return path
        tmp = path + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, path)
        if meta is not None:
            with open(path + ".meta.json", "w", encoding="utf-8") as handle:
                json.dump(meta, handle, default=str, indent=2)
        self.logger.info(f"Saved checkpoint: {path}")
        return path

    def restore_checkpoint(self, path: str, map_location: Any = "cpu") -> Any:
        """Load a state tree saved by :meth:`save_checkpoint`."""
        path = os.path.abspath(path)
        state = torch.load(path, map_location=map_location, weights_only=True)
        self.logger.info(f"Restored checkpoint: {path}")
        return state

    @staticmethod
    def read_meta(path: str) -> Optional[Dict[str, Any]]:
        meta_path = os.path.abspath(path) + ".meta.json"
        if os.path.exists(meta_path):
            with open(meta_path, encoding="utf-8") as handle:
                return json.load(handle)
        return None
