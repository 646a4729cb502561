"""API facade: ``GNNLearningWarper`` — predict from a config.

Counterpart of ``grl_tpu/warper.py``: loads the YAML config, builds the
model from the registry (parameters drawn from a ``torch.Generator``
seeded by ``config.seed``) and instantiates the configured procedure.
This slice has the inference branch; ``is_train: true`` raises until the
training slice lands.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Union

import torch

from grl_torch.config import ConfigDict, load_config
from grl_torch.utils.device import DeviceLike, resolve_device
from grl_torch.utils.logging import get_logger


class GNNLearningWarper:
    def __init__(
        self,
        model: Optional[torch.nn.Module] = None,
        config_path: Optional[str] = None,
        config: Optional[Union[ConfigDict, Dict[str, Any]]] = None,
        device: DeviceLike = None,
    ):
        """Wrap the graph-learning lifecycle behind one object.

        Args:
            model: a network of :mod:`grl_torch.models`; if ``None``, built
                from ``config.model`` via the registry on ``device``.
            config_path: path to a YAML config file.
            config: alternatively, an already-loaded config.
            device: where the model runs; ``None`` means CUDA and raises
                ``RuntimeError`` when no GPU is available.
        """
        if not config_path and config is None:
            raise ValueError("GNNLearningWarper needs config_path or config.")
        self.config = load_config(config_path) if config_path else ConfigDict(config)
        self.logger = get_logger(__name__)
        self.device = resolve_device(device)
        self.seed = int(self.config.get("seed", 0))

        if self.config.get("is_train", True):
            raise NotImplementedError(
                "Training (KVProcedure, kernels K1/K2, optimizer stack) arrives "
                "with the training slice (ROADMAP.md Queue 1, item 5); "
                "set is_train: false to serve."
            )

        if model is None and "model" in self.config:
            from grl_torch.models import create_model

            spec = self.config.model
            model = create_model(
                spec["type"],
                device=self.device,
                generator=torch.Generator().manual_seed(self.seed),
                **dict(spec.get("args", {})),
            )
        self.model = model

        output_dir = os.path.join(
            self.config.get("output_dir", "./outputs"),
            self.config.get("experiment_name", "experiment"),
        )
        os.makedirs(output_dir, exist_ok=True)
        self.config["output_dir"] = output_dir

        from grl_torch.inferencer import inference_procedures

        proc = self.config.get("procedure", {"type": "KVInference", "args": {}})
        cls = getattr(inference_procedures, proc["type"])
        self.inferencer = cls(
            self.model, self.config, device=self.device, **dict(proc.get("args", {}) or {})
        )

    @staticmethod
    def _from_config(config_path: str) -> ConfigDict:
        """Load a YAML config (reference: cl_warper.py:62-79)."""
        return load_config(config_path)

    def predict(self, samples: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        """Run the configured inference procedure on raw samples."""
        return self.inferencer(samples)
