"""API facade: ``GNNLearningWarper`` — train or predict from a config.

Counterpart of ``grl_tpu/warper.py``: loads the YAML config, builds the
model from the registry (parameters drawn from a ``torch.Generator``
seeded by ``config.seed``) and instantiates the configured procedure —
a training procedure (``KVProcedure``) when ``is_train`` is true, an
inference procedure (``KVInference``) otherwise — and exposes
``.train()`` / ``.predict(samples)``. Before the model is built it starts
the process group where one is configured
(:func:`grl_torch.parallel.distributed.initialize_distributed`, the
``GRL_*`` launch contract, ``grl_tpu/warper.py:55-59``): N processes
started with ``GRL_COORDINATOR_ADDRESS`` / ``GRL_NUM_PROCESSES`` /
``GRL_PROCESS_ID`` and a ``parallel.mesh`` over N devices train one model,
each on its own card (or on the CPU with ``device="cpu"``). Only the first
rank keeps the experiment-tracking series.
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
        from grl_torch.parallel.distributed import initialize_distributed

        host_id, _, _ = initialize_distributed(self.config, device)
        self.device = resolve_device(device)
        self.seed = int(self.config.get("seed", 0))

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

        self.trainer = None
        self.inferencer = None
        if self.config.get("is_train", True):
            from grl_torch.trainer import procedures
            from grl_torch.utils.experiment import ExperimentRun

            # Experiment-tracking handle threaded into the procedure
            # (reference: cl_warper.py:52-53 passes the global NEPTUNE_RUN).
            ems_exp = None
            if self.config.get_path("logging.experiment_tracking", True) and host_id == 0:
                ems_exp = ExperimentRun(output_dir)
            proc = self.config.get("procedure", {"type": "KVProcedure", "args": {}})
            cls = getattr(procedures, proc["type"])
            self.trainer = cls(
                self.model, self.config, ems_exp=ems_exp, device=self.device,
                **dict(proc.get("args", {}) or {}),
            )
        else:
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

    def train(self) -> Any:
        """Run the configured training procedure; returns its final metric."""
        if self.trainer is None:
            raise RuntimeError("Warper was built with is_train=False.")
        return self.trainer()

    def predict(self, samples: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        """Run the configured inference procedure on raw samples."""
        if self.inferencer is None:
            raise RuntimeError("Warper was built with is_train=True.")
        return self.inferencer(samples)
