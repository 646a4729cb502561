"""Base training procedure: state, train/eval steps, registries, checkpoints.

Counterpart of ``grl_tpu/trainer/procedures/base_procedure.py`` (:52-352).
``grl_tpu`` keeps an explicit ``TrainState`` pytree and jits one step
function over it; here the train state is the module, its optimizer and
a step count (:class:`TrainState`), and a step runs eagerly: forward →
criterion → backward → global-norm clip → optimizer → ``argmax`` →
confusion matrix, all enqueued on the device without a host sync. The
step's device work (:meth:`BaseProcedure.build_train_body`) reads nothing
back and counts nothing on the host, so that ``scan_steps`` can capture a
chunk of steps in a CUDA graph (:mod:`grl_torch.trainer.captured`,
:meth:`BaseProcedure.chunk_runner`).

Every random mask of a train step (dropout, DropEdge) is drawn from the
procedure's :class:`~grl_torch.models.layers.Rngs`, seeded from
``config.seed``, as ``grl_tpu`` splits its dropout keys from
``PRNGKey(config.seed)``.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from grl_torch.config import ConfigDict, instantiate
from grl_torch.models.base import count_parameters
from grl_torch.models.layers import Rngs
from grl_torch.trainer import losses as losses_module
from grl_torch.trainer import lr_schedulers as lr_module
from grl_torch.trainer import optimizers as optim_module
from grl_torch.trainer.captured import CapturedSteps
from grl_torch.trainer.metrics import confusion_matrix
from grl_torch.utils.checkpoint import CheckpointHandler
from grl_torch.utils.device import DeviceLike, resolve_device
from grl_torch.utils.logging import get_logger
from grl_torch.utils.tensorboard import MetricsWriter


def apply_gradients(optimizer: torch.optim.Optimizer, params, max_grad_norm: Optional[float]) -> None:
    """The update after ``backward``: a zero gradient for each parameter the
    loss did not reach (optax updates every leaf of the tree: Adam's step
    count and any weight decay advance for all of them), the global-norm
    clip where ``max_grad_norm`` is set, then the optimizer's step."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if max_grad_norm:
        optim_module.clip_by_global_norm_(params, float(max_grad_norm))
    optimizer.step()


class TrainState:
    """The train state a checkpoint holds: model, optimizer and step."""

    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer, step: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.step = step

    def state_dict(self) -> Dict[str, Any]:
        return {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "step": self.step,
        }

    def load_state_dict(self, raw: Dict[str, Any]) -> None:
        """Restore from a checkpoint; one holding only ``model`` (converted
        weights, say) restores the weights and keeps a fresh optimizer."""
        self.model.load_state_dict(raw["model"])
        if "optimizer" in raw:
            self.optimizer.load_state_dict(raw["optimizer"])
            optim_module.match_device(self.optimizer)
        self.step = int(raw.get("step", 0))


class BaseProcedure:
    """Shared setup: output dirs, criterion/optimizer/scheduler registries,
    checkpoint restore, train/eval step factories."""

    def __init__(self, model: torch.nn.Module, config: ConfigDict,
                 ems_exp: Optional[Any] = None, device: DeviceLike = None, **kwargs: Any):
        self.logger = get_logger(self.__class__.__name__)
        self.config = ConfigDict(config)
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        # Experiment-tracking run with a Neptune-shaped append API.
        self.ems_exp = ems_exp
        self.model_dir = os.path.join(
            self.config.get("output_dir", "./outputs"),
            self.config.get("model_dir_name", "models"),
        )
        os.makedirs(self.model_dir, exist_ok=True)
        self.checkpointer = CheckpointHandler()

        self.seed = int(self.config.get("seed", 0))
        # config rng_impl picks grl_tpu's PRNG implementation (the TPU's
        # rbg); the port's masks come from torch generators, so it is
        # ignored here.
        self.rngs = Rngs.from_seed(self.seed, self.device)

        self.criterion = self._init_criterion()
        self.optimizer_factory = self._init_optimizer()
        self.lr_scheduler = self._init_lr_scheduler()
        self.max_grad_norm = self.config.get("max_grad_norm")

        summary_dir = os.path.join(
            self.config.get("output_dir", "./outputs"),
            self.config.get_path("logging.summary_dir_name", "summary"),
        )
        self.tb_writer = MetricsWriter(
            summary_dir,
            enable_tensorboard=bool(self.config.get_path("logging.use_tensorboard", True)),
        )
        self.state: Optional[TrainState] = None
        self._steps: Optional[CapturedSteps] = None
        self._check_mesh()

    def _check_mesh(self) -> None:
        """``parallel.mesh`` over one device is a no-op, as in ``grl_tpu``
        (:114-126); more devices are slice 4 of the port."""
        spec = self.config.get_path("parallel.mesh")
        if not spec:
            return
        devices = torch.cuda.device_count() if self.device.type == "cuda" else 1
        sizes = [int(v) for v in dict(spec).values()]
        known = int(np.prod([s for s in sizes if s != -1]))
        total = known * (devices // known if -1 in sizes else 1)
        if total > 1:
            raise NotImplementedError(
                f"parallel.mesh {dict(spec)} spans {total} devices; multi-device "
                "training arrives with ROADMAP.md Queue 1, slice 4."
            )

    @classmethod
    def _from_config(cls, model: Any, config: ConfigDict, **kwargs: Any) -> "BaseProcedure":
        return cls(model, config, **kwargs)

    # ------------------------------------------------------------------
    # Registry init (reference: base_procedure.py:95-138)
    # ------------------------------------------------------------------
    def _init_criterion(self):
        spec = self.config.get("loss", {"type": "CrossEntropyLoss", "args": {}})
        criterion = instantiate(losses_module, spec)
        self.logger.info(f"Loss type: {criterion.__class__.__name__}")
        return criterion

    def _init_optimizer(self):
        spec = self.config.get(
            "optimizer",
            {"type": "BuiltinOptimizer", "args": {"type_optimizer": "Adam", "lr": 1e-3}},
        )
        optimizer = instantiate(optim_module, spec)
        self.logger.info(f"Optimizer type: {optimizer.type_optimizer}")
        return optimizer

    def _init_lr_scheduler(self):
        spec = self.config.get("lr_scheduler")
        if not spec or not spec.get("type"):
            return lr_module.ConstantLearningRate(self.optimizer_factory.learning_rate)
        scheduler = instantiate(lr_module, spec)
        self.logger.info(f"LR scheduler type: {scheduler.__class__.__name__}")
        return scheduler

    # ------------------------------------------------------------------
    # State lifecycle
    # ------------------------------------------------------------------
    def init_state(self) -> TrainState:
        params = [p for p in self.model.parameters() if p.requires_grad]
        self.logger.info(
            f"Num parameters of {self.model.__class__.__name__}: "
            f"{count_parameters(self.model):,}"
        )
        self.state = TrainState(self.model, self.optimizer_factory.make(params))
        self._load_prev_checkpoint(self.state)
        self._steps = None
        return self.state

    def chunk_runner(self) -> CapturedSteps:
        """The runner of this state's chunks of steps (``scan_steps``), made
        at first use: its graphs capture this state's model and optimizer
        and register the generator of ``self.rngs`` as it is then."""
        if self._steps is None:
            self._steps = CapturedSteps(self.device, [self.rngs.device])
        return self._steps

    def _load_prev_checkpoint(self, state: TrainState) -> TrainState:
        path = self.config.get("checkpoint_path")
        if not path and self.config.get("resume", False):
            # Auto-resume from this run's latest checkpoint: model,
            # optimizer and step.
            candidate = os.path.join(self.model_dir, CheckpointHandler.LATEST)
            if os.path.exists(candidate):
                path = candidate
        if path:
            self.logger.info("Restoring pretrained checkpoint ...")
            state.load_state_dict(self.checkpointer.restore_checkpoint(path, map_location=self.device))
            self.logger.info("Loading pretrained model success!")
        return state

    def _update_learning_rate(self, epoch: int, step: int) -> float:
        """Per-epoch LR write into the optimizer (reference:
        base_procedure.py:172-185)."""
        lr = self.lr_scheduler._step_lr(epoch, step)
        optim_module.set_learning_rate(self.state.optimizer, lr)
        return lr

    # ------------------------------------------------------------------
    # Steps
    # ------------------------------------------------------------------
    def build_train_body(self, num_classes: int, ignore_values: Tuple[int, ...]) -> Callable:
        """``body(V, A, labels, rngs, lam) -> (loss, cm)``: one optimizer
        step's device work; ``loss`` and ``cm`` stay on the device, and the
        host reads nothing and counts nothing (``lam`` is a float or a device
        scalar), so a CUDA graph can capture it."""
        model, criterion, state = self.model, self.criterion, self.state
        params = [p for group in state.optimizer.param_groups for p in group["params"]]
        max_grad_norm = self.max_grad_norm

        def body(V, A, labels, rngs: Rngs, lam):
            model.train()
            state.optimizer.zero_grad(set_to_none=True)
            logits = model((V, A), rngs=rngs, lambda_value=lam)
            if logits.dim() == labels.dim():
                # The sparse path: flat (B*N, C) logits -> (B, N, C).
                logits = logits.reshape(*labels.shape, -1)
            loss = criterion(logits, labels)
            loss.backward()
            apply_gradients(state.optimizer, params, max_grad_norm)
            preds = logits.detach().argmax(dim=-1)
            return loss.detach(), confusion_matrix(preds, labels, num_classes, ignore_values)

        return body

    def build_train_step(self, num_classes: int, ignore_values: Tuple[int, ...]) -> Callable:
        """``train_step(V, A, labels, rngs, lam) -> (loss, cm)``: one
        optimizer step on the device (:meth:`build_train_body`), counted in
        ``state.step``; ``loss`` and ``cm`` stay there."""
        body, state = self.build_train_body(num_classes, ignore_values), self.state

        def train_step(V, A, labels, rngs: Rngs, lam):
            out = body(V, A, labels, rngs, lam)
            state.step += 1
            return out

        return train_step

    def build_eval_step(self, num_classes: int, ignore_values: Tuple[int, ...]) -> Callable:
        """``eval_step(V, A, labels, lam) -> (loss, cm, preds)``."""
        model, criterion = self.model, self.criterion

        def eval_step(V, A, labels, lam: float):
            model.eval()
            with torch.no_grad():
                logits = model((V, A), lambda_value=lam)
                if logits.dim() == labels.dim():
                    logits = logits.reshape(*labels.shape, -1)
                loss = criterion(logits, labels)
            preds = logits.argmax(dim=-1)
            return loss, confusion_matrix(preds, labels, num_classes, ignore_values), preds

        return eval_step

    # ------------------------------------------------------------------
    def _init_dataloaders(self):
        raise NotImplementedError

    def __call__(self):
        raise NotImplementedError
