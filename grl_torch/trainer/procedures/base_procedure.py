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
:meth:`BaseProcedure.chunk_runner`), and ``KVProcedure`` a single step in
a one-step graph (:meth:`BaseProcedure.step_runner`).

Every random mask of a train step (dropout, DropEdge) is drawn from the
procedure's :class:`~grl_torch.models.layers.Rngs`, seeded from
``config.seed``, as ``grl_tpu`` splits its dropout keys from
``PRNGKey(config.seed)``.
"""
from __future__ import annotations

import os
from collections import Counter
from datetime import timedelta
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from grl_torch.config import ConfigDict, instantiate
from grl_torch.models.base import count_parameters
from grl_torch.models.layers import FlaxBatchNorm, Rngs
from grl_torch.parallel import distributed
from grl_torch.parallel.mesh import (
    Mesh,
    fold_seed,
    make_mesh,
    mesh_sizes,
    replicate,
    shard_batch,
    shard_params,
    sharded_parameters,
    sharded_state_dims,
)
from grl_torch.parallel.sharded_flagship import reduce_gradients
from grl_torch.trainer import losses as losses_module
from grl_torch.trainer import lr_schedulers as lr_module
from grl_torch.trainer import optimizers as optim_module
from grl_torch.trainer.captured import CapturedSteps
from grl_torch.trainer.metrics import confusion_matrix
from grl_torch.utils.checkpoint import CheckpointHandler
from grl_torch.utils.device import DeviceLike, resolve_device
from grl_torch.utils.logging import get_logger
from grl_torch.utils.profiling import span
from grl_torch.utils.tensorboard import MetricsWriter, NullWriter

# One term of a loss made of several masked means: (mean, criterion,
# targets), the criterion's denominator read from the targets.
LossTerm = Tuple[torch.Tensor, Any, torch.Tensor]


def apply_gradients(optimizer: torch.optim.Optimizer, params, max_grad_norm: Optional[float],
                    sharded: Sequence[torch.nn.Parameter] = (), model_group=None) -> None:
    """The update after ``backward`` (and, under a mesh, after the gradients
    were summed over ``data``): a zero gradient for each parameter the loss
    did not reach (optax updates every leaf of the tree: Adam's step count
    and any weight decay advance for all of them), the global-norm clip
    where ``max_grad_norm`` is set, then the optimizer's step, the same on
    every rank. Under tensor parallelism the ``sharded`` parameters hold
    this rank's share: the squares of their gradients are summed over
    ``model_group``, so the clip sees the norm of the whole model."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if max_grad_norm:
        if sharded:
            clip_by_global_norm_sharded_(params, float(max_grad_norm), {id(p) for p in sharded}, model_group)
        else:
            optim_module.clip_by_global_norm_(params, float(max_grad_norm))
    optimizer.step()


@torch.no_grad()
def clip_by_global_norm_sharded_(params, max_norm: float, sharded, group) -> torch.Tensor:
    """:func:`~grl_torch.trainer.optimizers.clip_by_global_norm_` where the
    parameters whose ``id`` is in ``sharded`` hold one rank's share: their
    squared norms are summed over ``group`` before the norm is taken."""
    grads = [p.grad for p in params]
    squares = [torch.linalg.vector_norm(g, dtype=torch.float32) ** 2 for g in grads]
    whole = sum((sq for p, sq in zip(params, squares) if id(p) not in sharded), torch.zeros(()).to(grads[0].device))
    shares = sum((sq for p, sq in zip(params, squares) if id(p) in sharded), torch.zeros(()).to(grads[0].device))
    norm = torch.sqrt(whole + distributed.all_reduce_(shares.reshape(1), group, "tp_all_reduce")[0])
    scale = max_norm / torch.clamp(norm, min=max_norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return norm


def running_statistics(module: torch.nn.Module):
    """The running-statistics buffers of ``module``'s BatchNorm layers,
    which a train step moves."""
    return [b for layer in module.modules() if isinstance(layer, FlaxBatchNorm) for b in (layer.mean, layer.var)]


def reduce_step(mesh: Optional[Mesh], params, model: torch.nn.Module, extra: torch.Tensor) -> torch.Tensor:
    """Under a mesh with ``data`` over several ranks: every gradient of
    ``params``, ``extra`` (a flat float32 tensor of sums) and the BatchNorm
    running statistics summed over ``data`` in one ``all_reduce`` (the
    statistics then averaged, so the replicas stay equal); returns the
    summed ``extra``. Without one, ``extra`` as it is."""
    if mesh is None or mesh.axis_size("data") <= 1:
        return extra
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    stats = running_statistics(model)
    flat_extra = torch.cat([extra.reshape(-1).float()] + [b.reshape(-1).float() for b in stats])
    summed = reduce_gradients(params, flat_extra, mesh.group("data"))
    offset = extra.numel()
    for b in stats:
        b.copy_((summed[offset:offset + b.numel()] / mesh.axis_size("data")).view_as(b))
        offset += b.numel()
    return summed[:extra.numel()]


class TrainState:
    """The train state a checkpoint holds: model, optimizer and step.

    Under tensor parallelism (``mesh`` with ``model`` over several ranks)
    the checkpoint holds the whole model: :meth:`state_dict` all-gathers
    the sharded leaves and their optimizer state over ``model`` (every
    rank calls it; the first writes), and :meth:`load_state_dict` takes
    this rank's share of a whole checkpoint."""

    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer, step: int = 0,
                 mesh: Optional[Mesh] = None):
        self.model = model
        self.optimizer = optimizer
        self.step = step
        self.mesh = mesh if mesh is not None and mesh.axis_size("model") > 1 else None

    def _sharded(self) -> Dict[str, Tuple[int, Optional[int]]]:
        """Sharded state-dict names -> (dimension, optimizer index)."""
        if self.mesh is None:
            return {}
        index = {id(p): i for i, p in enumerate(p for g in self.optimizer.param_groups for p in g["params"])}
        params = dict(self.model.named_parameters())
        return {name: (dim, index.get(id(params[name])) if name in params else None)
                for name, dim in sharded_state_dims(self.model).items()}

    def _reshard(self, model_state, optimizer_state, gather: bool):
        """The sharded leaves (and their optimizer moments) all-gathered
        whole, or cut to this rank's share, in copies of the two dicts: an
        optimizer's ``state_dict`` holds its live moment dicts, which must
        keep this rank's share."""
        size, index, group = self.mesh.axis_size("model"), self.mesh.index("model"), self.mesh.group("model")

        def cut(t, dim):
            if gather:
                return distributed.all_gather(t, group, dim=dim)
            part = t.shape[dim] // size
            return t.narrow(dim, index * part, part).clone()

        model_state = dict(model_state)
        if optimizer_state is not None:
            optimizer_state = {**optimizer_state,
                               "state": {k: dict(v) for k, v in optimizer_state.get("state", {}).items()}}
        for name, (dim, opt_i) in self._sharded().items():
            if name not in model_state:
                continue
            ndim = model_state[name].dim()
            model_state[name] = cut(model_state[name], dim)
            moments = (optimizer_state or {}).get("state", {}).get(opt_i, {})
            for key, value in moments.items():
                if isinstance(value, torch.Tensor) and value.dim() == ndim:
                    moments[key] = cut(value, dim)
        return model_state, optimizer_state

    def state_dict(self) -> Dict[str, Any]:
        model_state, optimizer_state = self.model.state_dict(), self.optimizer.state_dict()
        if self.mesh is not None:
            model_state, optimizer_state = self._reshard(model_state, optimizer_state, gather=True)
        return {"model": model_state, "optimizer": optimizer_state, "step": self.step}

    def share_of(self, model_state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This rank's share of a whole model state dict (a checkpoint's):
        its sharded leaves cut as this rank holds them, names it lacks
        skipped; as it is without tensor parallelism."""
        return model_state if self.mesh is None else self._reshard(model_state, None, gather=False)[0]

    def load_state_dict(self, raw: Dict[str, Any]) -> None:
        """Restore from a checkpoint; one holding only ``model`` (converted
        weights, say) restores the weights and keeps a fresh optimizer."""
        model_state, optimizer_state = raw["model"], raw.get("optimizer")
        if self.mesh is not None:
            model_state, optimizer_state = self._reshard(model_state, optimizer_state, gather=False)
        self.model.load_state_dict(model_state)
        if optimizer_state is not None:
            self.optimizer.load_state_dict(optimizer_state)
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
        # SPMD mesh from ``config.parallel.mesh``: one process per device.
        self.mesh = self._init_mesh()
        self.is_chief = distributed.rank() == 0
        # Only the first rank of a world writes checkpoints and summaries.
        self.checkpointer = CheckpointHandler(writes=self.is_chief)

        self.seed = int(self.config.get("seed", 0))
        # config rng_impl picks grl_tpu's PRNG implementation (the TPU's
        # rbg); the port's masks come from torch generators, so it is
        # ignored here. Each rank along ``data`` draws masks of its own
        # (grl_tpu folds the axis index into the key).
        data_index = self.mesh.index("data") if self.mesh is not None and self.mesh.axis_size("data") > 1 else None
        self.rngs = Rngs.from_seed(self.seed if data_index is None else fold_seed(self.seed, data_index),
                                   self.device)

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
        ) if self.is_chief else NullWriter()
        self.state: Optional[TrainState] = None
        self._steps: Optional[CapturedSteps] = None
        self._single: Optional[CapturedSteps] = None
        # How the single train steps ran (build_train_step, KVProcedure's
        # replayed step): "eager", "replayed", and one-step graphs "recorded".
        self.single_steps: Counter = Counter()

    def _init_mesh(self) -> Optional[Mesh]:
        """The mesh of ``parallel.mesh`` over the world's processes (one per
        device; :func:`grl_torch.parallel.mesh.make_mesh`), ``None`` over one
        device, as in ``grl_tpu`` (:114-126). A mesh larger than the world
        raises, naming the launch contract. Under a mesh every rank reads
        the whole global batch and keeps its rows (:meth:`place_batch`), so
        the loaders' host shard is the whole batch, and numpy's global
        generator, which the SSL labels draw from, starts from the first
        rank's state on every rank."""
        spec = self.config.get_path("parallel.mesh")
        if not spec:
            return None
        shape = mesh_sizes({k: int(v) for k, v in dict(spec).items()}, distributed.world_size())
        if int(np.prod(list(shape.values()))) <= 1:
            return None
        timeout = self.config.get_path("parallel.distributed.timeout", distributed.DEFAULT_TIMEOUT_S)
        mesh = make_mesh(shape, timeout=timedelta(seconds=float(timeout)))
        self.config["host_id"], self.config["num_hosts"] = 0, 1
        distributed.share_numpy_state()
        self.logger.info(
            f"mesh over {mesh.size} processes: {mesh.shape}, this rank {mesh.rank} at {mesh.coords}, "
            f"backend {torch.distributed.get_backend()}"
        )
        return mesh

    @property
    def captures(self) -> bool:
        """Whether chunks of steps are captured as CUDA graphs: on the card,
        unless the world's backend is gloo, whose collectives a graph cannot
        capture (chosen from the backend, up front)."""
        return self.device.type == "cuda" and not (self.mesh is not None
                                                   and torch.distributed.get_backend() == "gloo")

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
        """The model's optimizer and step. Under a mesh the replicas start
        from the first rank's parameters (broadcast), and the leaves of the
        tensor-parallel rules are cut to this rank's share
        (:func:`grl_torch.parallel.mesh.shard_params`) before the optimizer
        is made; a checkpoint loads whole on every rank and is cut the
        same way."""
        self.logger.info(
            f"Num parameters of {self.model.__class__.__name__}: "
            f"{count_parameters(self.model):,}"
        )
        if self.mesh is not None:
            replicate(self.model)
            self.placement = shard_params(self.model, self.mesh)
        params = [p for p in self.model.parameters() if p.requires_grad]
        # The leaves this rank holds a share of, and the group of the shares.
        self.sharded = sharded_parameters(self.model) if self.mesh is not None else []
        self.model_group = self.mesh.group("model") if self.mesh is not None else None
        self.state = TrainState(self.model, self.optimizer_factory.make(params), mesh=self.mesh)
        self._load_prev_checkpoint(self.state)
        self._steps = None
        return self.state

    def chunk_runner(self) -> CapturedSteps:
        """The runner of this state's chunks of steps (``scan_steps``), made
        at first use: its graphs capture this state's model and optimizer
        and register the generator of ``self.rngs`` as it is then."""
        if self._steps is None:
            self._steps = CapturedSteps(self.device, [self.rngs.device], capture=self.captures)
            self._single = self._steps.sharing()
        return self._steps

    def step_runner(self) -> CapturedSteps:
        """The runner of this state's single train steps, one graph a batch
        shape (:meth:`KVProcedure._replayed_step
        <grl_torch.trainer.procedures.kv_procedure.KVProcedure._replayed_step>`),
        made with the chunk runner, on its stream and in its memory pool; its
        replays are not the chunk runner's."""
        self.chunk_runner()
        return self._single

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

        def body(V, A, labels, rngs: Rngs, lam):
            model.train()
            state.optimizer.zero_grad(set_to_none=True)
            logits = model((V, A), rngs=rngs, lambda_value=lam)
            if logits.dim() == labels.dim():
                # The sparse path: flat (B*N, C) logits -> (B, N, C).
                logits = logits.reshape(*labels.shape, -1)
            loss = criterion(logits, labels)
            preds = logits.detach().argmax(dim=-1)
            cm = confusion_matrix(preds, labels, num_classes, ignore_values)
            loss, summed = self.update([(loss, criterion, labels)], params, cm.reshape(-1).float())
            return loss, summed.reshape(cm.shape).to(cm.dtype)

        return body

    def update(self, terms: Sequence[LossTerm], params,
               extra: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Backward of the sum of ``terms``, then the update
        (:func:`apply_gradients`); returns the summed loss and ``extra`` (a
        flat float32 tensor of sums, e.g. confusion counts) as the whole
        world's. Each term is ``(loss, criterion, targets)``: a masked mean
        and what its :func:`~grl_torch.trainer.losses.denominator` is read
        from. With ``data`` over several ranks each holds its rows of the
        global batch, and a term's global mean is the sum over ranks of its
        summed loss (``loss`` times its denominator) over the summed
        denominator:

        * one term: each rank's summed loss goes backward; the gradients,
          the sums, the denominators and ``extra`` are summed over ``data``
          in one ``all_reduce`` (:func:`reduce_step`), and the gradients are
          divided by the summed denominator before the clip;
        * several (the self-supervised tasks, the joint KV and task losses):
          the denominators, which the targets alone give, are summed first
          in one small ``all_reduce``; each rank's summed losses over their
          global denominators go backward, and the gradients, the summed
          losses and ``extra`` are summed in the one flat ``all_reduce``,
          with no division after it.

        Either way every rank applies the gradient of the single-device
        step."""
        extra = torch.zeros(0, device=terms[0][0].device) if extra is None else extra
        mesh = self.mesh
        if mesh is None or mesh.axis_size("data") <= 1:
            loss = terms[0][0]
            for term, _, _ in terms[1:]:
                loss = loss + term
            loss.backward()
            apply_gradients(self.state.optimizer, params, self.max_grad_norm, self.sharded, self.model_group)
            return loss.detach(), extra
        if len(terms) == 1:
            (loss, criterion, targets), = terms
            denominator = losses_module.denominator(criterion, targets)
            rank_sum = loss * denominator.clamp(min=1.0)
            rank_sum.backward()
            summed = reduce_step(mesh, params, self.model,
                                 torch.cat([rank_sum.detach().reshape(1).float(), denominator.reshape(1), extra]))
            total = summed[1].clamp(min=1.0)
            for p in params:
                p.grad.div_(total)
            apply_gradients(self.state.optimizer, params, self.max_grad_norm, self.sharded, self.model_group)
            return summed[0] / total, summed[2:]
        denominators = torch.stack([losses_module.denominator(criterion, targets) for _, criterion, targets in terms])
        totals = distributed.all_reduce_(denominators.clone(), mesh.group("data"),
                                         "denominator all_reduce").clamp(min=1.0)
        rank_sums = torch.stack([loss.reshape(()) * d.clamp(min=1.0) for (loss, _, _), d in zip(terms, denominators)])
        (rank_sums / totals).sum().backward()
        summed = reduce_step(mesh, params, self.model, torch.cat([rank_sums.detach().float(), extra]))
        apply_gradients(self.state.optimizer, params, self.max_grad_norm, self.sharded, self.model_group)
        return (summed[:len(terms)] / totals).sum(), summed[len(terms):]

    def data_sum(self, values: torch.Tensor, kind: str) -> torch.Tensor:
        """``values`` summed over ``data`` (in place), where the axis spans
        several ranks; else as they are."""
        if self.mesh is None or self.mesh.axis_size("data") <= 1:
            return values
        return distributed.all_reduce_(values, self.mesh.group("data"), kind)

    def reduce_eval(self, loss: torch.Tensor, cm: torch.Tensor, criterion: Any,
                    labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """An eval batch's masked-mean ``loss`` and confusion counts ``cm``
        of this rank's rows as the global batch's, the same on every rank:
        the summed loss, the denominator and the counts summed over
        ``data`` in one ``all_reduce``. Without such a mesh, as they are."""
        if self.mesh is None or self.mesh.axis_size("data") <= 1:
            return loss, cm
        denominator = losses_module.denominator(criterion, labels)
        summed = self.data_sum(torch.cat([(loss * denominator.clamp(min=1.0)).reshape(1), denominator.reshape(1),
                                          cm.reshape(-1).float()]), "eval all_reduce")
        return summed[0] / summed[1].clamp(min=1.0), summed[2:].reshape(cm.shape).to(cm.dtype)

    def build_train_step(self, num_classes: int, ignore_values: Tuple[int, ...]) -> Callable:
        """``train_step(V, A, labels, rngs, lam) -> (loss, cm)``: one
        optimizer step run eagerly on the device (:meth:`build_train_body`),
        counted in ``state.step`` and as ``single_steps["eager"]``; ``loss``
        and ``cm`` stay there. Its enqueue (forward, autograd's backward,
        clip, update) is the span ``grl.step.eager``. Where chunks are
        captured, ``KVProcedure`` replays its steps from one-step graphs
        instead (:meth:`~grl_torch.trainer.procedures.kv_procedure.KVProcedure._replayed_step`)."""
        body, state = self.build_train_body(num_classes, ignore_values), self.state

        def train_step(V, A, labels, rngs: Rngs, lam):
            with span("grl.step.eager"):
                out = body(V, A, labels, rngs, lam)
                state.step += 1
                self.single_steps["eager"] += 1
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
            cm = confusion_matrix(preds, labels, num_classes, ignore_values)
            loss, cm = self.reduce_eval(loss, cm, criterion, labels)
            return loss, cm, preds

        return eval_step

    # ------------------------------------------------------------------
    # Batch placement
    # ------------------------------------------------------------------
    def place_batch(self, arrays: Dict[str, np.ndarray],
                    pad_values: Optional[Dict[str, Any]] = None) -> Dict[str, np.ndarray]:
        """Under a mesh, this rank's rows of a host batch (``grl_tpu``'s
        :161-180): the batch dimension padded to a multiple of ``data``
        (``pad_values`` per array, e.g. -100 labels so the masked loss and
        metrics drop the rows; 0 elsewhere) and split evenly, in axis order
        (:func:`grl_torch.parallel.mesh.shard_batch`). Without one, the
        batch as it is."""
        if self.mesh is None:
            return arrays
        d = self.mesh.axis_size("data")
        B = next(iter(arrays.values())).shape[0]
        pad = (-B) % d
        if pad:
            pad_values = pad_values or {}
            arrays = {k: np.concatenate([v, np.full((pad, *v.shape[1:]), pad_values.get(k, 0), v.dtype)])
                      for k, v in arrays.items()}
        return shard_batch(arrays, self.mesh)

    # ------------------------------------------------------------------
    def _init_dataloaders(self):
        raise NotImplementedError

    def __call__(self):
        raise NotImplementedError
