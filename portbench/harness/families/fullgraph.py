"""Full-batch training on one large graph: ``FullGraphProcedure``.

Inputs: the configuration's SBM graph (:mod:`portbench.reference.sbm`)
made from the seed, handed to the procedure as ``LargeGraphData``, and the
weights (:mod:`portbench.harness.weights`). Set-up builds the procedure
(which plans the configured kernel once) and runs the check's chunks: two
chunks of ``scan_steps`` through ``train_steps``, the first eager (the
warm-up), the second captured and then replayed, each followed by
``eval_step``, exactly as the window runs them. It keeps what the output
check compares: every step's loss, the first step's logits and gradient,
the parameters and the state of the generator of masks after both. The
window runs ``train_steps(scan_steps)`` chunks, each followed by
``eval_step(val_labels)``, as ``FullGraphProcedure.__call__`` runs them
(every chunk of 10 crosses a multiple of 10 steps), reading the chunk's
losses and the accuracy back as ``__call__`` does.
"""
from __future__ import annotations

import math
import os
import time
from typing import Dict, Optional

import numpy as np

from portbench.harness import check
from portbench.harness.families.common import TrainingFamily, bound_seconds, first_step_taps, parameters
from portbench.harness.weights import derive, make_weights
from portbench.reference.sbm import sbm_graph


def import_program() -> None:
    """The program's modules this family drives, imported in the import
    phase of set-up."""
    import grl_torch.data.large_graph  # noqa: F401
    import grl_torch.models  # noqa: F401
    import grl_torch.trainer.procedures.full_graph_procedure  # noqa: F401
    import grl_torch.ops.launches  # noqa: F401


class Family(TrainingFamily):
    def __init__(self, torch, cell, seed: int, device, workdir: str):
        super().__init__(torch, cell, seed, device, workdir)
        self.counts["evals"] = 0

    # ------------------------------------------------------------------
    def make_inputs(self) -> None:
        torch = self.torch
        self.graph = sbm_graph(**self.config["graph"], seed=derive(self.seed, "graph") % 2**32)
        self.weights = make_weights(torch, self.ref.leaves(self.config["model"]), self.seed, self.device)
        self.program_seed = derive(self.seed, "program")

    def build(self) -> None:
        from grl_torch.data.large_graph import LargeGraphData
        from grl_torch.trainer.procedures.full_graph_procedure import FullGraphProcedure

        g, cfg = self.graph, self.config
        data = LargeGraphData(features=g["features"], labels=g["labels"], senders=g["senders"],
                              receivers=g["receivers"], relations=g["relations"], weights=g["weights"],
                              train_mask=g["train_mask"], val_mask=g["val_mask"],
                              num_classes=cfg["graph"]["num_classes"], num_relations=cfg["graph"]["num_relations"])
        model = self.build_model()
        self.mark("model")
        procedure_config = {
            "seed": self.program_seed, "output_dir": os.path.join(self.workdir, "out"),
            "scan_steps": cfg["scan_steps"], "kernel_plan": cfg["kernel_plan"],
            "optimizer": {"type": "BuiltinOptimizer", "args": cfg["optimizer"]},
            "max_grad_norm": cfg["max_grad_norm"], "num_epochs": cfg.get("num_epochs", 200),
            "logging": {"use_tensorboard": False, "summary_dir_name": "summary"},
        }
        self.proc = FullGraphProcedure(model, procedure_config, data=data, device=self.device)
        self.proc._ensure_initialized()
        self.edges = self.proc.num_edges()
        self.shape = self.cell.cost.shape(self.config, nodes=len(g["features"]), edges=self.edges)
        self.step_cost = self.cell.cost.train_step(self.shape)
        self.eval_cost = self.cell.cost.eval_step(self.shape)
        # The operations whose work the configuration counts (and whose
        # kernels portbench/kernels/<operation>/ names).
        self.operations = tuple(self.step_cost["ops"])

    def check_chunks(self, phases) -> None:
        """The check's two chunks, as the window runs them: the first eager
        (the warm-up, tapped for the first step), the second captured and
        replayed. Every shape the window uses is then warm."""
        proc, program = self.proc, {}
        with first_step_taps(proc.model, proc.state.optimizer, program):
            losses, _ = self._chunk(self.K)
        self.sync()
        phases.mark("warmup")
        more, accuracy = self._chunk(self.K)
        self.sync()
        phases.mark("capture")
        self.program = {**program, "losses": [float(v) for v in (*losses, *more)], "params": parameters(proc.model),
                        "accuracy": float(accuracy), "draws_state": self.draws_state()}

    def setup(self, phases) -> None:
        self.phases = phases
        self.make_inputs()
        phases.mark("inputs")
        self.build()
        phases.mark("plan")
        self.check_chunks(phases)

    # ------------------------------------------------------------------
    def _count(self, steps: int, evals: int) -> None:
        c = self.counts
        c["steps"] += steps
        c["evals"] += evals
        c["model_flops"] = c.get("model_flops", 0.0) + steps * self.step_cost["flops"] + evals * self.eval_cost["flops"]
        for op in self.operations:
            dtype = self.config["model"]["compute_dtype"]
            key = f"bound_s.{op}"
            c[key] = c.get(key, 0.0) + steps * bound_seconds(self.step_cost["ops"][op], dtype) \
                + evals * bound_seconds(self.eval_cost["ops"][op], dtype)

    def _chunk(self, K: int, tracer=None):
        """A chunk of ``K`` steps and its eval; the losses and the accuracy,
        read back."""
        proc = self.proc
        losses = proc.train_steps(K)
        span = tracer.span("eval") if tracer is not None else _nothing()
        with span:
            acc = proc.eval_step(proc.val_labels)
        values = self.torch.stack(losses).float().cpu().numpy()
        accuracy = float(acc)
        self.counts["failed"] += int((~np.isfinite(values)).sum())
        self._count(K, 1)
        return values, accuracy

    def window(self, seconds: float, tracer) -> Dict[str, float]:
        K = self.K
        start_steps, start_failed = self.counts["steps"], self.counts["failed"]
        t0 = time.perf_counter()
        while True:
            tracer.boundary(self.counters())
            self._chunk(K, tracer)
            if time.perf_counter() - t0 >= seconds:
                break
        self.sync()
        elapsed = time.perf_counter() - t0
        tracer.boundary(self.counters(), closing=True)
        steps = self.counts["steps"] - start_steps
        self.attempted, self.failed = steps, self.counts["failed"] - start_failed
        return {"fullgraph_edges_per_s": self.edges * steps / elapsed, "_window_s": elapsed, "_steps": steps}

    # ------------------------------------------------------------------
    def reference_inputs(self, fault: Optional[str] = None):
        """The graph in the node order the configuration's plan implies,
        worked out again from the edges, with its training and validation
        labels; ``fault="half_batch"`` leaves the second half of the training
        nodes (in node order) out of the loss."""
        torch, g, cfg, ref = self.torch, self.graph, self.config, self.ref
        N, L = len(g["features"]), cfg["graph"]["num_relations"]
        plan = cfg["kernel_plan"]
        if plan.get("reorder") == "degree" and L == 1:
            perm = ref.degree_order(g["receivers"], N, plan.get("width_quantum", 4), plan.get("bucket_growth", 2))
        else:
            perm = np.arange(N)
        x = np.zeros_like(g["features"])
        x[perm] = g["features"]
        train = np.full(N, -100, np.int64)
        val = np.full(N, -100, np.int64)
        train[perm] = np.where(g["train_mask"], g["labels"], -100)
        val[perm] = np.where(g["val_mask"], g["labels"], -100)
        if fault == "half_batch":
            labelled = np.flatnonzero(train != -100)
            train[labelled[len(labelled) // 2:]] = -100

        def put(a, dtype):
            return torch.as_tensor(a, dtype=dtype, device=self.device)

        graph = ref.SparseGraph(senders=put(perm[g["senders"]], torch.int64),
                                receivers=put(perm[g["receivers"]], torch.int64),
                                relations=put(g["relations"], torch.int64), weights=put(g["weights"], torch.float32),
                                gid=put(np.arange(len(g["senders"])), torch.int64), num_nodes=N, num_relations=L)
        return put(x, torch.float32), graph, put(train, torch.int64), put(val, torch.int64)

    def reference_run(self, rounding: str = "float32", fault: Optional[str] = None) -> Dict:
        """The reference's steps of the check's two chunks (in ``rounding``,
        with ``fault`` planted where one is named), from the weights and the
        seed. ``fault="per_step"``: each chunk's steps all draw the masks of
        its first step, as a chunk that reused one offset of the generator
        would."""
        ref = self.ref
        ref.plain_float32()
        x, graph, train, val = self.reference_inputs(fault)
        net = ref.network(self.config["model"], rounding)
        draws = ref.Draws(self.program_seed, self.device)
        held = {}

        def on_step(t):
            if (t - 1) % self.K == 0:
                held["state"] = draws.generator.get_state()
            else:
                draws.generator.set_state(held["state"])

        steps = ref.train_steps(net, self.weights, [(x, graph, train)] * (2 * self.K), draws,
                                lr=self.config["optimizer"]["lr"], max_grad_norm=self.config["max_grad_norm"],
                                on_step=on_step if fault == "per_step" else None)
        return {"losses": steps.losses, "first_grad": steps.first_grad, "params": steps.params,
                "first_logits": steps.first_logits, "draws_state": steps.draws_state,
                "accuracy": ref.accuracy(net, steps.params, x, graph, val)}

    def numbers(self, program: Dict, reference: Dict) -> Dict[str, float]:
        out = check.training_numbers(program, reference, self.weights)
        out["eval_gap"] = abs(program["accuracy"] - reference["accuracy"])
        if not math.isfinite(program["accuracy"]):
            out["eval_gap"] = math.inf
        return out


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
