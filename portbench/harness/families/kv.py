"""KV node-classification training on a corpus held on the card:
``KVProcedure.run_chunk``.

Inputs: the traffic's pages (box counts from the traffic file, contents
from the seed) by a frozen copy of the page generator, written as
cassia-format files with their classes and charset, and the weights
(:mod:`portbench.harness.weights`). Set-up builds ``KVProcedure`` on those
files (``shuffle: false``), encodes every page once through the program's
own chain (``TextlineEncoding`` → ``HeuristicGraphBuilder`` →
``NodeLabeling`` → ``BucketPadding``, batches of 8) and holds the
batches on the card in the compute dtype (``_host_batch``). It then runs
the check's chunks, two chunks of ``scan_steps`` distinct batches of the
shape with the most batches through ``run_chunk``, the first eager (the
warm-up), the second captured and replayed, keeping what the output check
compares; then, for every other shape, one chunk eagerly and one captured,
and one eager step where the shape leaves leftovers.

The window runs epochs over the held batches in an order drawn from the
seed, grouped as ``_train_epoch_scanned`` groups them: a chunk of
``scan_steps`` batches of one shape through ``run_chunk`` as soon as one
is full, the leftovers of each shape stepped eagerly at the epoch's end
through the procedure's step. It does the procedure's host work of each
step as that loop does: the lambda schedule, each step's scores from its
confusion matrix logged, and the checkpoint opportunity after each chunk
and each epoch.
"""
from __future__ import annotations

import json
import math
import os
import time
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from portbench.harness import check
from portbench.harness.families.common import TrainingFamily, bound_seconds, first_step_taps, parameters
from portbench.harness.weights import derive, make_weights
from portbench.reference import kv_chain
from portbench.reference.pages import charset_of, class_names, rows_for, synthetic_page

def page_sizes(traffic: Dict) -> List[int]:
    """The box count of each page: the traffic's ``boxes`` (a number), or
    a lognormal (``median``, ``sigma``, clipped to ``min``..``max``) drawn
    once from the traffic's own ``size_seed``, so that every run's seed
    gives the same pages' sizes, and so the same batch shapes."""
    count, boxes = int(traffic["pages"]), traffic["boxes"]
    if isinstance(boxes, int):
        return [boxes] * count
    rng = np.random.RandomState(int(boxes["size_seed"]))
    drawn = boxes["median"] * np.exp(boxes["sigma"] * rng.randn(count))
    return [int(v) for v in np.clip(np.rint(drawn), boxes["min"], boxes["max"])]


def import_program() -> None:
    """The program's modules this family drives, imported in the import
    phase of set-up."""
    import grl_torch.models  # noqa: F401
    import grl_torch.trainer.procedures.kv_procedure  # noqa: F401
    import grl_torch.utils.metric_tracker  # noqa: F401
    import grl_torch.ops.launches  # noqa: F401
    import grl_torch.data.native  # noqa: F401


class Family(TrainingFamily):
    def __init__(self, torch, cell, seed: int, device, workdir: str):
        super().__init__(torch, cell, seed, device, workdir)
        self.counts.update(eager_steps=0, pages=0)

    # ------------------------------------------------------------------
    def make_inputs(self) -> None:
        data = self.config["data"]
        base = derive(self.seed, "pages")
        self.pages = [synthetic_page(base + i, *rows_for(n), classes=class_names(data["classes"]))
                      for i, n in enumerate(page_sizes(self.traffic))]
        self.classes = class_names(data["classes"])
        self.charset = charset_of(self.pages, data["charset"])
        folder = os.path.join(self.workdir, "pages")
        os.makedirs(folder, exist_ok=True)
        for i, page in enumerate(self.pages):
            with open(os.path.join(folder, f"page_{i:05d}.json"), "w") as handle:
                json.dump(page, handle)
        with open(os.path.join(self.workdir, "classes.json"), "w") as handle:
            json.dump({"classes": self.classes}, handle)
        with open(os.path.join(self.workdir, "charset.json"), "w") as handle:
            json.dump({"charset": self.charset}, handle)
        self.weights = make_weights(self.torch, self.ref.leaves(self.config["model"]), self.seed, self.device)
        self.program_seed = derive(self.seed, "program")
        self.num_batches = -(-len(self.pages) // data["batch_size"])
        # The check's batches: the first 2 * scan_steps, in an order drawn
        # from the seed, of the batch shape (pages, padded boxes) that has
        # the most batches.
        B = data["batch_size"]
        shapes = [(len(part), kv_chain.bucket(max(map(len, part)), data["quantum"]))
                  for part in (self.pages[i * B:(i + 1) * B] for i in range(self.num_batches))]
        order = [int(i) for i in self.epoch_order(-1)]
        largest = max(set(shapes), key=lambda shape: (shapes.count(shape), -order.index(shapes.index(shape))))
        self.check_batches = [i for i in order if shapes[i] == largest][:2 * self.K]
        if len(self.check_batches) < 2 * self.K:
            raise ValueError(f"the check needs {2 * self.K} batches of one shape; the traffic has "
                             f"{len(self.check_batches)} of its commonest")

    def _procedure_config(self) -> Dict:
        data, m = self.config["data"], self.config["model"]
        split = {
            "data_path": [os.path.join(self.workdir, "pages")],
            "class_path": os.path.join(self.workdir, "classes.json"),
            "charset_path": os.path.join(self.workdir, "charset.json"),
            "key_types": data["key_types"], "batch_size": data["batch_size"], "shuffle": False, "drop_last": False,
            "data_collate": {"BucketPadding": {"quantum": data["quantum"], "only_selected_items": True}},
            "data_process": {"TextlineEncoding": {"is_normalized_text": True},
                             "HeuristicGraphBuilder": {"num_edges": m["num_edges"], "edge_type": "normal_binary"},
                             "NodeLabeling": {}},
        }
        return {
            "seed": self.program_seed, "output_dir": os.path.join(self.workdir, "out"), "num_epochs": 1,
            "scan_steps": self.K, "max_grad_norm": self.config["max_grad_norm"],
            "data_config": {"dataset": {"type": "CassiaDataset",
                                        "args": {"node_label_padding_value": -100, "other_class_index": None}},
                            "training": split, "validation": split},
            "procedure": {"type": "KVProcedure", "args": {}}, "loss": {"type": "CrossEntropyLoss", "args": {}},
            "optimizer": {"type": "BuiltinOptimizer", "args": self.config["optimizer"]},
            "logging": {"use_tensorboard": False, "summary_dir_name": "summary"},
        }

    def build(self) -> None:
        from grl_torch.trainer.procedures.kv_procedure import KVProcedure
        from grl_torch.utils.metric_tracker import Dictlist

        model = self.build_model()
        self.mark("model")
        self.proc = KVProcedure(model, self._procedure_config(), device=self.device)
        self.proc._ensure_initialized()
        self.train_metrics = Dictlist()

    def encode(self) -> None:
        """Every page through the program's chain, once, held on the card."""
        proc = self.proc
        self.batches, self.nodes = [], []
        for batch in proc.train_loader:
            V, A, labels = proc._host_batch(batch)
            self.batches.append((V.to(self.device), A.to(self.device), labels.to(self.device)))
            self.nodes.append([int(n) for n in np.asarray(batch["node_mask"]).sum(axis=1)])
        self.keys = [proc.shape_key(*b) for b in self.batches]
        cost = self.cell.cost
        dtype = self.config["model"]["compute_dtype"]
        self.batch_cost = []
        for nodes in self.nodes:
            c = cost.train_step(cost.shape(self.config, nodes))
            self.operations = tuple(c["ops"])
            self.batch_cost.append({"flops": c["flops"],
                                    **{op: bound_seconds(c["ops"][op], dtype) for op in self.operations}})

    def epoch_order(self, epoch: int) -> np.ndarray:
        return np.random.RandomState(derive(self.seed, f"epoch{epoch}") % 2**32).permutation(self.num_batches)

    def check_chunks(self, phases) -> None:
        """The check's two chunks through ``run_chunk``, as the window runs
        them: the first eager (the warm-up of their shape, tapped for the
        first step), the second captured and replayed."""
        proc, program = self.proc, {"losses": [], "labels": []}
        first, second = self.check_batches[:self.K], self.check_batches[self.K:]
        with first_step_taps(proc.model, proc.state.optimizer, program):
            losses, cms = self._run_chunk(first, epoch=-1)
        self.sync()
        phases.mark("warmup")
        more, more_cms = self._run_chunk(second, epoch=-1)
        self.sync()
        phases.mark("capture")
        program["losses"] = [float(v) for v in np.concatenate([losses, more])]
        # Each step's labelled nodes by class: the confusion matrix's rows.
        program["labels"] = [np.rint(cm.sum(axis=1)).astype(np.int64) for cm in np.concatenate([cms, more_cms])]
        self.program = {**program, "params": parameters(proc.model), "draws_state": self.draws_state(),
                        "batches": [tuple(t.cpu() for t in self.batches[i]) for i in self.check_batches]}

    def warm_up(self, phases) -> None:
        """For each other batch shape: a chunk eagerly and a chunk
        captured; and one eager step of each shape that leaves leftovers in
        an epoch."""
        by_key: Dict = OrderedDict()
        for i, key in enumerate(self.keys):
            by_key.setdefault(key, []).append(i)
        for phase in ("warmup", "capture"):
            for key, members in by_key.items():
                if len(members) >= self.K and key != self.keys[self.check_batches[0]]:
                    self._run_chunk(members[:self.K], epoch=-1)
            self.sync()
            phases.mark(phase)
        for members in by_key.values():
            if len(members) % self.K:
                self._eager_step(members[0], epoch=-1)
        self.sync()
        phases.mark("warmup")

    def setup(self, phases) -> None:
        self.phases = phases
        self.make_inputs()
        phases.mark("inputs")
        self.build()
        phases.mark("plan")
        self.encode()
        phases.mark("encode")
        self.check_chunks(phases)
        self.warm_up(phases)

    # ------------------------------------------------------------------
    def _count(self, members: List[int], eager: bool) -> None:
        c = self.counts
        c["steps"] += len(members)
        c["eager_steps"] += len(members) if eager else 0
        c["pages"] += sum(len(self.nodes[i]) for i in members)
        for i in members:
            cost = self.batch_cost[i]
            c["model_flops"] = c.get("model_flops", 0.0) + cost["flops"]
            for op in self.operations:
                c[f"bound_s.{op}"] = c.get(f"bound_s.{op}", 0.0) + cost[op]

    def _lambda(self, epoch: int) -> float:
        """The procedure's lambda of the next step, and its step count
        advanced, as its epoch loop does for each batch."""
        lam = self.proc._lambda_value(max(epoch, 0))
        self.proc.global_step += 1
        return lam

    def _log(self, losses, cms) -> None:
        """Each step's scores from its confusion matrix, logged as the
        procedure logs them."""
        proc = self.proc
        for loss, cm in zip(losses, cms):
            proc._log_train_step(proc._scores_from_cm(cm, float(loss)), self.train_metrics, proc.global_step)

    def _run_chunk(self, members: List[int], epoch: int):
        """A chunk through ``run_chunk``, as ``_train_epoch_scanned``
        flushes one; its losses and confusion matrices."""
        proc = self.proc
        items = [(*self.batches[i], self._lambda(epoch)) for i in members]
        losses, cms = proc.run_chunk(items)
        self._log(losses, cms)
        proc._maybe_step_checkpoint(epoch)
        self.counts["failed"] += int((~np.isfinite(losses)).sum())
        self._count(members, eager=False)
        return losses, cms

    def _eager_step(self, i: int, epoch: int) -> None:
        """A leftover batch, as ``_train_epoch_scanned`` drains it."""
        proc = self.proc
        V, A, labels = self.batches[i]
        proc._lam.fill_(self._lambda(epoch))
        loss, cm = proc._train_fn(V, A, labels, proc.rngs, proc._lam)
        loss = float(loss)
        self._log([loss], [cm.cpu().numpy()])
        self.counts["failed"] += 0 if math.isfinite(loss) else 1
        self._count([i], eager=True)

    def window(self, seconds: float, tracer) -> Dict[str, float]:
        from grl_torch.utils.metric_tracker import Dictlist

        start = dict(self.counts)
        t0 = time.perf_counter()
        epoch, done = 0, False
        self.epoch_ends = []
        while not done:
            self.train_metrics = Dictlist()
            buffers: Dict = OrderedDict()
            for i in self.epoch_order(epoch):
                members = buffers.setdefault(self.keys[i], [])
                members.append(int(i))
                if len(members) == self.K:
                    tracer.boundary(self.counters())
                    self._run_chunk(buffers.pop(self.keys[i]), epoch)
                    if time.perf_counter() - t0 >= seconds:
                        done = True
                        break
            if not done:
                for members in buffers.values():
                    tracer.boundary(self.counters())
                    for i in members:
                        self._eager_step(i, epoch)
                self.proc._maybe_step_checkpoint(epoch)
                done = time.perf_counter() - t0 >= seconds
                self.epoch_ends.append(time.perf_counter() - t0)
            epoch += 1
        self.sync()
        elapsed = time.perf_counter() - t0
        tracer.boundary(self.counters(), closing=True)
        steps = self.counts["steps"] - start["steps"]
        self.attempted, self.failed = steps, self.counts["failed"] - start["failed"]
        return {"kv_train_pages_per_s": (self.counts["pages"] - start["pages"]) / elapsed, "_window_s": elapsed,
                "_steps": steps}

    def release(self) -> None:
        self.batches = None
        super().release()

    # ------------------------------------------------------------------
    def reference_batches(self, fault: Optional[str] = None):
        """The check's batches, worked out again from the pages.
        ``fault="half_batch"``: the second half of each batch's pages out of
        the loss; ``fault="per_step"``: each chunk's steps all on its first
        batch, as a chunk whose steps all read their first slot would run."""
        torch, data = self.torch, self.config["data"]
        char_to_id = {ch: i for i, ch in enumerate(self.charset)}
        class_to_id = kv_chain.class_ids(self.classes, data["key_types"])
        B = data["batch_size"]
        out = []
        for i in self.check_batches:
            pages = self.pages[i * B:(i + 1) * B]
            encoded = [kv_chain.encode_page(p, char_to_id, class_to_id, self.config["model"]["num_edges"])
                       for p in pages]
            V, A, labels = kv_chain.collate(encoded, data["quantum"])
            if fault == "half_batch":
                labels[len(labels) // 2:] = -100
            out.append(tuple(torch.as_tensor(a, device=self.device) for a in (V, A, labels)))
        if fault == "per_step":
            out = [out[k - k % self.K] for k in range(len(out))]
        return out

    def reference_run(self, rounding: str = "float32", fault: Optional[str] = None) -> Dict:
        ref = self.ref
        ref.plain_float32()
        batches = self.reference_batches(fault)
        net = ref.network(self.config["model"], rounding)
        steps = ref.train_steps(net, self.weights, batches, ref.Draws(self.program_seed, self.device),
                                lr=self.config["optimizer"]["lr"], max_grad_norm=self.config["max_grad_norm"])
        classes = self.config["model"]["output_dim"]
        labels = [np.bincount(b[2][b[2] != -100].cpu().numpy().ravel(), minlength=classes) for b in batches]
        return {"losses": steps.losses, "first_grad": steps.first_grad, "params": steps.params,
                "first_logits": steps.first_logits, "draws_state": steps.draws_state, "labels": labels,
                "batches": [tuple(t.cpu() for t in b) for b in batches]}

    def numbers(self, program: Dict, reference: Dict) -> Dict[str, float]:
        """The training numbers, and two exact ones: ``batch_mismatch``, the
        elements of the check's batches as the program encoded them that
        differ from the reference's; ``label_mismatch``, each step's
        labelled nodes by class as its confusion matrix counts them, against
        the reference's batch for that step (a step that read another
        step's batch)."""
        out = check.training_numbers(program, reference, self.weights)
        mismatch = 0
        for got, want in zip(program["batches"], reference["batches"]):
            for g, w in zip(got, want):
                if g.shape != w.shape:
                    mismatch += max(g.numel(), w.numel())
                    continue
                mismatch += int((g.to(w.dtype) != w.to(g.dtype).to(w.dtype)).sum())
        out["batch_mismatch"] = float(mismatch)
        out["label_mismatch"] = float(sum(int(np.abs(p - r).sum()) if p.shape == r.shape else int(r.sum()) + 1
                                          for p, r in zip(program["labels"], reference["labels"])))
        return out
