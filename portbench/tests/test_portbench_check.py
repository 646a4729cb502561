"""The output check: a sound run of each cell is correct; the control (the
reference computed in float8, the precision below the configuration's
bfloat16, put in the program's place) fails the cell's limits; and a run
with the timed path broken underneath comes out not correct, once for each
fault a one-chip training cell can have: a step that leaves its state
unchanged, half of the batch left out of the loss (the mean taken over the
rest), and a chunk whose steps do not each get their own input (one slot
of the static inputs read for every step; one step's masks drawn for
every step). All on the CPU at a tiny size (``tiny.py``)."""
import tempfile

import pytest
import torch

from tiny import CELLS, run, tiny_cell


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    result = run(tiny_cell(name))
    assert result["correct"], result["check"]
    assert result["failed"] == 0 and result["attempted"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reports_per_layer_metrics(name):
    result = run(tiny_cell(name), trace=1)
    assert result["correct"], result["check"]
    assert result["metrics"] and {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limits(name):
    from portbench.harness import families
    from portbench.harness.check import verdict
    from portbench.harness.registry import limits

    cell = tiny_cell(name, dtype="bfloat16")
    with tempfile.TemporaryDirectory() as workdir:
        family = families.load(cell.traffic["family"])(torch, cell, 2**31 + 11, "cpu", workdir)
        family.make_inputs()
        reference = family.reference_run()
        correct, rows = verdict(family.numbers(family.reference_run("float8"), reference), limits(cell))
    assert not correct, rows


def _half_batch(loss):
    def wrapped(logits, targets, *args, **kwargs):
        targets = targets.clone()
        flat = targets.view(-1)
        labelled = (flat != -100).nonzero()[:, 0]
        flat[labelled[len(labelled) // 2:]] = -100
        return loss(logits, targets, *args, **kwargs)

    return wrapped


@pytest.mark.parametrize("name", CELLS)
def test_state_left_unchanged_is_not_correct(name, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    result = run(tiny_cell(name))
    assert not result["correct"], result["check"]


@pytest.mark.parametrize("name", CELLS)
def test_half_batch_left_out_is_not_correct(name, monkeypatch):
    from grl_torch.trainer import losses
    from grl_torch.trainer.procedures import full_graph_procedure

    for module in (losses, full_graph_procedure):
        monkeypatch.setattr(module, "cross_entropy", _half_batch(module.cross_entropy))
    result = run(tiny_cell(name))
    assert not result["correct"], result["check"]


def _slot_zero(load_chunk):
    """``load_chunk`` whose steps all read the chunk's first batch."""
    def wrapped(self, items):
        return load_chunk(self, [items[0]] * len(items))

    return wrapped


def _chunk_draws_reused(load_chunk):
    """``load_chunk`` whose steps all draw the masks of the chunk's first."""
    def wrapped(self, items):
        inner, held = self._train_body, {}

        def body(V, A, labels, rngs, lam):
            if "state" in held:
                rngs.device.set_state(held["state"])
            else:
                held["state"] = rngs.device.get_state()
            return inner(V, A, labels, rngs, lam)

        self._train_body = body
        try:
            return load_chunk(self, items)
        finally:
            self._train_body = inner

    return wrapped


def _draws_reused(chunk_body):
    """``chunk_body`` whose steps all draw the masks of the chunk's first."""
    def wrapped(self, k):
        def body():
            start, losses = self.rngs.device.get_state(), []
            for _ in range(k):
                self.rngs.device.set_state(start)
                losses.append(self._step_body())
            return torch.stack(losses)

        return body

    return wrapped


@pytest.mark.parametrize("name", [c for c in CELLS if c.startswith("sumi_kv")])
def test_slot_read_for_every_step_is_not_correct(name, monkeypatch):
    """A chunk whose steps all read one slot of its static inputs."""
    from grl_torch.trainer.procedures.kv_procedure import KVProcedure

    monkeypatch.setattr(KVProcedure, "load_chunk", _slot_zero(KVProcedure.load_chunk))
    result = run(tiny_cell(name))
    assert not result["correct"], result["check"]


@pytest.mark.parametrize("name", CELLS)
def test_draws_reused_in_a_chunk_is_not_correct(name, monkeypatch):
    """A chunk whose steps all draw the dropout and DropEdge masks of its
    first step."""
    from grl_torch.trainer.procedures.full_graph_procedure import FullGraphProcedure
    from grl_torch.trainer.procedures.kv_procedure import KVProcedure

    monkeypatch.setattr(KVProcedure, "load_chunk", _chunk_draws_reused(KVProcedure.load_chunk))
    monkeypatch.setattr(FullGraphProcedure, "chunk_body", _draws_reused(FullGraphProcedure.chunk_body))
    result = run(tiny_cell(name))
    assert not result["correct"], result["check"]
