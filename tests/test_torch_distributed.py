"""The port's process-group runtime (``grl_torch.parallel.distributed``),
held to ``grl_tpu``'s launch contract, and the harness the multi-process
tests share.

* ``initialize_distributed``: single-process when nothing is configured;
  in a two-process gloo world on the CPU, the ``parallel.distributed``
  block before the ``GRL_*`` variables, idempotence, ``host_id`` /
  ``num_hosts`` written into the config, the backend returned;
* the backend rule (gloo on the CPU, NCCL only with a card per rank) and
  the transport it implies;
* the DataLoader's host shard bit for bit against ``grl_tpu``'s, and the
  refusal of a batch size that does not divide;
* a mesh over more devices than the world raises, naming the launch
  contract; a mesh of one device is a no-op;
* ``python -m grl_torch.demo_training`` as two processes through the
  ``GRL_*`` contract with ``--device cpu``, training one model.

:func:`run_world` starts a world: a worker script written to ``tmp_path``,
N subprocesses with the ``GRL_*`` variables and a free port, JAX and
``grl_tpu`` blocked in each (an import of either fails), results written
back by each rank under ``tmp_path``.
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "grl_tpu")

# Every worker starts so: JAX and grl_tpu blocked, one intra-op thread (the
# suite's processes share the cores), the rank's coordinates, and
# ``OUT`` the directory results go to.
PREAMBLE = textwrap.dedent(
    f"""
    import os, sys
    for _name in {BLOCKED!r}:
        sys.modules[_name] = None
    sys.path.insert(0, {str(REPO)!r})
    import numpy as np
    import torch
    torch.set_num_threads(1)
    RANK = int(os.environ["GRL_PROCESS_ID"])
    WORLD = int(os.environ["GRL_NUM_PROCESSES"])
    OUT = sys.argv[1]


    def no_jax():
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in {BLOCKED!r} and sys.modules[m] is not None)
        assert not leaked, leaked
    """
)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(tmp_path: Path, body: str, world: int, name: str = "worker", timeout: float = 240,
              extra_env=None) -> list:
    """Run ``body`` (after :data:`PREAMBLE`) in ``world`` processes on the
    CPU; returns each rank's stdout. Fails with the output of any rank that
    failed, or of the world when it outlives ``timeout`` seconds."""
    script = tmp_path / f"{name}.py"
    script.write_text(PREAMBLE + textwrap.dedent(body))
    out = tmp_path / f"{name}_out"
    out.mkdir(exist_ok=True)
    port = free_port()
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(OMP_NUM_THREADS="1", GRL_COORDINATOR_ADDRESS=f"127.0.0.1:{port}", GRL_NUM_PROCESSES=str(world),
               **(extra_env or {}))
    procs = [subprocess.Popen([sys.executable, str(script), str(out)], cwd=tmp_path,
                              env={**env, "GRL_PROCESS_ID": str(rank)}, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for rank in range(world)]
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, text) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{text[-4000:]}"
    return outputs


def results(tmp_path: Path, name: str, world: int) -> list:
    """What each rank saved with ``torch.save`` to ``OUT/rank<r>.pt``."""
    return [torch.load(tmp_path / f"{name}_out" / f"rank{r}.pt", weights_only=False) for r in range(world)]


# ---------------------------------------------------------------------------
# The runtime
# ---------------------------------------------------------------------------
def test_single_process_when_nothing_is_configured(monkeypatch):
    from grl_torch.config import ConfigDict
    from grl_torch.parallel import initialize_distributed

    for name in ("GRL_COORDINATOR_ADDRESS", "GRL_NUM_PROCESSES", "GRL_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    config = ConfigDict({})
    assert initialize_distributed(config, "cpu") == (0, 1, "")
    assert config["host_id"] == 0 and config["num_hosts"] == 1
    assert not torch.distributed.is_initialized()


def test_backend_rule_and_transport():
    from grl_torch.parallel.distributed import choose_backend, transport

    assert choose_backend(2, "cpu", 0) == "gloo"
    assert choose_backend(2, "cuda", 1) == "gloo"  # two ranks share one card
    assert choose_backend(2, "cuda", 2) == "nccl"
    assert choose_backend(4, "cuda", 8) == "nccl"
    assert choose_backend(4, "cuda", 2) == "gloo"
    assert "pinned host" in transport("gloo", "cuda")
    assert transport("gloo", "cpu") == "gloo: direct" and transport("nccl", "cuda") == "nccl: direct"


RESOLUTION = """
from grl_torch.config import ConfigDict
from grl_torch.parallel import initialize_distributed

# The GRL_* variables name a port nothing listens on: the config block,
# read first, names the real one.
config = ConfigDict({"parallel": {"distributed": {
    "coordinator_address": os.environ["REAL_COORDINATOR"], "num_processes": WORLD, "process_id": RANK,
    "timeout": 60}}})
first = initialize_distributed(config, "cpu")
again = initialize_distributed(ConfigDict({}), "cpu")
assert first == again == (RANK, WORLD, "gloo"), (first, again)
assert config["host_id"] == RANK and config["num_hosts"] == WORLD
t = torch.tensor([float(RANK + 1)])
torch.distributed.all_reduce(t)
assert float(t) == WORLD * (WORLD + 1) / 2
no_jax()
print("RESOLVED", first)
"""


def test_config_block_first_idempotent_and_host_ids(tmp_path):
    real = f"127.0.0.1:{free_port()}"
    outputs = run_world(tmp_path, RESOLUTION, 2, "resolution",
                        extra_env={"REAL_COORDINATOR": real})
    assert all("RESOLVED" in out for out in outputs)


# ---------------------------------------------------------------------------
# The DataLoader's host shard
# ---------------------------------------------------------------------------
class Toy:
    def __len__(self):
        return 15

    def __getitem__(self, i):
        return {"x": np.full((2,), i, np.float32)}


@pytest.mark.parametrize("num_hosts, batch_size", [(2, 4), (3, 6), (1, 5)])
def test_host_shards_match_grl_tpu(num_hosts, batch_size):
    from grl_tpu.data.dataloader import DataLoader as JaxDataLoader
    from grl_torch.data.dataloader import DataLoader

    seen = []
    for host in range(num_hosts):
        kwargs = dict(batch_size=batch_size, shuffle=True, seed=3, host_id=host, num_hosts=num_hosts, prefetch=0)
        loader = DataLoader(Toy(), **kwargs)
        theirs_loader = JaxDataLoader(Toy(), **kwargs)
        assert len(loader) == len(theirs_loader)
        ours = [b["x"] for _ in range(2) for b in loader]
        theirs = [b["x"] for _ in range(2) for b in theirs_loader]
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)
        seen += [int(v) for batch in ours[:len(ours) // 2] for v in batch[:, 0]]
    # Together the hosts cover one epoch, disjointly.
    assert sorted(seen) == list(range(15))


def test_host_shard_refuses_a_batch_that_does_not_divide():
    from grl_torch.data.dataloader import DataLoader

    with pytest.raises(ValueError, match="divide evenly across hosts"):
        DataLoader(Toy(), batch_size=3, host_id=0, num_hosts=2)


def test_config_factory_reads_the_host_shard():
    from grl_torch.config import ConfigDict
    from grl_torch.data.dataloader import BaseDataLoader

    loader = BaseDataLoader(ConfigDict({"host_id": 1, "num_hosts": 2}))._get_dataloader(
        Toy(), {"batch_size": 4, "prefetch": 0})
    assert (loader.host_id, loader.num_hosts, loader.batch_size, loader.global_batch_size) == (1, 2, 2, 4)
    assert [int(v) for v in next(iter(loader))["x"][:, 0]] == [1, 3]


# ---------------------------------------------------------------------------
# Meshes and the world
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["KVProcedure", "FullGraphProcedure", "SampledGraphProcedure"])
def test_mesh_larger_than_the_world_names_the_launch_contract(tmp_path, kind):
    """The four refusals of the one-process port became this one: a mesh
    over more devices than the world's processes raises, naming
    GRL_NUM_PROCESSES; a mesh of one device stays a no-op."""
    from grl_torch import models
    from grl_torch.data import large_graph
    from grl_torch.trainer.procedures import BaseProcedure, FullGraphProcedure, SampledGraphProcedure

    model = models.create_model("GraphCNNDropEdge", input_dim=4, output_dim=3, num_edges=2, net_size=16,
                                use_attention=False, device="cpu")
    base = {"output_dir": str(tmp_path), "logging": {"use_tensorboard": False}}
    data = large_graph.sbm_relational_graph(num_nodes=40, num_classes=3, num_relations=2, avg_degree=3,
                                            feature_dim=4)
    cls = {"KVProcedure": BaseProcedure, "FullGraphProcedure": FullGraphProcedure,
           "SampledGraphProcedure": SampledGraphProcedure}[kind]
    extra = {} if cls is BaseProcedure else {"data": data}
    for mesh in ({"data": -1}, {"data": 1, "model": 1}):
        assert cls(model, {**base, "parallel": {"mesh": mesh}}, device="cpu", **extra).mesh is None
    with pytest.raises(ValueError, match="GRL_NUM_PROCESSES=2"):
        cls(model, {**base, "parallel": {"mesh": {"data": 2}}}, device="cpu", **extra)


# ---------------------------------------------------------------------------
# Two processes through the demo entry point
# ---------------------------------------------------------------------------
def test_two_process_demo_training(tmp_path):
    """``python -m grl_torch.demo_training`` started twice with the GRL_*
    variables and ``parallel.mesh: {data: 2}`` trains one model: both
    ranks print the same final F1, and only the first writes the
    checkpoint and the summaries."""
    import yaml

    config = yaml.safe_load((REPO / "configs" / "synthetic_kv.yaml").read_text())
    config["output_dir"] = str(tmp_path / "out")
    config["parallel"] = {"mesh": {"data": 2}, "distributed": {"timeout": 120}}
    config["synthetic_data"] = {"num_pages": 8}
    config["model"]["args"].update(net_size=16, kernel_impl="xla")
    for split in ("training", "validation"):
        config["data_config"][split]["batch_size"] = 4
    config["num_epochs"] = 1
    config.setdefault("logging", {})["use_tensorboard"] = False
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(config))
    port = free_port()
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(OMP_NUM_THREADS="1", GRL_COORDINATOR_ADDRESS=f"127.0.0.1:{port}", GRL_NUM_PROCESSES="2",
               PYTHONPATH=str(REPO) + os.pathsep + env.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-m", "grl_torch.demo_training", "--config", str(path),
                               "--device", "cpu"], cwd=tmp_path, env={**env, "GRL_PROCESS_ID": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = []
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    finals = [[ln for ln in out.splitlines() if ln.startswith("final macro F1")] for out in outs]
    assert finals[0] and finals[0] == finals[1], finals
    assert "mesh over 2 processes" in outs[0] and "backend gloo" in outs[0]
    experiment = Path(config["output_dir"]) / config.get("experiment_name", "experiment")
    assert (experiment / "models" / "model_latest").exists()
    summaries = list(experiment.rglob("metrics.jsonl"))
    assert len(summaries) == 1 and summaries[0].stat().st_size > 0
    assert json.loads(summaries[0].read_text().splitlines()[0])["tag"]
