"""The zoo's GATV2 configuration: its cost functions against a hand count at
a tiny shape, the ``kv_zoo`` family's mapping of the zoo's constructor
keys, its plain reference loading nothing of the program, and its cell and
configuration as ``BENCHMARK.json`` resolves them."""
import json
import tempfile
from pathlib import Path

import torch

from portbench.harness.families import kv_zoo
from portbench.harness.registry import Benchmark, _load_module
from test_portbench_imports import FORBIDDEN, TOP, loaded_after

ROOT = Path(__file__).resolve().parents[2]
CONFIG = json.loads((ROOT / "portbench/configs/gatv2_sumi_kv.json").read_text())


def test_gatv2_counts():
    cost = _load_module(ROOT / "portbench/configs/gatv2_sumi_kv.py", "cost_gatv2_sumi_kv")
    config = {**CONFIG, "model": {**CONFIG["model"], "input_feature": 3, "no_A": 1, "output_feature": 4,
                                  "num_classes": 2}}
    s = cost.shape(config, [2])
    # By hand, n = 2, two branches (1 relation and the identity), H sq = 64,
    # every layer 256 wide, sq 16. A layer reading f: projections 2 x 2 x
    # (2*2*f*64) = 1024 f, scores and sums 2 x 2 x (2*4*64) = 2048, squeeze
    # 2*2*32*256 = 32768, map 2*2*f*256 = 1024 f where f != 256.
    layers = [1024 * 3 + 2048 + 32768 + 1024 * 3,  # gat_in, f = 3
              1024 * 256 + 2048 + 32768,  # dense layer 0, f = 256
              1024 * 512 + 2048 + 32768 + 1024 * 512,  # dense layer 1, f = 512
              1024 * 768 + 2048 + 32768 + 1024 * 768,  # squeeze block, f = 768
              1024 * 256 + 2048 + 32768]  # gat_out
    forward = sum(layers) + 2 * 2 * 256 * 4 + 2 * 2 * 4 * 2  # mlp, class_output
    assert forward == 3330080
    # Training: three times the forward, less gat_in's projections' and
    # map's input gradient (2 x 2 x 2*2*3*64 + 2*2*3*256).
    step = cost.train_step(s)
    assert step["flops"] == 3 * forward - (2 * 2 * 2 * 2 * 3 * 64 + 2 * 2 * 3 * 256)
    # A branch's attention: forward 2 x 2*4*64 flops, reads s and d (2*2*64),
    # the mask (4) and writes the output (2*16), 4 bytes each; backward
    # twice the flops, and also reads the output's gradient and writes two.
    assert step["ops"]["gat_attention"] == [(1024, 4 * (256 + 4 + 32))] * 10 + [(2048, 4 * (256 + 4 + 32 + 256))] * 10
    # Dropout: each branch's input (2 x f) and attention weights (2*2*4),
    # both ways, but gat_in's input backward.
    assert len(step["ops"]["dropout"]) == 20 + 18
    assert step["ops"]["dropout"][:2] == [(6, 48), (16, 128)]


def test_kv_zoo_maps_the_constructor_keys():
    model = CONFIG["model"]
    keys = kv_zoo.kv_keys(model)
    assert (keys["num_edges"], keys["output_dim"], keys["compute_dtype"]) == (6, 53, "float32")
    assert kv_zoo.constructor({**model, "compute_dtype": "bfloat16"}) == {
        "input_feature": 4369, "no_A": 6, "output_feature": 128, "num_classes": 53, "use_v2": True}
    cell = Benchmark(ROOT).cell("gatv2_kv_train")
    with tempfile.TemporaryDirectory() as workdir:
        card = kv_zoo.Family(torch, cell, 1, "cuda", workdir)
        cpu = kv_zoo.Family(torch, cell, 1, "cpu", workdir)
    # The card runs the configuration as written; the CPU takes its cut.
    assert card.constructor == kv_zoo.constructor(model) and card.traffic == cell.traffic
    assert card.config["data"] == CONFIG["data"]
    assert cpu.constructor["input_feature"] == CONFIG["cpu"]["model"]["input_feature"]
    assert cpu.traffic["pages"] == CONFIG["cpu"]["traffic"]["pages"]
    assert cpu.config["model"]["output_dim"] == CONFIG["cpu"]["model"]["num_classes"]


def test_gatv2_reference_loads_nothing_of_the_program():
    loaded = loaded_after("import portbench.reference.gatv2\n" + TOP)
    assert not loaded & (FORBIDDEN | {"grl_torch"})


def test_gatv2_cell_and_configuration_resolve():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = Benchmark(ROOT).cell("gatv2_kv_train")
    assert cell.entry["config"] == "gatv2_sumi_kv" and cell.chips == 1 and cell.traffic["family"] == "kv_zoo"
    assert {m["name"] for m in cell.end_to_end} == {"kv_train_pages_per_s", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {"device_idle.kv", "step_mfu.gatv2"}
    entry = next(c for c in spec["configs"] if c["name"] == "gatv2_sumi_kv")
    assert entry["reduced"] == [] and CONFIG["reference"] == "portbench/reference/gatv2.py"
    # The published widths: 4369 in, 6 relations, mlp 128, 53 classes, GATv2 layers.
    assert cell.config["model"] == {"type": "GATV2", "input_feature": 4369, "no_A": 6, "output_feature": 128,
                                    "num_classes": 53, "use_v2": True}
