"""Each configuration's cost functions against a hand count at a tiny shape."""
import json
from pathlib import Path

from portbench.harness.registry import _load_module

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def load(name):
    return _load_module(CONFIGS / f"{name}.py", f"cost_{name}"), json.loads((CONFIGS / f"{name}.json").read_text())


def tiny_config(config, **model):
    return {**config, "model": {**config["model"], **model}}


def test_full_graph_counts():
    cost, config = load("flagship_arxiv_ell")
    config = tiny_config(config, input_dim=3, output_dim=2, num_edges=1, net_size=4, rp_factor=2,
                         edge_dropout_rate=0.5, compute_dtype="bfloat16")
    s = cost.shape(config, nodes=5, edges=8)
    # By hand, N=5, I=3, S=4, L=1, RP=4, C=2, kept edges 4:
    # emb1 2*5*3*4=120, gcn1 2*5*2*4*4=320, gcn2 320, gcn3 2*5*2*8*4=640,
    # emb2 2*5*8*2=160, w_rand 2*5*2*4=80, classifier 2*5*4*2=80: 1720.
    # Aggregations 3 x 2*4*4 = 96.
    ev = cost.eval_step(s)
    assert ev["flops"] == 1720 + 96
    # Training: 3 x 1720 - 120 - 80 + 2 x 96.
    tr = cost.train_step(s)
    assert tr["flops"] == 3 * 1720 - 120 - 80 + 2 * 96
    # An aggregation at width 4 in bf16: reads 5x4x2, writes 5x4x2, 4 kept edges x 12 bytes.
    assert ev["ops"]["ell"][0] == (2 * 4 * 4, 40 + 40 + 48)
    assert len(tr["ops"]["ell"]) == 6 and ev["ops"]["dropout"] == []
    # Dropout: emb1, three convolutions (5x4 each), the projection (5x4), both ways; read and write 2 bytes.
    assert tr["ops"]["dropout"] == [(20, 80)] * 5 * 2


def test_dense_kv_counts():
    cost, config = load("flagship_sumi_kv")
    config = tiny_config(config, input_dim=3, output_dim=2, num_edges=2, net_size=16, rp_factor=1,
                         use_attention=True, compute_dtype="bfloat16")
    s = cost.shape(config, nodes=[3])
    n, I, L, S, half, RP, C = 3, 3, 2, 16, 8, 8, 2
    gemms = (2 * n * I * S + 2 * 2 * n * (L + 1) * S * S + 2 * n * (L + 1) * 2 * S * S + 2 * n * 2 * S * half
             + 2 * n * half * RP + 2 * n * RP * C
             + 2 * (2 * n * half * 1) + 2 * n * half * half + 2 * n * n * 1 + 2 * n * n * half)
    aggs = sum(2 * n * n * L * F for F in (S, S, 2 * S))
    step = cost.train_step(s)
    assert step["flops"] == 3 * gemms - 2 * n * I * S - 2 * n * half * RP + 2 * aggs
    # The first aggregation: A 3x2x3 (2 bytes each), features 3x16, output 3x2x16.
    assert step["ops"]["relagg"][0] == (2 * n * n * L * S, 2 * (n * n * L + n * S + n * L * S))
    assert len(step["ops"]["relagg"]) == 6
    assert step["ops"]["dropout"][0] == (n * S, 2 * n * S * 2)
