"""Work of ``flagship_arxiv_ell``'s steps, from its shapes.

Counted from the model's mathematics over the graph's real nodes and its
kept edges (the expected share ``1 - edge_dropout_rate``), never from a
kernel's layout, so that it reads the same whichever kernel does the work.

* ``flops``: the model's multiply-adds, twice each: the GEMMs of every
  linear layer and convolution (a convolution is ``[self | neighbours] @
  W``, ``2 N (L+1) F_in F_out``), and the aggregations (``2 E_kept F``).
  A train step adds, for each GEMM, the input's and the weight's
  gradient (not the input features' gradient of ``emb1``, not the frozen
  projection's weight gradient) and each aggregation's transpose.
  Elementwise work, the softmax and Adam are not counted.
* ``ops``: each launch of an operation's work as ``(flops, bytes)``, every
  input read once and every output written once: ``ell`` (the
  aggregation of ``gcn1`` and ``gcn2`` at width ``S``, and of ``gcn3``
  projected first, at width ``S`` over ``N L`` channel rows: its
  ``plan_projected``), with 12 bytes an edge (sender, receiver, weight);
  ``dropout`` (read and write of each dropped activation, both ways).
"""
from __future__ import annotations

from typing import Dict

EDGE_BYTES = 12


def shape(config: Dict, nodes: int, edges: int) -> Dict[str, float]:
    m = config["model"]
    return {
        "N": nodes, "E": edges, "I": m["input_dim"], "C": m["output_dim"], "L": m["num_edges"],
        "S": m["net_size"], "RP": m["net_size"] // 2 * m.get("rp_factor", 10),
        "edge_keep": 1.0 - m["edge_dropout_rate"], "itemsize": 2 if m["compute_dtype"] == "bfloat16" else 4,
    }


def _gemms(s) -> Dict[str, float]:
    N, I, C, L, S, RP = s["N"], s["I"], s["C"], s["L"], s["S"], s["RP"]
    return {
        "emb1": 2 * N * I * S,
        "gcn1": 2 * N * (L + 1) * S * S,
        "gcn2": 2 * N * (L + 1) * S * S,
        "gcn3": 2 * N * (L + 1) * 2 * S * S,
        "emb2": 2 * N * 2 * S * (S // 2),
        "w_rand": 2 * N * (S // 2) * RP,
        "classifier": 2 * N * RP * C,
    }


def _aggregations(s):
    """(flops, bytes) of each forward aggregation."""
    N, L, S, b = s["N"], s["L"], s["S"], s["itemsize"]
    kept = s["E"] * s["edge_keep"]
    plain = (2 * kept * S, N * S * b + N * L * S * b + kept * EDGE_BYTES)
    projected = (2 * kept * S, N * L * S * b + N * S * b + kept * EDGE_BYTES)
    return [plain, plain, projected]


def _dropouts(s):
    """Elements of each dropped activation: emb1, the three convolutions,
    the projection."""
    N, S, RP = s["N"], s["S"], s["RP"]
    return [N * S, N * S, N * S, N * S, N * RP]


def eval_step(s) -> Dict:
    aggs = _aggregations(s)
    return {"flops": sum(_gemms(s).values()) + sum(f for f, _ in aggs),
            "ops": {"ell": aggs, "dropout": []}}


def train_step(s) -> Dict:
    gemms, aggs = _gemms(s), _aggregations(s)
    forward = sum(gemms.values()) + sum(f for f, _ in aggs)
    backward = 2 * sum(gemms.values()) - gemms["emb1"] - gemms["w_rand"] + sum(f for f, _ in aggs)
    drops = [(n, 2 * n * s["itemsize"]) for n in _dropouts(s)]
    return {"flops": forward + backward, "ops": {"ell": aggs + aggs, "dropout": drops + drops}}

