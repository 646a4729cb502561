"""Work of ``flagship_sumi_kv``'s steps, from a batch's shapes.

Counted from the model's mathematics over each page's real boxes ``n``
(not the bucket's padding), never from a kernel's layout:

* ``flops``: twice the multiply-adds of every linear layer and
  convolution (``[self | rel_0 .. rel_5] @ W``), of the dense aggregation
  ``sum_m A[n, l, m] v[m]`` (``2 n^2 L F`` a page) and of the
  self-attention's two products (``f g^T`` and ``softmax @ h``). A train
  step adds each GEMM's input and weight gradients (not ``emb1``'s input
  gradient, not the frozen projection's weight gradient), both operands'
  gradients of the attention's products, and each aggregation's
  transpose (the adjacency takes none).
* ``ops``: each launch of an operation's work as ``(flops, bytes)``,
  every input read once and every output written once: ``relagg`` (a
  convolution's aggregation over the batch: the adjacency, ``2 n^2 L``
  bytes a page in bf16, the features ``2 n F``, the output ``2 n L F``;
  forward and its transpose in training), ``dropout`` (read and write of
  each dropped activation, both ways).
"""
from __future__ import annotations

from typing import Dict, List


def shape(config: Dict, nodes: List[int]) -> Dict:
    m = config["model"]
    return {"n": list(nodes), "I": m["input_dim"], "C": m["output_dim"], "L": m["num_edges"], "S": m["net_size"],
            "RP": m["net_size"] // 2 * m.get("rp_factor", 10), "attention": m.get("use_attention", True),
            "itemsize": 2 if m["compute_dtype"] == "bfloat16" else 4}


def _per_page(s, n):
    I, C, L, S, RP = s["I"], s["C"], s["L"], s["S"], s["RP"]
    half = S // 2
    gemms = {
        "emb1": 2 * n * I * S, "gcn1": 2 * n * (L + 1) * S * S, "gcn2": 2 * n * (L + 1) * S * S,
        "gcn3": 2 * n * (L + 1) * 2 * S * S, "emb2": 2 * n * 2 * S * half,
        "w_rand": 2 * n * half * RP, "classifier": 2 * n * RP * C,
    }
    if s["attention"]:
        gemms.update(f=2 * n * half * (half // 8), g=2 * n * half * (half // 8), h=2 * n * half * half,
                     scores=2 * n * n * (half // 8), mix=2 * n * n * half)
    aggs = [2 * n * n * L * F for F in (S, S, 2 * S)]
    return gemms, aggs


def _relagg(s):
    """(flops, bytes) of each forward aggregation over the batch."""
    L, S, b = s["L"], s["S"], s["itemsize"]
    out = []
    for F in (S, S, 2 * S):
        flops = sum(2 * n * n * L * F for n in s["n"])
        nbytes = sum(n * n * L * b + n * F * b + n * L * F * b for n in s["n"])
        out.append((flops, nbytes))
    return out


def train_step(s) -> Dict:
    flops = 0
    for n in s["n"]:
        gemms, aggs = _per_page(s, n)
        flops += 3 * sum(gemms.values()) - gemms["emb1"] - gemms["w_rand"] + 2 * sum(aggs)
    nodes = sum(s["n"])
    drops = [nodes * s["S"]] * 4 + [nodes * s["RP"]]
    dropout = [(d, 2 * d * s["itemsize"]) for d in drops]
    relagg = _relagg(s)
    return {"flops": flops, "ops": {"relagg": relagg + relagg, "dropout": dropout + dropout}}
