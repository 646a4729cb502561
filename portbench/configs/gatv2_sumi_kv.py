"""Work of ``gatv2_sumi_kv``'s steps, from a batch's shapes.

Counted from the model's mathematics over each page's real boxes ``n``
(not the bucket's padding), never from a kernel's layout. The network is
five GATv2 layers (``gat_in`` reading the input, the two dense layers and
the squeeze block reading 256, 512 and 768 wide concatenations,
``gat_out``), each of ``L + 1`` branches with ``H`` heads of ``sq``, then
``mlp`` and ``class_output``:

* ``flops``: twice the multiply-adds of every linear layer (a branch's
  ``W_src`` and ``W_dst``, each layer's ``squeeze`` and, where its input
  width is not 256, ``map``; ``mlp``, ``class_output``) and of each
  branch's score dot with ``a`` and its weighted sum, ``2 n^2 H sq`` each.
  A train step adds both operands' gradients of each (three times the
  forward), but the input gradient of ``gat_in``'s projections, which
  read the features.
* ``ops``: each launch of an operation's work as ``(flops, bytes)``, every
  input read once and every output written once: ``gat_attention`` (a
  branch's attention over the batch, from ``s`` and ``d`` to its output:
  reads ``s``, ``d`` and the relation's mask, writes the output; its
  backward reads ``s``, ``d``, the mask and the output's gradient and
  writes the gradients of ``s`` and ``d``, at twice the forward's
  operations), ``dropout`` (read and write of each dropped tensor: a
  branch's input and its attention weights, both ways, but no gradient of
  ``gat_in``'s input).
"""
from __future__ import annotations

from typing import Dict, List

WIDTH, HEADS, RATIO = 256, 4, 16


def shape(config: Dict, nodes: List[int]) -> Dict:
    m = config["model"]
    return {"n": list(nodes), "I": m["input_feature"], "C": m["num_classes"], "L": m["no_A"],
            "out": m.get("output_feature", 128), "H": HEADS, "sq": WIDTH // RATIO,
            "itemsize": 2 if m.get("compute_dtype") == "bfloat16" else 4}


def _layer_inputs(s) -> List[int]:
    """The width each of the five GAT layers reads."""
    return [s["I"], WIDTH, 2 * WIDTH, 3 * WIDTH, WIDTH]


def _forward(s, n: int):
    """(the forward's flops of one page, the part of them that reads the
    features: ``gat_in``'s projections and ``map``)."""
    L, H, sq = s["L"], s["H"], s["sq"]
    total = 0
    for f in _layer_inputs(s):
        total += (L + 1) * (2 * (2 * n * f * H * sq) + 2 * (2 * n * n * H * sq))
        total += 2 * n * (L + 1) * sq * WIDTH + (2 * n * f * WIDTH if f != WIDTH else 0)
    total += 2 * n * WIDTH * s["out"] + 2 * n * s["out"] * s["C"]
    reads_input = (L + 1) * 2 * (2 * n * s["I"] * H * sq) + (2 * n * s["I"] * WIDTH if s["I"] != WIDTH else 0)
    return total, reads_input


def _attention(s):
    """(flops, bytes) of one branch's attention over the batch, forward and
    backward."""
    H, sq, b = s["H"], s["sq"], s["itemsize"]
    flops = sum(2 * (2 * n * n * H * sq) for n in s["n"])
    forward = sum(2 * n * H * sq + n * n + n * sq for n in s["n"]) * b
    backward = sum(2 * n * H * sq + n * n + n * sq + 2 * n * H * sq for n in s["n"]) * b
    return (flops, forward), (2 * flops, backward)


def train_step(s) -> Dict:
    flops = 0
    for n in s["n"]:
        forward, reads_input = _forward(s, n)
        flops += 3 * forward - reads_input
    branches = 5 * (s["L"] + 1)
    forward, backward = _attention(s)
    nodes, pairs = sum(s["n"]), sum(n * n for n in s["n"]) * s["H"]
    drops, grads = [], []
    for k, f in enumerate(_layer_inputs(s)):
        for _ in range(s["L"] + 1):
            drops += [nodes * f, pairs]
            grads += [pairs] if k == 0 else [nodes * f, pairs]
    dropout = [(d, 2 * d * s["itemsize"]) for d in drops + grads]
    return {"flops": flops, "ops": {"gat_attention": [forward] * branches + [backward] * branches,
                                    "dropout": dropout}}
