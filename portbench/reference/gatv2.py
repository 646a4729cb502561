"""``GATV2`` with GATv2 layers, trained by plain float32 PyTorch.

The network is the reference repository's multi-relational GAT for
key-value extraction (``gnn/models/networks/gatv2.py:385-428``) built on
GATv2 attention (Brody, Alon and Yahav, "How Attentive are Graph Attention
Networks?", ICLR 2022, arXiv:2105.14491):

``gat_in`` (a GATv2 layer to 256) → two dense-connectivity layers, each
reading the concatenation of everything before it (256 and 512 wide), and
a squeeze layer reading all of it (768) → ``gat_out`` (256 → 256) →
``mlp`` (a linear layer to ``output_feature``) → ``class_output`` (a
linear layer to the classes); masked mean cross-entropy, a global-norm
clip and Adam (:func:`portbench.reference.flagship.train_steps`).

A GATv2 layer of width ``F`` runs ``L + 1`` branches, one per relation of
the dense ``(B, N, L, N)`` adjacency and one for the identity. In each,
with ``H`` = 4 heads of ``sq = F / 16``:

* the layer's input ``x`` is dropped (rate 0.3);
* ``s = x W_src`` and ``d = x W_dst``, each ``(B, N, H, sq)``;
* ``e_ijh = sum_c a_hc leaky_relu(s_ihc + d_jhc, 0.01)``: the pair tensor
  ``(B, N, N, H, sq)``;
* ``e`` is set to -9e15 where ``A[b, i, l, j]`` is 0 (the identity: where
  ``j != i``), put through a softmax over ``j`` and dropped (rate 0.3);
* ``out_i = sum_h sum_j alpha_ijh s_jh``, then LayerNorm and leaky ReLU.

The branches' outputs are concatenated and go through a linear layer
``squeeze`` to ``F``, and the input is added back, through a linear layer
``map`` where its width is not ``F``.

Departures from the published network, each the port's as well:

* dropout masks are the keep hash of each element's flat index
  (:mod:`portbench.reference.hashing`) under a seed drawn from the run's
  generator, where the published network draws them from torch's; the law
  is the same. The masks are drawn, as the program draws them, layer by
  layer and branch by branch: the input's, then the attention's;
* leaky ReLU is ``where(x >= 0, x, 0.01 x)``, whose gradient at exactly 0
  is 1 (a LayerNorm's output on a padded row is its bias);
* the published ``LeakyReLU(True)`` between ``mlp`` and ``class_output``
  has slope 1, the identity: nothing runs there;
* the weights are random from the run's seed (:func:`leaves`).

``Rounding`` puts every operand of a product and every stored activation
through a lower precision, for the control of the output check.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.flagship import (  # noqa: F401  (the reference's interface, as flagship.py's)
    Draws,
    Rounding,
    dropout,
    masked_cross_entropy,
    plain_float32,
    train_steps,
)

MASKED = -9e15
HEADS = 4
RATIO = 16
WIDTH = 256  # every GAT layer's output
DROPOUT_RATE = 0.3
SLOPE = 0.01
LAYER_NORM_EPS = 1e-5


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, SLOPE * x)


def layer_inputs(input_feature: int) -> List[Tuple[str, int]]:
    """Each GAT layer's name in the state dict and the width it reads."""
    return [("gat_in", input_feature), ("dense_gat.layer_0", WIDTH), ("dense_gat.layer_1", 2 * WIDTH),
            ("dense_gat.squeeze_block", 3 * WIDTH), ("gat_out", WIDTH)]


@dataclasses.dataclass
class GATv2Network:
    """The network's hyper-parameters, as the configuration states them."""

    no_A: int
    rounding: Rounding = dataclasses.field(default_factory=Rounding)
    dropout_rate: float = DROPOUT_RATE

    def _dense(self, p, name, x):
        q = self.rounding
        return q(q(x) @ q(p[name + ".weight"]).t() + q(p[name + ".bias"]))

    def _dropout(self, x, draws: Optional[Draws]):
        if draws is None:
            return x
        return self.rounding(dropout(x, draws.seed(), self.dropout_rate))

    def _branch(self, p, name, l, V, adj, draws):
        q = self.rounding
        B, N, _ = V.shape
        sq = WIDTH // RATIO
        x = self._dropout(V, draws)
        s = q(q(x) @ q(p[f"{name}.W_src_{l}"])).reshape(B, N, HEADS, sq)
        d = q(q(x) @ q(p[f"{name}.W_dst_{l}"])).reshape(B, N, HEADS, sq)
        pairs = q(leaky_relu(q(s[:, :, None] + d[:, None])))  # (B, N_i, N_j, H, sq)
        scores = q((pairs * q(p[f"{name}.a_{l}"]).reshape(HEADS, sq)).sum(-1))  # (B, N_i, N_j, H)
        if l < self.no_A:
            edges = adj[:, :, l, :] > 0
        else:
            edges = torch.eye(N, dtype=torch.bool, device=V.device).expand(B, N, N)
        scores = torch.where(edges[..., None], scores, MASKED)
        alpha = self._dropout(q(torch.softmax(scores, dim=2)), draws)
        out = q(torch.einsum("bijh,bjhc->bic", q(alpha), s))
        norm = f"{name}.norm_{l}.norm"
        return leaky_relu(q(F.layer_norm(out, (sq,), q(p[norm + ".scale"]), q(p[norm + ".bias"]), LAYER_NORM_EPS)))

    def _layer(self, p, name, V, adj, draws):
        branches = [self._branch(p, name, l, V, adj, draws) for l in range(self.no_A + 1)]
        out = self._dense(p, f"{name}.squeeze", torch.cat(branches, dim=-1))
        residual = self._dense(p, f"{name}.map", V) if f"{name}.map.weight" in p else V
        return self.rounding(out + residual)

    def forward(self, p: Dict[str, torch.Tensor], x: torch.Tensor, adj: torch.Tensor,
                draws: Optional[Draws]) -> torch.Tensor:
        """Logits in float32; ``draws=None`` is the eval-mode forward."""
        h = self._layer(p, "gat_in", x, adj, draws)
        stacked = h
        for r in range(2):
            stacked = torch.cat([stacked, self._layer(p, f"dense_gat.layer_{r}", stacked, adj, draws)], dim=-1)
        h = self._layer(p, "dense_gat.squeeze_block", stacked, adj, draws)
        h = self._layer(p, "gat_out", h, adj, draws)
        return self._dense(p, "class_output", self._dense(p, "mlp", h)).float()


def network(model: Dict, rounding: str = "float32") -> GATv2Network:
    """The network of a configuration's ``model`` block (``GATV2``'s
    constructor arguments), rounding to ``rounding`` everywhere."""
    if not model.get("use_v2", True):
        raise ValueError("the reference implements GATv2 layers (use_v2 true) only")
    return GATv2Network(no_A=model["no_A"], rounding=Rounding(rounding))


def leaves(model: Dict) -> List[Tuple[str, Tuple[int, ...], float]]:
    """Every tensor of ``GATV2``'s state dict for the constructor arguments
    ``model`` (``input_feature``, ``no_A``, ``output_feature``,
    ``num_classes``), as ``(name, shape, spread)``: xavier's for the
    attention's projections and vectors, lecun's for a linear layer's
    weight, 1 for a LayerNorm's scale and 0.01 for a bias."""
    L, out, C = model["no_A"], model.get("output_feature", 128), model["num_classes"]
    sq = WIDTH // RATIO

    def dense(name, fan_in, fan_out):
        return [(f"{name}.weight", (fan_out, fan_in), math.sqrt(1.0 / fan_in)), (f"{name}.bias", (fan_out,), 0.01)]

    found = []
    for name, fan_in in layer_inputs(model["input_feature"]):
        for l in range(L + 1):
            spread = math.sqrt(2.0 / (fan_in + HEADS * sq))
            found += [(f"{name}.W_src_{l}", (fan_in, HEADS * sq), spread),
                      (f"{name}.W_dst_{l}", (fan_in, HEADS * sq), spread),
                      (f"{name}.a_{l}", (1, 1, 1, HEADS, sq), math.sqrt(2.0 / (HEADS + sq))),
                      (f"{name}.norm_{l}.norm.scale", (sq,), 1.0), (f"{name}.norm_{l}.norm.bias", (sq,), 0.01)]
        found += dense(f"{name}.squeeze", (L + 1) * sq, WIDTH)
        if fan_in != WIDTH:
            found += dense(f"{name}.map", fan_in, WIDTH)
    return found + dense("mlp", WIDTH, out) + dense("class_output", out, C)
