"""``GraphCNNDropEdge`` trained by plain float32 PyTorch.

The flagship as its published description and the program's configuration
state it: ``emb1`` (Linear, ReLU, dropout) → three relational graph
convolutions with skip concatenations (``[self | rel_0 .. rel_{L-1}] @ W +
b``, DropEdge on the adjacency and its self loops, ReLU, dropout) →
``emb2`` (Linear, ReLU) → optional SAGAN-style node self-attention (dense,
per page) → a frozen random projection (ReLU, dropout) → a linear
classifier; masked mean cross-entropy, a global-norm clip and Adam.

Every random mask is worked out again here from the run's seed. The
program draws them, in one fixed order, from one generator seeded with
the procedure's seed: for each dropout layer a one-element int32 seed, for
each convolution's DropEdge a seed and then a uniform draw over the self
loops. :class:`Draws` makes the same calls on a generator of its own; the
masks are then the keep hash (:mod:`portbench.reference.hashing`) of each
element's flat index (dropout), each edge's position in the graph's edge
arrays (a sparse graph) or each adjacency element's flat index (a dense
one).

Adjacencies: :class:`SparseGraph` (one static graph, flat nodes) and a
dense ``(B, N, L, N)`` tensor (pages). ``Rounding`` puts every operand of
a product and every stored activation through a lower precision, so that
the same code serves as the control of the output check.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.hashing import keep_bits, keep_scale, keep_scaled

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def plain_float32() -> None:
    """float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# Precision of a run of the reference
# ---------------------------------------------------------------------------
def _fp8(x: torch.Tensor) -> torch.Tensor:
    """Per-tensor scaled float8 e4m3 round trip."""
    amax = x.detach().abs().amax()
    scale = torch.where(amax > 0, amax / 448.0, torch.ones_like(amax))
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


ROUNDINGS: Dict[str, Optional[Callable[[torch.Tensor], torch.Tensor]]] = {
    "float32": None,
    "bfloat16": lambda x: x.to(torch.bfloat16).to(x.dtype),
    "float8": _fp8,
}


@dataclasses.dataclass
class Rounding:
    """Where the program computes in its compute dtype, the reference
    rounds to ``name`` (both ways: values forward, gradients backward);
    ``float32`` rounds nothing."""

    name: str = "float32"

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        fn = ROUNDINGS[self.name]
        return x if fn is None else _Round.apply(x, fn)


# ---------------------------------------------------------------------------
# Masks
# ---------------------------------------------------------------------------
class Draws:
    """The program's draws, made again: a generator on ``device`` seeded with
    the procedure's seed, drawn in the program's order."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(int(seed))

    def seed(self) -> torch.Tensor:
        return torch.randint(0, 2**31 - 1, (1,), generator=self.generator, device=self.device, dtype=torch.int32)

    def uniform(self, shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.generator, device=self.device)


def dropout(x: torch.Tensor, seed: torch.Tensor, rate: float) -> torch.Tensor:
    """Dropout keyed on each element's flat index."""
    kept = keep_bits(torch.arange(x.numel(), device=x.device), seed, rate).view(x.shape)
    return torch.where(kept, x * keep_scale(rate), torch.zeros((), dtype=x.dtype, device=x.device))


# ---------------------------------------------------------------------------
# Adjacencies
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class SparseGraph:
    """One static relational graph on flat nodes: edge ``e`` carries
    ``weights[e] * x[senders[e]]`` into relation ``relations[e]`` of node
    ``receivers[e]``; ``gid[e]`` is its position in the edge arrays the
    benchmark made, which its DropEdge mask is keyed on."""

    senders: torch.Tensor
    receivers: torch.Tensor
    relations: torch.Tensor
    weights: torch.Tensor
    gid: torch.Tensor
    num_nodes: int
    num_relations: int

    def self_shape(self):
        return (self.num_nodes,)

    def aggregate(self, v: torch.Tensor, seed: Optional[torch.Tensor], rate: float) -> torch.Tensor:
        """``(N, L*F)``: for each node and relation, the kept edges' sum."""
        w = self.weights
        if seed is not None:
            w = w * keep_scaled(self.gid, seed, rate)
        rows = self.receivers.long() * self.num_relations + self.relations.long()
        out = torch.zeros(self.num_nodes * self.num_relations, v.shape[-1], dtype=v.dtype, device=v.device)
        out.index_add_(0, rows, v[self.senders.long()] * w[:, None].to(v.dtype))
        return out.reshape(self.num_nodes, self.num_relations * v.shape[-1])


def degree_order(receivers: np.ndarray, num_nodes: int, width_quantum: int, bucket_growth: int) -> np.ndarray:
    """The node order of a graph planned with ``reorder: degree``: nodes
    grouped by the width bucket of their in-degree (widths from
    ``width_quantum`` up to the largest degree, arithmetic at
    ``bucket_growth`` 1, geometric above), stably. Returns ``perm``: node
    ``i`` sits at row ``perm[i]``."""
    counts = np.bincount(np.asarray(receivers, np.int64), minlength=num_nodes)
    widths = [width_quantum]
    while widths[-1] < max(int(counts.max()), 1):
        widths.append(widths[-1] * bucket_growth if bucket_growth > 1 else widths[-1] + width_quantum)
    bucket_of = np.searchsorted(np.asarray(widths), counts)
    order = np.argsort(bucket_of, kind="stable")
    perm = np.empty(num_nodes, np.int64)
    perm[order] = np.arange(num_nodes)
    return perm


def dense_aggregate(v: torch.Tensor, A: torch.Tensor, seed: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    """``(B, N, L*F)``: ``sum_m A[b, n, l, m] * v[b, m]``, each element of A
    DropEdge'd by the hash of its flat index."""
    if seed is not None:
        B, N, L, M = A.shape
        A = A * keep_scaled(torch.arange(A.numel(), device=A.device), seed, rate).view(B, N, L, M).to(A.dtype)
    out = torch.einsum("bnlm,bmf->bnlf", A, v)
    return out.reshape(*out.shape[:2], -1)


# ---------------------------------------------------------------------------
# The network
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Flagship:
    """The network's hyper-parameters, as the configuration states them."""

    dropout_rate: float = 0.5
    edge_dropout_rate: float = 0.3
    use_attention: bool = False
    rounding: Rounding = dataclasses.field(default_factory=Rounding)

    def _dense(self, p, name, x):
        q = self.rounding
        return q(q(x) @ q(p[name + ".weight"]).t() + q(p[name + ".bias"]))

    def _dropout(self, x, draws: Optional[Draws]):
        if draws is None or self.dropout_rate <= 0.0:
            return x
        return self.rounding(dropout(x, draws.seed(), self.dropout_rate))

    def _conv(self, p, name, v, adj, draws: Optional[Draws]):
        q = self.rounding
        seed, self_scale = None, None
        if draws is not None and self.edge_dropout_rate > 0.0:
            keep = 1.0 - self.edge_dropout_rate
            # A seed for the hashed edge mask, then the self loops.
            seed = draws.seed()
            shape = adj.self_shape() if isinstance(adj, SparseGraph) else tuple(v.shape[:-1])
            self_scale = (draws.uniform(shape) < keep).to(torch.float32) / keep
        v = q(v)
        if isinstance(adj, SparseGraph):
            neigh = adj.aggregate(v, seed, self.edge_dropout_rate)
        else:
            neigh = dense_aggregate(v, q(adj), seed, self.edge_dropout_rate)
        neigh = q(neigh)
        self_term = v if self_scale is None else q(v * self_scale[..., None])
        W = q(p[name + ".h_weights"])
        F_in = v.shape[-1]
        out = q(self_term @ W[:F_in]) + q(neigh @ W[F_in:])
        out = q(out + q(p[name + ".bias"]))
        return self._dropout(F.relu(out), draws)

    def _attention(self, p, v):
        q = self.rounding
        f = F.relu(self._dense(p, "trunk.self_atten.f.linear", v))
        g = F.relu(self._dense(p, "trunk.self_atten.g.linear", v))
        h = F.relu(self._dense(p, "trunk.self_atten.h.linear", v))
        scores = q(f @ g.transpose(-1, -2))
        s = q(torch.softmax(scores, dim=-1))
        o = q(s @ h)
        return q(q(p["trunk.self_atten.gamma"]) * o + v)

    def forward(self, p: Dict[str, torch.Tensor], x: torch.Tensor, adj, draws: Optional[Draws]) -> torch.Tensor:
        """Logits in float32; ``draws=None`` is the eval-mode forward."""
        q = self.rounding
        emb = self._dropout(F.relu(self._dense(p, "trunk.emb1.linear", x)), draws)
        g1 = self._conv(p, "trunk.gcn1", emb, adj, draws)
        g2 = self._conv(p, "trunk.gcn2", g1, adj, draws)
        g3 = self._conv(p, "trunk.gcn3", torch.cat([g1, g2], dim=-1), adj, draws)
        new_v = F.relu(self._dense(p, "trunk.emb2.linear", torch.cat([g1, g3], dim=-1)))
        if self.use_attention:
            new_v = self._attention(p, new_v)
        h = self._dropout(F.relu(q(q(new_v) @ q(p["w_rand.kernel"]))), draws)
        return self._dense(p, "classifier", h).float()


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the targets that are not -100."""
    logits = logits.reshape(-1, logits.shape[-1]).float()
    labels = labels.reshape(-1)
    keep = labels != -100
    nll = -torch.gather(F.log_softmax(logits, dim=-1), 1, torch.where(keep, labels, 0).long()[:, None])[:, 0]
    return (nll * keep).sum() / keep.sum().clamp(min=1)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Steps:
    """What a reference run of a few steps gives: each step's loss, the
    clipped gradient of the first step, the parameters after the last, the
    first step's logits and the state of the draws' generator after the
    last step."""

    losses: List[float]
    first_grad: Dict[str, torch.Tensor]
    params: Dict[str, torch.Tensor]
    first_logits: torch.Tensor
    draws_state: torch.Tensor


def train_steps(net: Flagship, weights: Dict[str, torch.Tensor], batches: Sequence, draws: Draws, lr: float,
                max_grad_norm: float, on_step: Optional[Callable[[int], None]] = None) -> Steps:
    """One step per ``(x, adj, labels)`` of ``batches``: forward with the
    masks of ``draws``, masked cross-entropy, backward, the global-norm
    clip, Adam (torch's defaults: betas 0.9, 0.999, eps 1e-8, bias
    correction). ``weights`` holds every tensor of the model by its name in
    the program's state dict; those whose name ends in ``kernel`` (the
    frozen projection) are not trained. ``on_step(t)``, where given, is
    called before step ``t`` (from 1) draws anything."""
    params = {k: v.detach().clone().float().requires_grad_(not k.endswith("kernel")) for k, v in weights.items()}
    trained = [k for k in params if params[k].requires_grad]
    m = {k: torch.zeros_like(params[k]) for k in trained}
    v = {k: torch.zeros_like(params[k]) for k in trained}
    b1, b2 = ADAM_BETAS
    losses, first_grad = [], {}
    for t, (x, adj, labels) in enumerate(batches, start=1):
        for k in trained:
            params[k].grad = None
        if on_step is not None:
            on_step(t)
        logits = net.forward(params, x, adj, draws)
        if t == 1:
            first_logits = logits.detach().float().cpu()
        loss = masked_cross_entropy(logits, labels)
        loss.backward()
        grads = {k: params[k].grad for k in trained}
        norm = torch.sqrt(sum(g.double().pow(2).sum() for g in grads.values())).float()
        scale = max_grad_norm / torch.clamp(norm, min=max_grad_norm)
        with torch.no_grad():
            for k in trained:
                g = grads[k] * scale
                if t == 1:
                    first_grad[k] = g.clone()
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v[k].sqrt() / (1 - b2**t) ** 0.5).add_(ADAM_EPS)
                params[k].addcdiv_(m[k], denom, value=-lr / (1 - b1**t))
        losses.append(float(loss.detach()))
    return Steps(losses, first_grad, {k: t.detach() for k, t in params.items()}, first_logits,
                 draws.generator.get_state())


@torch.no_grad()
def accuracy(net: Flagship, params: Dict[str, torch.Tensor], x: torch.Tensor, adj, labels: torch.Tensor) -> float:
    """Share of the labelled nodes whose eval-mode argmax is their label."""
    logits = net.forward(params, x, adj, None)
    keep = labels != -100
    return float(((logits.argmax(-1) == labels) & keep).sum() / keep.sum().clamp(min=1))


# ---------------------------------------------------------------------------
# The configuration's model
# ---------------------------------------------------------------------------
def network(model: Dict, rounding: str = "float32") -> Flagship:
    """The network of a configuration's ``model`` block, rounding to
    ``rounding`` where the program computes in its compute dtype."""
    return Flagship(dropout_rate=model["dropout_rate"], edge_dropout_rate=model["edge_dropout_rate"],
                    use_attention=model.get("use_attention", True), rounding=Rounding(rounding))


def leaves(model: Dict) -> List[Tuple[str, Tuple[int, ...], float]]:
    """Every tensor of ``GraphCNNDropEdge``'s state dict for the model
    arguments ``model`` (``input_dim``, ``output_dim``, ``num_edges``,
    ``net_size``, ``rp_factor``, ``use_attention``), as ``(name, shape,
    spread)``: lecun for a linear layer, xavier for a graph convolution's
    stacked weight, 0.01 for a bias, 1 for the frozen projection and the
    attention's gain."""
    I, C, L = model["input_dim"], model["output_dim"], model["num_edges"]
    S = model.get("net_size", 256)
    half, rp = S // 2, S // 2 * model.get("rp_factor", 10)

    def dense(name, fan_in, fan_out):
        return [(f"{name}.weight", (fan_out, fan_in), math.sqrt(1.0 / fan_in)), (f"{name}.bias", (fan_out,), 0.01)]

    def conv(name, fan_in):
        rows = fan_in * (L + 1)
        return [(f"{name}.h_weights", (rows, S), math.sqrt(2.0 / (rows + S))), (f"{name}.bias", (S,), 0.01)]

    out = dense("trunk.emb1.linear", I, S) + conv("trunk.gcn1", S) + conv("trunk.gcn2", S)
    out += conv("trunk.gcn3", 2 * S) + dense("trunk.emb2.linear", 2 * S, half)
    if model.get("use_attention", True):
        out += dense("trunk.self_atten.f.linear", half, half // 8) + dense("trunk.self_atten.g.linear", half, half // 8)
        out += dense("trunk.self_atten.h.linear", half, half) + [("trunk.self_atten.gamma", (half,), 1.0)]
    out += [("w_rand.kernel", (half, rp), 1.0)] + dense("classifier", rp, C)
    return out
