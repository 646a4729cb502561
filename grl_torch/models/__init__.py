from grl_torch.models.base import (
    MODEL_REGISTRY,
    count_parameters,
    create_model,
    register_model,
)
from grl_torch.models.convert import optimizer_state_from_optax, state_dict_from_flax
from grl_torch.models.gcn_family import GCNTrunk, GraphCNNDropEdge
from grl_torch.models.ssl_gcn import DGI, SSL_TASKS, SSLGCN, Discriminator, ReadOut
from grl_torch.models.layers import (
    Dense,
    Dropout,
    EdgeDropout,
    GraphConv,
    LinearReLU,
    NodeSelfAtten,
    RanPAC,
    Rngs,
)

__all__ = [
    "MODEL_REGISTRY",
    "count_parameters",
    "create_model",
    "register_model",
    "optimizer_state_from_optax",
    "state_dict_from_flax",
    "GCNTrunk",
    "GraphCNNDropEdge",
    "DGI",
    "SSL_TASKS",
    "SSLGCN",
    "Discriminator",
    "ReadOut",
    "Dense",
    "Dropout",
    "EdgeDropout",
    "GraphConv",
    "LinearReLU",
    "NodeSelfAtten",
    "RanPAC",
    "Rngs",
]
