from grl_torch.models.base import (
    MODEL_REGISTRY,
    create_model,
    register_model,
)
from grl_torch.models.convert import state_dict_from_flax
from grl_torch.models.gcn_family import GCNTrunk, GraphCNNDropEdge
from grl_torch.models.layers import (
    Dense,
    EdgeDropout,
    GraphConv,
    LinearReLU,
    NodeSelfAtten,
    RanPAC,
)

__all__ = [
    "MODEL_REGISTRY",
    "create_model",
    "register_model",
    "state_dict_from_flax",
    "GCNTrunk",
    "GraphCNNDropEdge",
    "Dense",
    "EdgeDropout",
    "GraphConv",
    "LinearReLU",
    "NodeSelfAtten",
    "RanPAC",
]
