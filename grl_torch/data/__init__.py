from grl_torch.data.collate import BucketPadding, next_bucket, stack_batch
from grl_torch.data.dataloader import BaseDataLoader, DataLoader, prefetch_iter
from grl_torch.data.datasets import (
    BaseDataset,
    CassiaDataset,
    DatapileDataset,
    DMDataset,
)
from grl_torch.data.features import char_bow_matrix, encode_textlines
from grl_torch.data.graph_builder import (
    EDGE_LABELS,
    HeuristicGraph,
    build_heuristic_adjacency,
)
from grl_torch.data.normalize_text import normalize_text
from grl_torch.data.processors import (
    BaseDataProcess,
    HeuristicGraphBuilder,
    NodeLabeling,
    TextlineEncoding,
)

__all__ = [
    "BucketPadding",
    "next_bucket",
    "stack_batch",
    "BaseDataLoader",
    "DataLoader",
    "prefetch_iter",
    "BaseDataset",
    "CassiaDataset",
    "DatapileDataset",
    "DMDataset",
    "char_bow_matrix",
    "encode_textlines",
    "EDGE_LABELS",
    "HeuristicGraph",
    "build_heuristic_adjacency",
    "normalize_text",
    "BaseDataProcess",
    "HeuristicGraphBuilder",
    "NodeLabeling",
    "TextlineEncoding",
]
