from grl_torch.data.augmentor import BaseAugmentor, DGINegativeSampling, NodeDropAugmentor
from grl_torch.data.collate import (
    BucketPadding,
    NumpyPadding,
    SparseBucketPadding,
    next_bucket,
    stack_batch,
)
from grl_torch.data.corpus import build_corpus_and_classes
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
    CLNodeLabeling,
    EdgeLabeling,
    GraphLabeling,
    HeuristicGraphBuilder,
    NodeLabeling,
    SSLLabeling,
    TextlineEncoding,
)

__all__ = [
    "BaseAugmentor",
    "DGINegativeSampling",
    "NodeDropAugmentor",
    "BucketPadding",
    "NumpyPadding",
    "SparseBucketPadding",
    "next_bucket",
    "stack_batch",
    "build_corpus_and_classes",
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
    "CLNodeLabeling",
    "EdgeLabeling",
    "GraphLabeling",
    "HeuristicGraphBuilder",
    "NodeLabeling",
    "SSLLabeling",
    "TextlineEncoding",
]
