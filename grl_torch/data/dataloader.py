"""Config-driven dataset factory.

The part of ``grl_tpu/data/dataloader.py`` that serving needs:
:class:`BaseDataLoader` resolves dataset classes by name from the YAML
config. The collate chain and the batch iterator (``DataLoader``,
prefetching) arrive with the training slice.
"""
from __future__ import annotations

from typing import Any

from grl_torch.config import ConfigDict
from grl_torch.data import datasets as datasets_module
from grl_torch.utils.logging import get_logger


class BaseDataLoader:
    """Config-driven loader factory (reference: base_dataloader.py:16-112)."""

    def __init__(self, config: ConfigDict):
        self.config = ConfigDict(config)
        self.logger = get_logger(self.__class__.__name__)

    def _load_dataset(self, dataset_type: str, args: Any, **kwargs: Any):
        cls = getattr(datasets_module, dataset_type)
        return cls._from_config(ConfigDict(args), **kwargs)
