"""Datasets for the three supported annotation formats.

Mirrors the reference dataset trio (reference:
gnn/data_generator/datasets/datapile_dataset.py, dm_dataset.py,
cassia_dataset.py) with one shared base class instead of three
near-duplicate 270-line files. A dataset yields a processed sample dict
per index; the processor chain comes from config via the registry.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

from grl_torch.config import ConfigDict
from grl_torch.data import augmentor as augmentor_module
from grl_torch.data import processors as processors_module
from grl_torch.utils.json_handler import read_json
from grl_torch.utils.logging import get_logger


class BaseDataset:
    """Charset/class tables + processor chain + sample list."""

    def __init__(self, data_config: Union[Dict[str, Any], ConfigDict], **kwargs: Any):
        self.data_config = ConfigDict(data_config)
        self.logger = get_logger(self.__class__.__name__)
        self.list_samples = self._load_samples(kwargs.get("samples"))
        self.charset = self._load_charset()
        self.char_to_id = {ch: i for i, ch in enumerate(self.charset)}
        self.id_to_char = {i: ch for ch, i in self.char_to_id.items()}
        self.classes, self.key_types = self._load_classes()
        self.class_to_id, self.id_to_class = self._map_class_to_id(
            self.classes, self.key_types
        )
        self.data_processors = self._load_data_processors()
        self.logger.info(
            f"Initialized {kwargs.get('data_type', 'dataset')}: "
            f"{len(self.list_samples)} samples"
        )

    @classmethod
    def _from_config(cls, config: Union[Dict[str, Any], ConfigDict], **kwargs: Any):
        return cls(config, **kwargs)

    # ------------------------------------------------------------------
    def _load_samples(self, samples: Optional[Any]) -> List[Any]:
        if isinstance(samples, list):
            return samples
        paths: List[str] = []
        if isinstance(samples, (str, Path)):
            paths = self._list_folder(str(samples))
        elif self.data_config.get("data_path"):
            for folder in self.data_config.data_path:
                paths.extend(self._list_folder(folder))
        loaded = [read_json(p) for p in sorted(paths)]
        if not loaded:
            self.logger.warning("No dataset samples found.")
        return loaded

    def _list_folder(self, folder: str) -> List[str]:
        if not os.path.isdir(folder):
            self.logger.warning(f"Invalid data path: {folder}")
            return []
        return [os.path.join(folder, name) for name in sorted(os.listdir(folder))]

    def _load_charset(self) -> List[str]:
        path = self.data_config.get("charset_path")
        if not path:
            self.logger.error("No charset configured!")
            return []
        return read_json(path)["charset"]

    def _load_classes(self) -> Tuple[List[str], List[str]]:
        path = self.data_config.get("class_path")
        classes = read_json(path)["classes"] if path else []
        if not path:
            self.logger.error("No class list configured!")
        return classes, list(self.data_config.get("key_types", []))

    @staticmethod
    def _map_class_to_id(
        classes: List[str], key_types: List[str]
    ) -> Tuple[Dict[str, Dict[str, int]], Dict[int, Tuple[str, str]]]:
        """``cls_idx = class_idx * len(key_types) + key_type_idx + 1``;
        0 is background (reference: datapile_dataset.py:173-195)."""
        class_to_id: Dict[str, Dict[str, int]] = {}
        id_to_class: Dict[int, Tuple[str, str]] = {}
        for idx, label in enumerate(classes):
            class_to_id[label] = {}
            for k_id, key_type in enumerate(key_types):
                cls_idx = idx * len(key_types) + k_id + 1
                class_to_id[label][key_type] = cls_idx
                id_to_class[cls_idx] = (label, key_type)
        return class_to_id, id_to_class

    def _load_data_processors(self) -> List[Any]:
        """``augmentations`` from the augmentors, then ``data_process``:
        each name from the processors, else from the augmentors, so that
        an augmentor that needs the built features and graph (node
        dropping, DGI negatives) can run after the builder."""
        chain: List[Any] = []
        for name, args in dict(self.data_config.get("augmentations", {}) or {}).items():
            cls = getattr(augmentor_module, name, None)
            if cls is None:
                raise KeyError(f"Augmentor {name!r} is not in grl_torch.data.augmentor")
            chain.append(cls._from_config(args))
        for name, args in dict(self.data_config.get("data_process", {}) or {}).items():
            cls = getattr(processors_module, name, None) or getattr(augmentor_module, name, None)
            if cls is None:
                raise KeyError(
                    f"Data processor {name!r} is neither in grl_torch.data.processors nor in "
                    "grl_torch.data.augmentor"
                )
            chain.append(cls._from_config(args))
        return chain

    # ------------------------------------------------------------------
    def _load_annotations(self, sample: Any) -> Dict[int, Dict[str, Any]]:
        raise NotImplementedError

    def __getitem__(self, index: int) -> Dict[str, Any]:
        sample = {
            "label": self._load_annotations(self.list_samples[index]),
            "charset": self.charset,
            "classes": self.classes,
            "char_to_id": self.char_to_id,
            "id_to_char": self.id_to_char,
            "class_to_id": self.class_to_id,
            "id_to_class": self.id_to_class,
        }
        if "ignored_classes" in self.data_config:
            sample["ignored_classes"] = self.data_config.ignored_classes
        for processor in self.data_processors:
            sample = processor(sample)
        return sample

    def __len__(self) -> int:
        return len(self.list_samples)


def _region_polygon(shape_attr: Dict[str, Any]) -> List[Tuple[float, float]]:
    if shape_attr.get("name") == "polygon":
        return list(zip(shape_attr["all_points_x"], shape_attr["all_points_y"]))
    x1, y1 = shape_attr["x"], shape_attr["y"]
    x2, y2 = x1 + shape_attr["width"], y1 + shape_attr["height"]
    return [(x1, y1), (x2, y1), (x2, y2), (x1, y2)]


class DatapileDataset(BaseDataset):
    """VIA-format labels (reference: datapile_dataset.py:197-241): text
    comes from region attribute ``label``, class from ``formal_key``."""

    def _load_annotations(self, sample: Dict[str, Any]) -> Dict[int, Dict[str, Any]]:
        try:
            regions = sample["attributes"]["_via_img_metadata"]["regions"]
        except KeyError:
            regions = next(iter(sample.values()))["regions"]
        annotations: Dict[int, Dict[str, Any]] = {}
        for idx, region in enumerate(regions):
            attr = region.get("region_attributes", {})
            shape = region.get("shape_attributes", {})
            try:
                annotation = {
                    "polygon": _region_polygon(shape),
                    "text": str(attr.get("label", "")),
                    "label": attr.get("formal_key"),
                    "key_type": attr.get("key_type"),
                }
            except KeyError as err:
                self.logger.error(err)
                continue
            if annotation["text"]:
                annotations[idx] = annotation
        return annotations


class DMDataset(BaseDataset):
    """Flat ``regions`` labels (reference: dm_dataset.py:197-237): text from
    ``text``, key type from ``structure_type``."""

    def _load_annotations(self, sample: Dict[str, Any]) -> Dict[int, Dict[str, Any]]:
        annotations: Dict[int, Dict[str, Any]] = {}
        for idx, region in enumerate(sample["regions"]):
            attr = region.get("region_attributes", {})
            shape = region.get("shape_attributes", {})
            annotation = {
                "polygon": _region_polygon(shape),
                "text": str(attr.get("text", "")),
                "label": attr.get("formal_key"),
                "key_type": attr.get("structure_type"),
            }
            if annotation["text"]:
                annotations[idx] = annotation
        return annotations


class CassiaDataset(BaseDataset):
    """Raw OCR output lists (reference: cassia_dataset.py:199-212); used by
    inference. ``location`` is aliased to ``polygon``."""

    def _load_annotations(self, sample: List[Dict[str, Any]]) -> Dict[int, Dict[str, Any]]:
        annotations: Dict[int, Dict[str, Any]] = {}
        for idx, region in enumerate(sample):
            region = dict(region)
            region["polygon"] = region["location"]
            annotations[idx] = region
        return annotations
