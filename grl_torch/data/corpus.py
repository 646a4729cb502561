"""Offline charset and class-list generation from labeled data folders.

Copy of ``grl_tpu/data/corpus.py`` (:17-67): scans annotation JSONs (the
cassia, datapile and dm formats), collects the normalized character
corpus and the formal-key class names, and writes ``charset.json`` and
``classes.json`` in the layout the dataset configs read.
"""
from __future__ import annotations

import os
from typing import Iterable, List, Tuple

from grl_torch.data.normalize_text import normalize_text
from grl_torch.utils.json_handler import read_json, write_json


def _iter_annotation_texts(sample) -> Iterable[Tuple[str, str]]:
    """Yield (text, formal_key) pairs from any supported label format."""
    if isinstance(sample, list):  # cassia
        for region in sample:
            yield str(region.get("text", "")), region.get("formal_key") or region.get("label")
        return
    regions = None
    if isinstance(sample, dict):
        try:
            regions = sample["attributes"]["_via_img_metadata"]["regions"]  # datapile
        except (KeyError, TypeError):
            regions = sample.get("regions")  # dm
            if regions is None:
                for value in sample.values():
                    if isinstance(value, dict) and "regions" in value:
                        regions = value["regions"]
                        break
    for region in regions or []:
        attr = region.get("region_attributes", {})
        text = attr.get("label") or attr.get("text") or ""
        yield str(text), attr.get("formal_key")


def build_corpus_and_classes(
    data_folders: List[str],
    output_dir: str,
    normalized: bool = True,
) -> Tuple[str, str]:
    """Scan folders of annotation JSONs -> (charset_path, classes_path).
    A file that does not parse as JSON is skipped, as ``grl_tpu`` skips it."""
    charset: set = set()
    classes: set = set()
    for folder in data_folders:
        if not os.path.isdir(folder):
            continue
        for name in sorted(os.listdir(folder)):
            path = os.path.join(folder, name)
            try:
                sample = read_json(path)
            except (OSError, ValueError):
                continue
            for text, formal_key in _iter_annotation_texts(sample):
                charset.update(normalize_text(text) if normalized else text)
                if formal_key:
                    classes.add(str(formal_key))
    os.makedirs(output_dir, exist_ok=True)
    charset_path = os.path.join(output_dir, "charset.json")
    classes_path = os.path.join(output_dir, "classes.json")
    write_json({"charset": sorted(charset)}, charset_path)
    write_json({"classes": sorted(classes)}, classes_path)
    return charset_path, classes_path
