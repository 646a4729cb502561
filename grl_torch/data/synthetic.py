"""Synthetic sumi-style document pages for tests, demos and benchmarks.

The reference's sumi KV dataset is private (labels were only on a private
Neptune project — reference: README.md, gnn/utils/constant.py:5-8), so the
framework ships a generator that produces cassia-format pages with
learnable structure: key textlines carry their class name as text, value
textlines carry class-typical content, and spatial layout follows a
key-left/value-right table pattern. A model that uses both BOW and graph
structure can reach high F1; a broken pipeline cannot.
"""
from __future__ import annotations

import random
import string
from typing import Any, Dict, List, Tuple

DEFAULT_CLASSES = [
    "company_name",
    "invoice_number",
    "issue_date",
    "total_amount",
    "tax_amount",
    "address",
    "phone_number",
]
KEY_TYPES = ["key", "value"]

_VALUE_STYLES = {
    "company_name": lambda rng: "".join(rng.choices(string.ascii_uppercase, k=8)),
    "invoice_number": lambda rng: "INV-" + "".join(rng.choices(string.digits, k=6)),
    "issue_date": lambda rng: f"{rng.randint(2000, 2026)}/{rng.randint(1, 12):02d}/{rng.randint(1, 28):02d}",
    "total_amount": lambda rng: f"¥{rng.randint(1000, 999999):,}",
    "tax_amount": lambda rng: f"¥{rng.randint(10, 9999):,} (10%)",
    "address": lambda rng: "".join(rng.choices(string.ascii_lowercase + " ", k=16)),
    "phone_number": lambda rng: f"0{rng.randint(10, 99)}-{rng.randint(1000, 9999)}-{rng.randint(1000, 9999)}",
}


def _box(x: float, y: float, w: float, h: float) -> List[List[float]]:
    return [[x, y], [x + w, y], [x + w, y + h], [x, y + h]]


def synthetic_page(
    seed: int,
    num_rows: int = 12,
    noise_lines: int = 6,
    classes: List[str] = None,
    page_w: int = 1200,
    row_h: int = 40,
) -> List[Dict[str, Any]]:
    """One cassia-format page: list of {location, text, label, key_type}."""
    rng = random.Random(seed)
    classes = classes or DEFAULT_CLASSES
    lines: List[Dict[str, Any]] = []
    y = 20.0
    for _ in range(num_rows):
        cls = rng.choice(classes)
        key_w = 30 + 8 * len(cls)
        jitter = rng.uniform(-4, 4)
        lines.append(
            {
                "location": _box(40 + jitter, y, key_w, row_h * 0.8),
                "text": cls.replace("_", " ") + ":",
                "label": cls,
                "key_type": "key",
            }
        )
        value_text = _VALUE_STYLES.get(cls, lambda r: "???")(rng)
        lines.append(
            {
                "location": _box(80 + key_w + rng.uniform(0, 30), y, 20 + 9 * len(value_text), row_h * 0.8),
                "text": value_text,
                "label": cls,
                "key_type": "value",
            }
        )
        y += row_h * rng.uniform(1.0, 1.4)
    for _ in range(noise_lines):
        text = "".join(rng.choices(string.ascii_lowercase + string.digits + " ", k=rng.randint(4, 20)))
        lines.append(
            {
                "location": _box(
                    rng.uniform(20, page_w - 300),
                    y + rng.uniform(0, 200),
                    30 + 8 * len(text),
                    row_h * 0.8,
                ),
                "text": text,
                "label": None,
                "key_type": None,
            }
        )
    return lines


def synthetic_dataset_files(
    out_dir: str,
    num_pages: int = 16,
    seed: int = 0,
    classes: List[str] = None,
) -> Tuple[str, str, str]:
    """Write pages + classes.json + charset.json; returns their paths."""
    import json
    import os

    classes = classes or DEFAULT_CLASSES
    data_dir = os.path.join(out_dir, "pages")
    os.makedirs(data_dir, exist_ok=True)
    charset = set()
    for i in range(num_pages):
        page = synthetic_page(seed * 10_000 + i, classes=classes)
        for line in page:
            charset.update(line["text"].lower())
        with open(os.path.join(data_dir, f"page_{i:04d}.json"), "w") as handle:
            json.dump(page, handle)
    classes_path = os.path.join(out_dir, "classes.json")
    charset_path = os.path.join(out_dir, "charset.json")
    with open(classes_path, "w") as handle:
        json.dump({"classes": classes}, handle)
    charset |= set("0()-.,")
    with open(charset_path, "w") as handle:
        json.dump({"charset": sorted(charset)}, handle)
    return data_dir, classes_path, charset_path
