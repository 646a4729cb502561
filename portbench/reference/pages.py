"""Sumi-style synthetic pages, frozen, and the tables a run encodes them with.

A copy of the repository's page generator (``synthetic_page``): key
textlines carry their class name, value textlines class-typical content,
in a key-left / value-right table layout, with noise lines below. A page
of ``rows`` rows and ``noise`` noise lines has ``2 rows + noise`` boxes.
The classes are the generator's seven and numbered fields up to the
configuration's count; the charset is every character of the pages' text,
lowercased, padded with CJK ideographs to the configuration's size, as
the sumi charset's width (4365 characters) demands.
"""
from __future__ import annotations

import random
import string
from typing import Any, Dict, List, Tuple

DEFAULT_CLASSES = ["company_name", "invoice_number", "issue_date", "total_amount", "tax_amount", "address",
                   "phone_number"]

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


def synthetic_page(seed: int, num_rows: int, noise_lines: int, classes: List[str], page_w: int = 1200,
                   row_h: int = 40) -> List[Dict[str, Any]]:
    """One cassia-format page: a list of ``{location, text, label, key_type}``."""
    rng = random.Random(seed)
    lines: List[Dict[str, Any]] = []
    y = 20.0
    for _ in range(num_rows):
        cls = rng.choice(classes)
        key_w = 30 + 8 * len(cls)
        jitter = rng.uniform(-4, 4)
        lines.append({"location": _box(40 + jitter, y, key_w, row_h * 0.8), "text": cls.replace("_", " ") + ":",
                      "label": cls, "key_type": "key"})
        value_text = _VALUE_STYLES.get(cls, lambda r: "???")(rng)
        lines.append({"location": _box(80 + key_w + rng.uniform(0, 30), y, 20 + 9 * len(value_text), row_h * 0.8),
                      "text": value_text, "label": cls, "key_type": "value"})
        y += row_h * rng.uniform(1.0, 1.4)
    for _ in range(noise_lines):
        text = "".join(rng.choices(string.ascii_lowercase + string.digits + " ", k=rng.randint(4, 20)))
        lines.append({"location": _box(rng.uniform(20, page_w - 300), y + rng.uniform(0, 200), 30 + 8 * len(text),
                                       row_h * 0.8),
                      "text": text, "label": None, "key_type": None})
    return lines


def rows_for(boxes: int) -> Tuple[int, int]:
    """``(rows, noise lines)`` of a page of ``boxes`` boxes: ten or eleven
    noise lines, the rest in key-value rows."""
    noise = 10 + boxes % 2
    return (boxes - noise) // 2, noise


def class_names(count: int) -> List[str]:
    return list(DEFAULT_CLASSES) + [f"field_{i:02d}" for i in range(count - len(DEFAULT_CLASSES))]


def charset_of(pages: List[List[Dict[str, Any]]], size: int) -> List[str]:
    chars = set("0()-.,")
    for page in pages:
        for box in page:
            chars.update(box["text"].lower())
    pad = (chr(0x4E00 + i) for i in range(size))
    while len(chars) < size:
        chars.add(next(pad))
    return sorted(chars)
