"""utf-8-sig JSON IO (reference: gnn/utils/json_handler.py:7-21)."""
from __future__ import annotations

import json
from typing import Any


def read_json(path: str) -> Any:
    with open(path, "r", encoding="utf-8-sig") as handle:
        return json.load(handle)


def write_json(data: Any, path: str, indent: int = 2) -> None:
    with open(path, "w", encoding="utf-8") as handle:
        json.dump(data, handle, ensure_ascii=False, indent=indent)



class JsonHandler:
    """Object-style wrapper kept for API familiarity."""

    @staticmethod
    def read_json_file(path: str) -> Any:
        return read_json(path)

    @staticmethod
    def dump_json_file(data: Any, path: str) -> None:
        write_json(data, path)
