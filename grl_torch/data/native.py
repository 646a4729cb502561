"""The C++ heuristic graph builder (``native/graph_builder.cpp``) through ctypes.

Counterpart of ``grl_tpu/data/native.py``. The source is compiled with
``g++ -O2 -shared -fPIC`` into
``build/grl_torch/libgrlgraph-<first 16 hex digits of its sha256>.so`` at
the root of the checkout (listed in ``.gitignore``) the first time a
process needs it, under a file lock and to a temporary name that is then
renamed into place, so that processes building at once (pytest-xdist
workers, say) never load a partial file. Nothing is written into
``native/``.

:func:`build_heuristic_adjacency_fast` has ``grl_tpu``'s scope rules: the
native builder serves the ``normal_binary`` edge type on pages of
textlines only; any other edge type, or a page with a cell or table node,
is built by the Python builder, as in ``grl_tpu``. One deliberate
divergence: where ``grl_tpu`` cannot build or load the library it logs a
warning and builds in Python; here that raises, naming the compiler and
the paths.

``pages`` counts the pages each builder built in this process
(``{"native": n, "python": m}``), so that a run can show which one ran.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

import numpy as np

from grl_torch.data.graph_builder import boxes_from_textlines, build_heuristic_adjacency

SOURCE = Path(__file__).resolve().parents[2] / "native" / "graph_builder.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "grl_torch"
COMPILER = "g++"
FLAGS = ("-O2", "-shared", "-fPIC")

# Pages built by each builder in this process.
pages: Dict[str, int] = {"native": 0, "python": 0}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path(source: Optional[Path] = None) -> Path:
    """Where the library built from ``source`` (default :data:`SOURCE`)
    lives: keyed on the source's bytes, so an edited source is rebuilt."""
    source = source or SOURCE
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libgrlgraph-{digest}.so"


def build_library(source: Optional[Path] = None) -> Path:
    """Compile ``source`` (default :data:`SOURCE`) into
    :func:`library_path` unless it is there.

    One process at a time compiles, under an ``fcntl`` lock on
    ``build/grl_torch/libgrlgraph.lock``, to ``<path>.<pid>.tmp``, which is
    then renamed onto the path: a process that finds the path finds a whole
    file. Raises ``RuntimeError`` naming the compiler and the paths where
    ``g++`` is missing or fails.
    """
    source = source or SOURCE
    path = library_path(source)
    if path.exists():
        return path
    compiler = shutil.which(COMPILER)
    if compiler is None:
        raise RuntimeError(
            f"{COMPILER} not found on PATH: the native graph builder ({source}) is compiled "
            f"into {path} at first use. Install {COMPILER}, or set use_native: false in the "
            "HeuristicGraphBuilder config to build graphs in Python."
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libgrlgraph.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            done = subprocess.run([compiler, *FLAGS, "-o", str(tmp), str(source)],
                                  capture_output=True, text=True)
            if done.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"{COMPILER} failed (exit {done.returncode}) building {source} into {path}:\n"
                    f"{done.stderr}"
                )
            os.replace(tmp, path)
    return path


def load_library() -> ctypes.CDLL:
    """The loaded builder, built first if needed, with ``grl_build_edges``'
    signature declared (``grl_tpu/data/native.py:53-60``); once a process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            lib.grl_build_edges.restype = ctypes.c_int
            lib.grl_build_edges.argtypes = [
                ctypes.POINTER(ctypes.c_double),  # boxes (n, 4): x, y, w, h
                ctypes.POINTER(ctypes.c_ubyte),  # has_text (n,)
                ctypes.c_int,  # n
                ctypes.POINTER(ctypes.c_int),  # out (cap, 3): src, label, dst
                ctypes.c_int,  # cap
            ]
            _lib = lib
        return _lib


def native_build_edges(boxes: np.ndarray, has_text: np.ndarray) -> np.ndarray:
    """``(n, 4)`` float64 boxes and ``(n,)`` uint8 text flags -> the
    ``(E, 3)`` int32 edges ``(src, label, dst)``. The output buffer starts at
    16 edges a node and doubles until the builder's edges fit (it returns
    -1 when they do not)."""
    lib = load_library()
    n = len(boxes)
    boxes = np.ascontiguousarray(boxes, dtype=np.float64)
    has_text = np.ascontiguousarray(has_text, dtype=np.uint8)
    cap = max(64, n * 16)
    while True:
        out = np.empty((cap, 3), dtype=np.int32)
        count = lib.grl_build_edges(
            boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            has_text.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            cap,
        )
        if count >= 0:
            return out[:count]
        cap *= 2


def build_heuristic_adjacency_fast(
    textlines: Sequence[Dict[str, Any]],
    edge_type: str = "normal_binary",
    num_edges: int = 6,
) -> np.ndarray:
    """``build_heuristic_adjacency``'s ``(n, num_edges, n)`` float16
    adjacency, through the C++ builder for ``normal_binary`` pages of
    textlines only, and the Python builder otherwise."""
    boxes = boxes_from_textlines(textlines)
    if edge_type != "normal_binary" or not all(b.is_textline for b in boxes):
        pages["python"] += 1
        return build_heuristic_adjacency(textlines, edge_type, num_edges)
    n = len(boxes)
    geom = np.array([(b.x, b.y, b.w, b.h) for b in boxes], dtype=np.float64).reshape(n, 4)
    has_text = np.array([1 if b.text else 0 for b in boxes], dtype=np.uint8)
    edges = native_build_edges(geom, has_text)
    adj = np.zeros((n, num_edges, n), dtype=np.float32)
    if len(edges):
        adj[edges[:, 0], edges[:, 1], edges[:, 2]] = 1.0
    pages["native"] += 1
    return adj.astype(np.float16)
