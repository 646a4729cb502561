"""Build the port's CUDA sources into shared libraries at first use.

Each ``grl_torch/csrc/<name>.cu`` has a plain C interface and is compiled
by ``nvcc`` for ``sm_90a`` into ``build/grl_torch/lib<name>-<hash>.so`` at
the root of the checkout (listed in ``.gitignore``), then loaded with
``ctypes``. The hash covers the source, the shared headers
(``csrc/*.cuh``), the flags and the compiler path, so an edited source or
header is rebuilt and an unchanged one is reused. Importing
this module needs no ``nvcc``: the compiler is looked up only when a
kernel is first launched, so the CPU tests collect without it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "grl_torch"
# Every CUDA source of the port (csrc/<name>.cu); each may include the
# shared headers csrc/*.cuh.
SOURCES = ("dropedge_sm90", "relagg_ragged", "dropedge_f32", "csr_spmm", "sparse_attention", "sparse_attention_bwd",
           "dropout", "ell", "tile", "gather_probe")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# The dtype argument of every entry point.
DTYPE_CODES = {"float32": 0, "bfloat16": 1}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each source built by
# this process, keyed by source name.
build_logs: Dict[str, str] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the "
            "CUDA kernels of grl_torch are built from source at first use."
        )
    return nvcc


def _library_path(name: str, nvcc: str) -> Path:
    digest = hashlib.sha256()
    digest.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    digest.update(nvcc.encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named source that is not built yet, all in parallel.

    Returns ``{name: path of the shared library}``. Raises ``RuntimeError``
    with nvcc's output if any compile fails.
    """
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _library_path(name, nvcc) for name in names}
    running = {}
    for name, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        running[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failures: List[str] = []
    for name, (tmp, proc) in running.items():
        output, _ = proc.communicate()
        build_logs[name] = output
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{output}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[name])
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


def load_library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built if needed.
    Every source exports ``grl_cuda_error_string``, declared here."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build([name])[name]
            lib = ctypes.CDLL(str(path))
            lib.grl_cuda_error_string.restype = ctypes.c_char_p
            lib.grl_cuda_error_string.argtypes = [ctypes.c_int]
            _libs[name] = lib
        return lib


def check_launch(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise ``RuntimeError`` for the cudaError_t ``err`` an entry point
    returned (a refused launch never runs, and no synchronise reports it)."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {lib.grl_cuda_error_string(err).decode()} ({err})")
