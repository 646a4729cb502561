"""Experiment tracking: a Neptune-shaped run handle, locally backed.

A copy of ``grl_tpu/utils/experiment.py``; the lead process is the one
with ``RANK`` 0 (``torch.distributed``'s launcher contract).

The reference initializes a global Neptune run at import time from env vars
(reference: gnn/utils/constant.py:5-8) and threads it into every training
procedure as ``ems_exp`` where series are appended with
``run["Train/step_loss"].append(v)`` (reference: kv_procedure.py:196-197,
210-211, 228-229, 250-251). This module keeps that channel API but:

* initialization is lazy (no network calls or side effects at import);
* the always-on backend is a local JSONL series file under the experiment
  output dir — greppable, offline, and safe with several processes (only
  rank 0 writes);
* if the ``neptune`` package is importable AND ``NEPTUNE_PROJECT`` /
  ``NEPTUNE_API_TOKEN`` are set, values are mirrored to Neptune too.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Optional


class _Series:
    """One metric channel: ``run["Train/loss"].append(v)``."""

    def __init__(self, run: "ExperimentRun", path: str):
        self._run = run
        self._path = path

    def append(self, value: Any, step: Optional[int] = None) -> None:
        self._run._record(self._path, value, step)

    # Neptune series also support ``log`` as a legacy alias.
    log = append


class ExperimentRun:
    """Dict-style experiment run: ``run[path].append(v)`` / ``run[path] = v``.

    Values land in ``<out_dir>/experiment_series.jsonl`` as one JSON object
    per record: ``{"path", "value", "step", "ts"}``. Assignment records a
    single value (used for config/params snapshots).
    """

    def __init__(self, out_dir: str = ".", name: str = "experiment_series",
                 mirror_neptune: bool = True):
        self._lock = threading.Lock()
        self._steps: Dict[str, int] = {}
        self._fh = None
        self._neptune = None
        # Multi-process: only rank 0 writes (torch.distributed may not be
        # initialized yet, so read its launcher's env var contract).
        self._is_lead = int(os.environ.get("RANK", "0")) == 0
        if self._is_lead:
            os.makedirs(out_dir, exist_ok=True)
            self._file_path = os.path.join(out_dir, f"{name}.jsonl")
            self._fh = open(self._file_path, "a", encoding="utf-8")
        if (
            mirror_neptune
            and os.getenv("NEPTUNE_PROJECT")
            and os.getenv("NEPTUNE_API_TOKEN")
        ):
            try:  # pragma: no cover - requires neptune + network
                import neptune

                self._neptune = neptune.init_run(
                    project=os.getenv("NEPTUNE_PROJECT"),
                    api_token=os.getenv("NEPTUNE_API_TOKEN"),
                )
            except Exception:
                self._neptune = None

    # ------------------------------------------------------------------
    def __getitem__(self, path: str) -> _Series:
        return _Series(self, path)

    def __setitem__(self, path: str, value: Any) -> None:
        self._record(path, value, step=None, kind="assign")

    def _record(self, path: str, value: Any, step: Optional[int],
                kind: str = "append") -> None:
        if step is None and kind == "append":
            step = self._steps.get(path, 0)
            self._steps[path] = step + 1
        try:
            value = float(value)
        except (TypeError, ValueError):
            pass
        if self._fh is not None:
            rec = {"path": path, "value": value, "step": step, "ts": time.time()}
            with self._lock:
                self._fh.write(json.dumps(rec, default=str) + "\n")
                self._fh.flush()
        if self._neptune is not None:  # pragma: no cover
            try:
                if kind == "append":
                    self._neptune[path].append(value)
                else:
                    self._neptune[path] = value
            except Exception:
                pass

    def stop(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        if self._neptune is not None:  # pragma: no cover
            try:
                self._neptune.stop()
            except Exception:
                pass
        self._neptune = None

    close = stop


_RUN: Optional[ExperimentRun] = None


def get_experiment_run(out_dir: str = ".") -> ExperimentRun:
    """Lazy global run (the reference's import-time ``NEPTUNE_RUN``,
    reference: gnn/utils/constant.py:5-8 — made lazy and offline-first)."""
    global _RUN
    if _RUN is None:
        _RUN = ExperimentRun(out_dir)
    return _RUN
