"""grl_torch.utils' exports against grl_tpu.utils on the same inputs.

``JsonHandler`` reads a utf-8-sig file (BOM first) with non-ASCII text and
nested lists as grl_tpu's does, and writes the same bytes; ``Dictlist``,
``MetricTracker``, ``ExperimentRun`` and the lazy global run of
``get_experiment_run`` give what grl_tpu's give on what
``tests/test_experiment_tracking.py`` exercises.
"""
from __future__ import annotations

import json

import pytest

import grl_torch.utils as torch_utils
from grl_torch.utils import experiment as torch_experiment
from grl_tpu.utils import experiment as tpu_experiment
from grl_tpu.utils import json_handler as tpu_json
from grl_tpu.utils import metric_tracker as tpu_tracker

DOCUMENT = {
    "charset": ["a", "ă", "đ", "日本", "€"],
    "pages": [[{"text": "Số hóa đơn", "box": [[1, 2], [3.5, 4]]}], [], [[["ẞ"]]]],
    "empty": {},
    "none": None,
}


def series(path):
    """The records of a series file without their wall-clock stamps."""
    return [{k: v for k, v in json.loads(line).items() if k != "ts"} for line in open(path, encoding="utf-8")]


def test_json_handler_reads_utf8_sig_as_grl_tpu(tmp_path):
    path = tmp_path / "doc.json"
    path.write_bytes(b"\xef\xbb\xbf" + json.dumps(DOCUMENT, ensure_ascii=False).encode("utf-8"))
    got = torch_utils.JsonHandler.read_json_file(str(path))
    assert got == tpu_json.JsonHandler.read_json_file(str(path)) == DOCUMENT
    assert torch_utils.read_json(str(path)) == got


def test_json_handler_dumps_the_bytes_of_grl_tpu(tmp_path):
    ours, theirs = tmp_path / "ours.json", tmp_path / "theirs.json"
    torch_utils.JsonHandler.dump_json_file(DOCUMENT, str(ours))
    tpu_json.JsonHandler.dump_json_file(DOCUMENT, str(theirs))
    assert ours.read_bytes() == theirs.read_bytes()
    assert "日本".encode("utf-8") in ours.read_bytes()
    assert torch_utils.JsonHandler.read_json_file(str(ours)) == DOCUMENT


def test_exports_are_the_module_objects():
    from grl_torch.utils import json_handler, metric_tracker

    assert torch_utils.JsonHandler is json_handler.JsonHandler
    assert torch_utils.Dictlist is metric_tracker.Dictlist
    assert torch_utils.MetricTracker is metric_tracker.MetricTracker
    assert torch_utils.ExperimentRun is torch_experiment.ExperimentRun
    assert torch_utils.get_experiment_run is torch_experiment.get_experiment_run


def test_metric_trackers_match_grl_tpu():
    results = []
    for Dictlist, MetricTracker in ((torch_utils.Dictlist, torch_utils.MetricTracker),
                                    (tpu_tracker.Dictlist, tpu_tracker.MetricTracker)):
        lists = Dictlist()
        lists["loss"] = 1.0
        lists["loss"] = 0.25
        lists.update_metrics({"f1": 0.5, "loss": 1.0 / 3.0})
        lists._update({"f1": 0.75})
        tracker = MetricTracker("loss", "acc")
        tracker.update("loss", 2.0)
        tracker.update("loss", 0.5, n=3)
        tracker.update("f1", 0.9, n=2)
        results.append((dict(lists), lists.result(), lists._result(), lists.avg("f1"),
                        tracker.result(), tracker.avg("acc"), tracker.avg("unseen")))
    assert results[0] == results[1]


def test_experiment_run_series_match_grl_tpu(tmp_path):
    for module, out in ((torch_utils, tmp_path / "torch"), (tpu_experiment, tmp_path / "tpu")):
        run = module.ExperimentRun(str(out))
        run["Train/step_loss"].append(1.5)
        run["Train/step_loss"].append(1.25)
        run["Train/step_loss"].log(1.0)
        run["Validation/f1-score"].append(0.5, step=7)
        run["config"] = {"lr": 0.01, "name": "kv"}
        run.stop()
    ours, theirs = series(tmp_path / "torch" / "experiment_series.jsonl"), series(
        tmp_path / "tpu" / "experiment_series.jsonl")
    assert ours == theirs
    assert [r["step"] for r in ours if r["path"] == "Train/step_loss"] == [0, 1, 2]


@pytest.mark.parametrize("env", [{}, {"NEPTUNE_API_TOKEN": "token"}])
def test_lazy_global_run_matches_grl_tpu(tmp_path, monkeypatch, env):
    """With no ``NEPTUNE_PROJECT`` the global run is made at the first call,
    kept, writes locally and never reaches for neptune."""
    monkeypatch.delenv("NEPTUNE_PROJECT", raising=False)
    monkeypatch.delenv("NEPTUNE_API_TOKEN", raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    for module, name in ((torch_experiment, "torch"), (tpu_experiment, "tpu")):
        monkeypatch.setattr(module, "_RUN", None)
        run = module.get_experiment_run(str(tmp_path / name))
        assert module.get_experiment_run() is run and module.get_experiment_run(str(tmp_path)) is run
        assert run._neptune is None
        run["Train/loss"].append(0.5)
        run.stop()
    assert torch_utils.get_experiment_run() is torch_experiment._RUN
    assert series(tmp_path / "torch" / "experiment_series.jsonl") == series(
        tmp_path / "tpu" / "experiment_series.jsonl")
