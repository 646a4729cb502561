from grl_torch.utils.device import resolve_device
from grl_torch.utils.experiment import ExperimentRun, get_experiment_run
from grl_torch.utils.json_handler import JsonHandler, read_json, write_json
from grl_torch.utils.logging import get_logger
from grl_torch.utils.metric_tracker import Dictlist, MetricTracker

__all__ = [
    "resolve_device",
    "ExperimentRun",
    "get_experiment_run",
    "JsonHandler",
    "read_json",
    "write_json",
    "get_logger",
    "Dictlist",
    "MetricTracker",
]
