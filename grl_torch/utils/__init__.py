from grl_torch.utils.device import resolve_device
from grl_torch.utils.json_handler import read_json, write_json
from grl_torch.utils.logging import get_logger

__all__ = ["resolve_device", "read_json", "write_json", "get_logger"]
