"""Config system: YAML -> attribute-access dict + registry instantiation.

Mirrors the capability of the reference's anyconfig+munch setup
(reference: gnn/cl_warper.py:71-72) and the uniform
``getattr(module, cfg.type)._from_config(cfg.args)`` idiom used across
models / procedures / datasets / processors (reference:
gnn/models/base_network.py:33-47, gnn/trainer/training_procedures/
base_procedure.py:95-138) — but with plain stdlib + pyyaml and a single
explicit helper instead of per-class classmethods.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, Iterator, Mapping, Optional

import yaml


class ConfigDict(dict):
    """A dict with recursive attribute access (a munch stand-in)."""

    def __init__(self, data: Optional[Mapping[str, Any]] = None, **kwargs: Any):
        super().__init__()
        data = dict(data or {})
        data.update(kwargs)
        for key, value in data.items():
            self[key] = value

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, Mapping) and not isinstance(value, ConfigDict):
            return ConfigDict(value)
        if isinstance(value, (list, tuple)):
            return type(value)(ConfigDict._wrap(v) for v in value)
        return value

    def __setitem__(self, key: str, value: Any) -> None:
        super().__setitem__(key, self._wrap(value))

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as err:
            raise AttributeError(name) from err

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as err:
            raise AttributeError(name) from err

    def get_path(self, dotted: str, default: Any = None) -> Any:
        """``cfg.get_path("data_config.training.batch_size", 1)``."""
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, Mapping) or part not in node:
                return default
            node = node[part]
        return node

    def to_dict(self) -> Dict[str, Any]:
        def unwrap(value: Any) -> Any:
            if isinstance(value, Mapping):
                return {k: unwrap(v) for k, v in value.items()}
            if isinstance(value, (list, tuple)):
                return [unwrap(v) for v in value]
            return value

        return unwrap(self)

    def copy(self) -> "ConfigDict":
        return ConfigDict(copy.deepcopy(self.to_dict()))

    def items_sorted(self) -> Iterator:
        return iter(sorted(self.items()))


def load_config(path: str) -> ConfigDict:
    """Load a YAML config file into a ConfigDict."""
    with open(path, "r", encoding="utf-8") as handle:
        raw = yaml.safe_load(handle)
    return ConfigDict(raw or {})


def dump_config(config: Mapping[str, Any], path: str) -> None:
    data = config.to_dict() if isinstance(config, ConfigDict) else dict(config)
    with open(path, "w", encoding="utf-8") as handle:
        yaml.safe_dump(data, handle, sort_keys=False, allow_unicode=True)


def instantiate(module: Any, spec: Mapping[str, Any], *args: Any, **extra: Any) -> Any:
    """Instantiate ``getattr(module, spec['type'])(*args, **spec['args'])``.

    The single registry entry point replacing the reference's per-class
    ``_from_config`` classmethods (reference: gnn/models/base_network.py:33-47).
    ``module`` may be an actual module or any namespace object.
    """
    type_name = spec["type"]
    cls = getattr(module, type_name, None)
    if cls is None:
        raise KeyError(
            f"Cannot find type {type_name!r} in {getattr(module, '__name__', module)!r}."
        )
    kwargs = dict(spec.get("args", {}) or {})
    kwargs.update(extra)
    if hasattr(cls, "_from_config"):
        return cls._from_config(ConfigDict(kwargs), *args)
    return cls(*args, **kwargs)
