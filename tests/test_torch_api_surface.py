"""Every public name of grl_tpu has its counterpart in grl_torch.

grl_tpu is read with ``ast`` and never imported: each module's top-level
public functions and classes, the public methods of those classes, and the
module's ``__all__``. Each name must be found in the counterpart module of
grl_torch (``ops/pallas/X.py`` -> ``ops/X.py``): a function or class as an
attribute of the module, a method on the class of the same name there
(inherited or not), an ``__all__`` entry in the module's ``__all__`` and as
an attribute. A name the port meets another way stands in ``JAX_IDIOMS``,
with its counterpart and the reason.

Run on the CPU: ``JAX_PLATFORMS=cpu python -m pytest
tests/test_torch_api_surface.py -q``.
"""
from __future__ import annotations

import ast
import importlib
import inspect
import re
from pathlib import Path
from typing import List, Tuple

import pytest

from tests.test_torch_isolation import run_blocked

REPO = Path(__file__).resolve().parent.parent
GRL_TPU = REPO / "grl_tpu"
MODULES = sorted(path.relative_to(GRL_TPU).as_posix() for path in GRL_TPU.rglob("*.py"))

# grl_tpu name -> (the port's counterpart, why the name differs). A
# counterpart is ``module:qualified.name``; ``(kw)`` after it names a
# parameter the callable must take.
JAX_IDIOMS = {
    "zero_cotangent": (
        "grl_torch.ops.ell:_Gather.backward",
        "JAX wants float0/zero cotangents for a table pytree; an autograd.Function's backward returns None",
    ),
    "pallas_neighbor_aggregate": (
        "grl_torch.ops.relagg:neighbor_aggregate",
        "the Pallas wrapper's name; the port's wrapper launches the CUDA K3",
    ),
    "pallas_dropedge_aggregate": (
        "grl_torch.ops.relagg:dropedge_aggregate",
        "the Pallas wrapper's name; the port's wrapper launches the CUDA K1/K2",
    ),
    "BaseProcedure.build_scanned_train_step": (
        "grl_torch.trainer.captured:CapturedSteps",
        "K steps in one lax.scan become K steps captured in one CUDA graph",
    ),
    "TrainState.variables": (
        "grl_torch.trainer.procedures.base_procedure:TrainState.state_dict",
        "flax's variable collections are the torch module's state dict",
    ),
    "GraphCNNDropEdge.trunk_features": (
        "grl_torch.models.gcn_family:GCNTrunk.forward(first_only)",
        "a flax method that rebinds the trunk; the torch trunk returns its first block's features",
    ),
    "init_model": (
        "grl_torch.models.base:create_model",
        "flax draws parameters from a key and sample inputs; torch modules draw theirs when built (generator=)",
    ),
    "DGI.setup": (
        "grl_torch.models.ssl_gcn:DGI.__init__(generator)",
        "flax's setup is the torch constructor",
    ),
    "init_dgi_variables": (
        "grl_torch.models.ssl_gcn:DGI.__init__(generator)",
        "flax's two lazy init passes merged; the torch DGI builds encoder and discriminator at once",
    ),
    "native_available": (
        "grl_torch.data.native:load_library",
        "grl_tpu falls back to Python without the native builder; the port raises instead",
    ),
}


def public_surface(path: Path) -> List[Tuple[str, str]]:
    """``(kind, name)`` of a grl_tpu module: ``def`` for a top-level public
    function or class, ``method`` for ``Class.method``, ``all`` for an
    ``__all__`` entry."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) and not node.name.startswith("_"):
            out.append(("def", node.name))
            if isinstance(node, ast.ClassDef):
                out.extend(("method", f"{node.name}.{sub.name}") for sub in node.body
                           if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef))
                           and not sub.name.startswith("_"))
        elif isinstance(node, ast.Assign) and any(isinstance(t, ast.Name) and t.id == "__all__"
                                                  for t in node.targets):
            out.extend(("all", name) for name in ast.literal_eval(node.value))
    return out


def counterpart_module(rel: str) -> str:
    """``ops/pallas/relagg.py`` -> ``grl_torch.ops.relagg``."""
    parts = rel.replace("ops/pallas/", "ops/").removesuffix(".py").split("/")
    if parts[-1] == "__init__":
        parts.pop()
    return ".".join(["grl_torch", *parts])


_MISSING = object()


def lookup(obj, dotted: str):
    for part in dotted.split("."):
        obj = getattr(obj, part, _MISSING)
        if obj is _MISSING:
            break
    return obj


def ported(module, kind: str, name: str) -> bool:
    if kind == "all" and name not in getattr(module, "__all__", ()):
        return False
    return lookup(module, name) is not _MISSING


def resolve_counterpart(spec: str) -> None:
    """Check that the object a ``JAX_IDIOMS`` counterpart names exists and
    takes the parameter it names."""
    match = re.fullmatch(r"([\w.]+):([\w.]+)(?:\((\w+)\))?", spec)
    assert match, spec
    module, qualname, keyword = match.groups()
    obj = lookup(importlib.import_module(module), qualname)
    assert obj is not _MISSING, f"{spec}: no {qualname} in {module}"
    if keyword is not None:
        assert keyword in inspect.signature(obj).parameters, f"{spec}: no parameter {keyword}"


@pytest.mark.parametrize("rel", MODULES)
def test_public_names_have_counterparts(rel):
    module = importlib.import_module(counterpart_module(rel))
    missing = [f"{kind} {name}" for kind, name in public_surface(GRL_TPU / rel)
               if not ported(module, kind, name) and name not in JAX_IDIOMS]
    assert not missing, f"grl_tpu/{rel}: {module.__name__} lacks {missing}"


def test_jax_idioms_table_is_current():
    """Every entry names a counterpart the port has, stands for a name
    grl_tpu still has, and names nothing the port now defines under
    grl_tpu's own name."""
    seen = set()
    for rel in MODULES:
        module = importlib.import_module(counterpart_module(rel))
        for kind, name in public_surface(GRL_TPU / rel):
            if name in JAX_IDIOMS:
                seen.add(name)
                assert not ported(module, kind, name), (
                    f"{module.__name__} now has {name}: take it out of JAX_IDIOMS")
    assert seen == set(JAX_IDIOMS), f"not in grl_tpu: {sorted(set(JAX_IDIOMS) - seen)}"
    for name, (spec, reason) in JAX_IDIOMS.items():
        assert reason, name
        resolve_counterpart(spec)


EXPORTS = """
import sys
for name in {blocked!r}:
    sys.modules[name] = None
import importlib
import grl_torch
from grl_torch.utils import JsonHandler, MetricTracker, Dictlist, ExperimentRun, get_experiment_run
from grl_torch.ops import (RelationalGraph, dense_to_relational_coo, relational_aggregate_coo,
                           relational_neighbor_coo, segment_softmax, segment_sum)

resolved = 0
for package in grl_torch._packages:
    importlib.import_module(package)
for package in ("grl_torch.ops", "grl_torch.utils", "grl_torch.models"):
    module = importlib.import_module(package)
    for name in module.__all__:
        getattr(module, name)
        resolved += 1
assert "neptune" not in sys.modules
leaked = sorted(m for m in sys.modules if m.split(".")[0] in {blocked!r} and sys.modules[m] is not None)
assert not leaked, leaked
print("RESOLVED", resolved)
"""


def test_exports_resolve_with_jax_and_grl_tpu_blocked(tmp_path):
    """``grl_torch`` and every package of ``_packages`` (grl_tpu's, in its
    order, then ``grl_torch.probes``) import, and every name of ``ops``,
    ``utils`` and ``models``' ``__all__`` resolves, with JAX and grl_tpu
    blocked and neptune not imported."""
    import grl_torch
    import grl_torch.models
    import grl_torch.ops
    import grl_torch.utils

    (packages,) = [node.value for node in ast.parse((GRL_TPU / "__init__.py").read_text()).body
                   if isinstance(node, ast.Assign) and ast.unparse(node.targets[0]) == "_packages"]
    assert grl_torch._packages == [name.replace("grl_tpu", "grl_torch", 1)
                                   for name in ast.literal_eval(packages)] + ["grl_torch.probes"]
    expected = sum(len(m.__all__) for m in (grl_torch.ops, grl_torch.utils, grl_torch.models))
    assert f"RESOLVED {expected}" in run_blocked(EXPORTS, tmp_path)
