"""The port's native graph builder (grl_torch.data.native) against its
Python builder and against grl_tpu's native builder.

The three must give the same float16 (n, 6, n) adjacency bit for bit. The
pages are the cassia pages the data tests write (each checked against the
inference input schema in tests/assets/schemas) and synthetic pages of
several sizes, plus edge cases (no box, one box, empty text, stacked and
overlapping boxes). grl_tpu's builder is loaded from the port's locked
build, as tests/test_torch_data.py does, so no worker writes into
native/.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from grl_tpu.data import native as jax_native
from grl_tpu.data import synthetic as jax_synthetic
from grl_torch.data import native
from grl_torch.data.graph_builder import build_heuristic_adjacency
from grl_torch.data.processors import HeuristicGraphBuilder

REPO = Path(__file__).resolve().parents[1]
SCHEMA = REPO / "tests" / "assets" / "schemas" / "input_schema.json"


@pytest.fixture(scope="module")
def jax_library():
    """grl_tpu's builder module pointed at the port's build of the same
    source (restored after the module's tests)."""
    path = native.build_library(Path(jax_native._SRC))
    saved = (jax_native._LIB, jax_native._lib, jax_native._load_failed)
    jax_native._LIB, jax_native._lib, jax_native._load_failed = str(path), None, False
    assert jax_native.native_available()
    yield jax_native
    jax_native._LIB, jax_native._lib, jax_native._load_failed = saved


def items_of(page, kinds=None):
    """A page's boxes as the builders take them (what
    HeuristicGraphBuilder feeds them), typed ``kinds[i]`` or "other"."""
    return [{"location": box["location"], "text": box["text"], "key_type": "other",
             "type": (kinds or {}).get(i, "other")} for i, box in enumerate(page)]


def cassia_pages(tmp_path_factory):
    out = tmp_path_factory.mktemp("cassia")
    data_dir, _, _ = jax_synthetic.synthetic_dataset_files(str(out), num_pages=4, seed=5)
    schema = json.loads(SCHEMA.read_text())
    jsonschema = pytest.importorskip("jsonschema")
    pages = []
    for name in sorted(os.listdir(data_dir)):
        with open(os.path.join(data_dir, name)) as handle:
            page = [{"location": b["location"], "text": b["text"]} for b in json.load(handle)]
        jsonschema.validate(page, schema)
        pages.append(page)
    return pages


def edge_case_pages():
    box = lambda x, y, w, h, text="a": {"location": [[x, y], [x + w, y], [x + w, y + h], [x, y + h]],
                                        "text": text}
    return [
        [],
        [box(10, 10, 50, 20)],
        [box(10, 10, 50, 20, ""), box(100, 10, 50, 20, ""), box(10, 60, 50, 20)],
        # a column of stacked boxes, and two that overlap
        [box(10, 10 + 30 * i, 80, 20) for i in range(8)] + [box(200, 10, 60, 40), box(230, 20, 60, 40)],
        # one row of boxes that touch, and a box spanning them
        [box(10 + 40 * i, 300, 40, 20) for i in range(6)] + [box(10, 250, 240, 20, "header")],
    ]


def synthetic_pages(seed, rows, noise, count=3):
    return [jax_synthetic.synthetic_page(seed + i, rows, noise) for i in range(count)]


PAGE_SETS = {
    "edge cases": lambda factory: edge_case_pages(),
    "cassia": cassia_pages,
    "synthetic small": lambda factory: synthetic_pages(100, 4, 2),
    "synthetic 12 rows": lambda factory: synthetic_pages(200, 12, 6),
    "synthetic 60 rows": lambda factory: synthetic_pages(300, 60, 8),
    "synthetic 110 rows": lambda factory: synthetic_pages(400, 110, 10, count=2),
}


@pytest.mark.parametrize("pages", sorted(PAGE_SETS))
def test_native_equals_python_and_grl_tpu_bit_for_bit(pages, jax_library, tmp_path_factory):
    for page in PAGE_SETS[pages](tmp_path_factory):
        items = items_of(page)
        before = dict(native.pages)
        ours = native.build_heuristic_adjacency_fast(items)
        assert native.pages == {**before, "native": before["native"] + 1}
        python = build_heuristic_adjacency(items)
        theirs = jax_library.build_heuristic_adjacency_fast(items)
        n = len(page)
        assert ours.shape == (n, 6, n) and ours.dtype == np.float16
        assert ours.tobytes() == python.tobytes()
        assert theirs.dtype == np.float16 and ours.tobytes() == theirs.tobytes()


@pytest.mark.parametrize("edge_type", ["fc_binary", "fc_similarity"])
def test_fc_edge_types_build_in_python(edge_type, jax_library):
    page = synthetic_pages(500, 10, 4, count=1)[0]
    items = items_of(page)
    before = dict(native.pages)
    ours = native.build_heuristic_adjacency_fast(items, edge_type)
    assert native.pages == {**before, "python": before["python"] + 1}
    assert ours.tobytes() == build_heuristic_adjacency(items, edge_type).tobytes()
    assert ours.tobytes() == jax_library.build_heuristic_adjacency_fast(items, edge_type).tobytes()


@pytest.mark.parametrize("kind", ["cell", "table"])
def test_pages_with_cells_build_in_python(kind, jax_library):
    page = synthetic_pages(600, 10, 4, count=1)[0]
    items = items_of(page, kinds={0: kind, 3: kind})
    before = dict(native.pages)
    ours = native.build_heuristic_adjacency_fast(items)
    assert native.pages == {**before, "python": before["python"] + 1}
    assert ours.tobytes() == build_heuristic_adjacency(items).tobytes()
    assert ours.tobytes() == jax_library.build_heuristic_adjacency_fast(items).tobytes()


@pytest.mark.parametrize("use_native", [True, False])
def test_processor_counts_the_builder_it_ran(use_native):
    page = synthetic_pages(700, 8, 3, count=1)[0]
    sample = {"label": {i: {"polygon": b["location"], "text": b["text"], "label": "other",
                            "key_type": "other"} for i, b in enumerate(page)}}
    before = dict(native.pages)
    out = HeuristicGraphBuilder(use_native=use_native)(sample)
    which = "native" if use_native else "python"
    assert native.pages == {**before, which: before[which] + 1}
    assert out["adjacency_matrix"].tobytes() == build_heuristic_adjacency(items_of(page)).tobytes()


def private_source(tmp_path: Path, tag: str) -> Path:
    """A copy of the builder's source whose hash no build holds yet."""
    source = tmp_path / "graph_builder.cpp"
    source.write_text(native.SOURCE.read_text() + f"\n// {tag}\n")
    return source


BUILD_AND_RUN = textwrap.dedent(
    """
    import sys
    from pathlib import Path
    import numpy as np
    from grl_torch.data import native
    native.BUILD_DIR = Path(sys.argv[1])
    native.SOURCE = Path(sys.argv[2])
    boxes = np.array([[10, 10, 50, 20], [100, 10, 50, 20], [10, 60, 50, 20]], np.float64)
    edges = native.native_build_edges(boxes, np.ones(3, np.uint8))
    print(sorted(map(tuple, edges.tolist())))
    """
)


def test_six_processes_building_at_once_each_load_a_whole_library(tmp_path):
    source = private_source(tmp_path, "six")
    build = tmp_path / "build"
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_AND_RUN, str(build), str(source)],
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    results = [proc.communicate(timeout=240) for proc in procs]
    for proc, (out, err) in zip(procs, results):
        assert proc.returncode == 0, err
    outputs = {out for out, _ in results}
    assert len(outputs) == 1 and outputs.pop().strip() != "[]"
    built = sorted(p.name for p in build.iterdir())
    assert built == sorted(["libgrlgraph.lock", native.library_path(source).name])


def test_no_compiler_raises_naming_it(tmp_path, monkeypatch):
    source = private_source(tmp_path, "absent")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "COMPILER", "g++-absent-from-path")
    with pytest.raises(RuntimeError, match=r"g\+\+-absent-from-path not found.*graph_builder\.cpp"):
        native.build_library(source)
    # The processor raises too: it never turns to the Python builder.
    monkeypatch.setattr(native, "SOURCE", source)
    monkeypatch.setattr(native, "_lib", None)
    page = synthetic_pages(800, 4, 2, count=1)[0]
    sample = {"label": {i: {"polygon": b["location"], "text": b["text"]} for i, b in enumerate(page)}}
    with pytest.raises(RuntimeError, match=r"g\+\+-absent-from-path"):
        HeuristicGraphBuilder()(sample)
    assert not (tmp_path / "build").exists() or not any((tmp_path / "build").iterdir())
