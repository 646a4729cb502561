"""Host data path of grl_torch against grl_tpu: golden arrays.

The port keeps its own copies of the numpy stages (grl_torch may not
import grl_tpu), so these tests hold the copies to the originals on the
same synthetic pages: identical arrays, dtypes included. Both packages'
graph builder is their default, the native C++ one, which must give the
same float16 (N, 6, N) adjacency.
"""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import pytest

from grl_tpu.data import collate as jax_collate
from grl_tpu.data import native as jax_native
from grl_tpu.data import datasets as jax_datasets
from grl_tpu.data.dataloader import BaseDataLoader as JaxBaseDataLoader
from grl_tpu.data.native import native_available
from grl_tpu.data.normalize_text import normalize_text as jax_normalize_text
from grl_tpu.data import synthetic as jax_synthetic
from grl_torch.data import collate, datasets, synthetic
from grl_torch.data import native as torch_native
from grl_torch.data.dataloader import BaseDataLoader
from grl_torch.data.normalize_text import normalize_text

PROCESS = {
    "TextlineEncoding": {"is_normalized_text": True},
    "HeuristicGraphBuilder": {"num_edges": 6, "edge_type": "normal_binary"},
    "NodeLabeling": {},
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    out = tmp_path_factory.mktemp("pages")
    return jax_synthetic.synthetic_dataset_files(str(out), num_pages=4, seed=3)


def make_config(files, process=PROCESS):
    data_dir, classes_path, charset_path = files
    return {
        "data_path": [data_dir],
        "class_path": classes_path,
        "charset_path": charset_path,
        "key_types": ["key", "value"],
        "data_process": process,
    }


def both_samples(files, samples=None, process=PROCESS):
    config = make_config(files, process)
    kwargs = {} if samples is None else {"samples": samples}
    ours = datasets.CassiaDataset(config, **kwargs)
    theirs = jax_datasets.CassiaDataset(config, **kwargs)
    assert len(ours) == len(theirs) > 0
    return [ours[i] for i in range(len(ours))], [theirs[i] for i in range(len(theirs))]


def assert_same_arrays(ours, theirs, keys):
    for key in keys:
        a, b = np.asarray(ours[key]), np.asarray(theirs[key])
        assert a.dtype == b.dtype, key
        np.testing.assert_array_equal(a, b, err_msg=key)


@pytest.mark.parametrize("seed, rows, noise", [(0, 12, 6), (11, 40, 10), (7, 110, 10)])
def test_synthetic_pages_match(seed, rows, noise):
    assert synthetic.synthetic_page(seed, rows, noise) == jax_synthetic.synthetic_page(seed, rows, noise)


def test_normalize_text_matches():
    for text in ["Ｔｏｔａｌ　Ａｍｏｕｎｔ：", "ｶﾀｶﾅ ¥1,000 (10%)", "INV-0042", "  mixed\tCase  ", ""]:
        assert normalize_text(text) == jax_normalize_text(text)


def test_textline_encoding_matches(files):
    ours, theirs = both_samples(files)
    for a, b in zip(ours, theirs):
        assert_same_arrays(a, b, ["textline_encoding", "node_label"])
        assert a["textline_encoding"].dtype == np.float32


@pytest.fixture(scope="module")
def native_library():
    """grl_tpu's native graph builder (native/graph_builder.cpp), built by
    the port's locked build (grl_torch.data.native.build_library) into a
    private path under build/ keyed on the source's hash.

    grl_tpu.data.native builds native/libgrlgraph.so in place when it is
    missing or stale, and every pytest-xdist worker imports it (through
    tests/test_native_builder.py) at collection: in a fresh checkout the
    workers each run g++ onto the path the others load, and a worker that
    loads a half-written file ("file too short") falls back to Python for
    the rest of its life. The port's build compiles one process at a time,
    under a file lock, to a temporary name that is then renamed into place,
    so no process ever loads a partial file.
    """
    source = Path(jax_native._SRC)
    path = torch_native.build_library(source)
    if path.stat().st_mtime < source.stat().st_mtime:
        os.utime(path)  # same source bytes: keep grl_tpu from rebuilding it
    return str(path)


@pytest.mark.parametrize("rows, noise", [(12, 6), (60, 8)])
def test_graph_builder_matches_native(files, rows, noise, native_library, monkeypatch):
    """The port's default builder (the native one) against grl_tpu's,
    loaded from the fixture's private build."""
    monkeypatch.setattr(jax_native, "_LIB", native_library)
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_load_failed", False)
    assert native_available()
    pages = [jax_synthetic.synthetic_page(500 + i, rows, noise) for i in range(3)]
    ours, theirs = both_samples(files, samples=pages)
    for a, b in zip(ours, theirs):
        n = len(a["label"])
        assert a["adjacency_matrix"].shape == (n, 6, n)
        assert a["adjacency_matrix"].dtype == np.float16
        assert_same_arrays(a, b, ["adjacency_matrix", "textline_encoding", "node_label"])


def test_inference_pages_match(files):
    """Cassia pages as KVInference sends them: location and text only."""
    pages = [
        [{"location": box["location"], "text": box["text"]} for box in jax_synthetic.synthetic_page(900 + i)]
        for i in range(2)
    ]
    process = {k: v for k, v in PROCESS.items() if k != "NodeLabeling"}
    ours, theirs = both_samples(files, samples=pages, process=process)
    for a, b in zip(ours, theirs):
        assert_same_arrays(a, b, ["adjacency_matrix", "textline_encoding"])
        assert a["label"] == b["label"]


def test_bucket_padding_and_stack_batch_match(files):
    ours, theirs = both_samples(files)
    kwargs = {"quantum": 64, "only_selected_items": True}
    ours = collate.stack_batch(collate.BucketPadding(**kwargs)(ours))
    theirs = jax_collate.stack_batch(jax_collate.BucketPadding(**kwargs)(theirs))
    assert set(ours) == set(theirs) == {"textline_encoding", "adjacency_matrix", "node_label", "node_mask"}
    assert ours["adjacency_matrix"].shape[1] % 64 == 0
    assert_same_arrays(ours, theirs, sorted(ours))


@pytest.mark.parametrize("n", [1, 63, 64, 65, 190, 230, 256, 300])
def test_next_bucket_matches(n):
    assert collate.next_bucket(n, quantum=64) == jax_collate.next_bucket(n, quantum=64)
    assert collate.next_bucket(n, 64, (128, 256)) == jax_collate.next_bucket(n, 64, (128, 256))


def test_unported_processors_raise(files):
    with pytest.raises(KeyError, match="neither in grl_torch.data.processors nor in grl_torch.data.augmentor"):
        datasets.CassiaDataset(make_config(files, {"NoSuchProcessor": {}}))


@pytest.mark.parametrize("shuffle, drop_last, prefetch", [(True, False, 2), (False, True, 0)])
def test_dataloader_matches_grl_tpu(files, shuffle, drop_last, prefetch):
    """The config factory's loader: seeded shuffle (same order as grl_tpu's
    over two epochs), the collate chain, drop_last, with and without the
    prefetch thread."""
    split = {**make_config(files), "batch_size": 3, "shuffle": shuffle, "drop_last": drop_last,
             "prefetch": prefetch, "data_collate": {"BucketPadding": {"quantum": 64, "only_selected_items": True}}}
    loaders = []
    for factory in (BaseDataLoader, JaxBaseDataLoader):
        maker = factory({"seed": 5})
        loaders.append(maker._get_dataloader(maker._load_dataset("CassiaDataset", split), split))
    ours, theirs = loaders
    assert len(ours) == len(theirs) == (1 if drop_last else 2)
    for _ in range(2):
        batches = list(zip(ours, theirs))
        assert len(batches) == len(ours)
        for a, b in batches:
            assert_same_arrays(a, b, sorted(a))
    chain = BaseDataLoader({})._load_collate_processors({"SparseBucketPadding": {"edge_quantum": 128}})
    assert type(chain[0]).__name__ == "SparseBucketPadding" and chain[0].edge_quantum == 128
    with pytest.raises(KeyError, match="SparseBucketPadding"):
        BaseDataLoader({})._load_collate_processors({"NoSuchPadding": {}})
