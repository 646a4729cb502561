"""The self-supervised data chain of grl_torch against grl_tpu's.

The port keeps its own copies of the augmentors, the SSL processors,
``NumpyPadding`` and the corpus builder; these tests hold them to the
originals on the same synthetic pages, array for array, dtypes included.
``SSLLabeling`` draws its pairs from numpy's global generator, as
``grl_tpu``'s does, so each package runs after the same ``np.random.seed``.
The loaders run with ``prefetch: 0`` so that every draw comes from the test's
thread. Both packages build graphs with their default native builder;
grl_tpu's loads the copy the port's locked build makes (see
``tests/test_torch_data.py::native_library``).
"""
from __future__ import annotations

import copy
import json
import os
from pathlib import Path

import numpy as np
import pytest

from grl_tpu.data import augmentor as jax_augmentor
from grl_tpu.data import collate as jax_collate
from grl_tpu.data import corpus as jax_corpus
from grl_tpu.data import datasets as jax_datasets
from grl_tpu.data import native as jax_native
from grl_tpu.data import processors as jax_processors
from grl_tpu.data import synthetic as jax_synthetic
from grl_tpu.data.dataloader import BaseDataLoader as JaxBaseDataLoader
from grl_torch.data import augmentor, collate, corpus, datasets, processors
from grl_torch.data import native as torch_native
from grl_torch.data.dataloader import BaseDataLoader
from test_procedures import make_split

SEED = 0


@pytest.fixture(scope="module", autouse=True)
def jax_native_builder():
    """grl_tpu's native builder loaded from the port's locked private build:
    grl_tpu's own in-place build races between the suite's workers."""
    source = Path(jax_native._SRC)
    path = torch_native.build_library(source)
    if path.stat().st_mtime < source.stat().st_mtime:
        os.utime(path)
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_native, "_LIB", str(path))
        patch.setattr(jax_native, "_lib", None)
        patch.setattr(jax_native, "_load_failed", False)
        yield


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    out = tmp_path_factory.mktemp("ssl_pages")
    return jax_synthetic.synthetic_dataset_files(str(out), num_pages=8, seed=1)


def ssl_split(files):
    """``make_split(ssl=True)`` (tests/test_procedures.py), in order, with
    ``pairwise_similarity`` labeled and padded too, and no shuffle."""
    split = make_split(*files, ssl=True)
    split["shuffle"] = False
    split["prefetch"] = 0
    split["data_process"]["SSLLabeling"]["tasks"].insert(3, "pairwise_similarity")
    split["data_collate"]["BucketPadding"]["keep_keys"] += [
        "pairwise_similarity_indices", "pairwise_similarity_targets"]
    split["data_collate"]["NumpyPadding"]["name_value_pairs"].update(
        pairwise_similarity_indices=0, pairwise_similarity_targets=-100)
    return split


def assert_same(ours, theirs, what=""):
    """Equal values, arrays bit for bit with their dtypes, lists and dicts
    item by item."""
    if isinstance(theirs, np.ndarray) or isinstance(ours, np.ndarray):
        a, b = np.asarray(ours), np.asarray(theirs)
        assert a.dtype == b.dtype and a.shape == b.shape, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    elif isinstance(theirs, dict):
        assert set(ours) == set(theirs), what
        for key in theirs:
            assert_same(ours[key], theirs[key], f"{what}.{key}")
    elif isinstance(theirs, (list, tuple)):
        assert len(ours) == len(theirs), what
        for i, (a, b) in enumerate(zip(ours, theirs)):
            assert_same(a, b, f"{what}[{i}]")
    else:
        assert type(ours) is type(theirs) and ours == theirs, what


@pytest.fixture(scope="module")
def built(files):
    """Pages through TextlineEncoding, HeuristicGraphBuilder and
    NodeLabeling in both packages (equal: tests/test_torch_data.py)."""
    config = {key: value for key, value in make_split(*files).items() if key != "data_collate"}
    ours, theirs = datasets.CassiaDataset(config), jax_datasets.CassiaDataset(config)
    return [ours[i] for i in range(len(ours))], [theirs[i] for i in range(len(theirs))]


def both(make_ours, make_theirs, samples, seed=SEED):
    """Run a processor of each package over deep copies of ``samples``,
    each after ``np.random.seed(seed)``."""
    ours, theirs = samples
    np.random.seed(seed)
    out_ours = [make_ours(copy.deepcopy(s)) for s in ours]
    np.random.seed(seed)
    out_theirs = [make_theirs(copy.deepcopy(s)) for s in theirs]
    return out_ours, out_theirs


@pytest.mark.parametrize("n, density, cutoff", [(1, 0.0, 3), (7, 0.2, 1), (40, 0.05, 3), (64, 0.02, 6)])
def test_all_pairs_bfs_distance_matches(n, density, cutoff):
    adj = np.random.RandomState(n).rand(n, n) < density
    expected = jax_processors._all_pairs_bfs_distance(adj, cutoff)
    assert_same(processors._all_pairs_bfs_distance(adj, cutoff), expected)


def test_edge_mask_pairs_match_grl_tpu_defect_included():
    """On a 6-node ring with one chord and seed 1, grl_tpu's pairs carry the
    targets [1, 1, 0, 0] while their real labels are [0, 1, 0, 0]: the
    (2, 2k) endpoints read with reshape(-1, 2) pair sources with sources.
    The port gives the same pairs and the same targets."""
    flat = np.zeros((6, 6), np.float32)
    for a, b in [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 0), (0, 3)]:
        flat[a, b] = 1.0
    np.random.seed(1)
    edges, targets = processors.SSLLabeling._edge_mask(flat, 2)
    np.random.seed(1)
    jax_edges, jax_targets = jax_processors.SSLLabeling._edge_mask(flat, 2)
    assert_same(edges, jax_edges)
    assert_same(targets, jax_targets)
    assert targets.tolist() == [1, 1, 0, 0]
    assert (flat[edges[:, 0], edges[:, 1]] > 0).tolist() == [False, True, False, False]


def test_augmentors_match(built):
    ours, theirs = both(lambda s: augmentor.NodeDropAugmentor(0.15, seed=0)(s),
                        lambda s: jax_augmentor.NodeDropAugmentor(0.15, seed=0)(s), built)
    for a, b in zip(ours, theirs):
        assert_same({k: a[k] for k in ("aug_adjacency_matrix", "aug_textline_encoding", "graph_edit_history")},
                    {k: b[k] for k in ("aug_adjacency_matrix", "aug_textline_encoding", "graph_edit_history")})
        assert b["graph_edit_history"]
    # One augmentor over every page: its generator runs on from page to page.
    drop, jax_drop = augmentor.DGINegativeSampling(seed=3), jax_augmentor.DGINegativeSampling(seed=3)
    ours, theirs = both(drop, jax_drop, built)
    for a, b in zip(ours, theirs):
        assert_same(a["negative_textline_encoding"], b["negative_textline_encoding"])
        assert a["negative_adjacency_matrix"] is a["adjacency_matrix"]
    assert not augmentor.NodeDropAugmentor()({"label": None}).get("aug_adjacency_matrix")


SSL_TASKS = ["node_property", "edge_mask", "pairwise_distance", "pairwise_similarity", "graph_edit_distance", "dgi"]


@pytest.mark.parametrize("seed", [0, 5])
def test_ssl_labeling_matches(built, seed):
    """Every task's targets, after the augmentors it reads."""
    def chain(package_augmentor, package_processors):
        drop = package_augmentor.NodeDropAugmentor(0.15, seed=0)
        negatives = package_augmentor.DGINegativeSampling(seed=0)
        label = package_processors.SSLLabeling(SSL_TASKS)
        return lambda s: label(negatives(drop(s)))

    ours, theirs = both(chain(augmentor, processors), chain(jax_augmentor, jax_processors), built, seed)
    keys = ["node_property", "edge_mask_indices", "edge_mask_targets", "pairwise_distance_indices",
            "pairwise_distance_targets", "pairwise_similarity_indices", "pairwise_similarity_targets",
            "graph_edit_distance", "dgi"]
    for a, b in zip(ours, theirs):
        assert_same({k: a[k] for k in keys}, {k: b[k] for k in keys})
        assert a["graph_edit_distance"] >= len(a["graph_edit_history"])


def test_label_processors_match(built):
    """CLNodeLabeling with ignored classes, EdgeLabeling on added linkings
    (directed and not), GraphLabeling on a graph-level class name."""
    ours, theirs = (copy.deepcopy(side) for side in built)
    for side in (ours, theirs):
        for sample in side:
            sample["ignored_classes"] = sample["classes"][:2]
            sample["graph_label"] = sample["classes"][1]
            lines = sorted(sample["label"].items())
            lines[0][1]["linking"] = [[[sample["classes"][0], "key"], [sample["classes"][2], "value"]]]
    pairs = [(processors.CLNodeLabeling(), jax_processors.CLNodeLabeling(), "node_label"),
             (processors.EdgeLabeling(), jax_processors.EdgeLabeling(), "link_label"),
             (processors.EdgeLabeling(is_directed=True), jax_processors.EdgeLabeling(is_directed=True),
              "link_label"),
             (processors.GraphLabeling(), jax_processors.GraphLabeling(), "graph_label")]
    for mine, theirs_processor, key in pairs:
        out_ours, out_theirs = both(mine, theirs_processor, (ours, theirs))
        for a, b in zip(out_ours, out_theirs):
            assert_same(a[key], b[key], key)
    assert out_ours[0]["graph_label"] == built[0][0]["class_to_id"][built[0][0]["classes"][1]]["value"]


@pytest.mark.parametrize("only_selected", [False, True])
def test_numpy_padding_matches(only_selected):
    """Symmetric pads to the shape of the largest product, per-name values,
    an item without the array left alone; where that shape is not the
    per-axis maximum (a (1, 9) item beside a (4, 3) one: the reference's
    quirk), the pad is negative and numpy raises, in both packages."""
    rng = np.random.RandomState(2)
    shapes = [(4, 3), (2, 2), (1, 3), (3, 1)]
    batch = [{"a": rng.rand(*shape), "b": rng.randint(0, 5, shape[0] * 2).astype(np.int64),
              "c": float(i)} for i, shape in enumerate(shapes[:3])]
    batch.append({"a": rng.rand(*shapes[3]), "c": 3.0})
    pairs = {"a": -100, "b": 0, "c": 7}
    ours = collate.NumpyPadding(pairs, only_selected)(copy.deepcopy(batch))
    theirs = jax_collate.NumpyPadding(pairs, only_selected)(copy.deepcopy(batch))
    assert_same(ours, theirs)
    assert ours[1]["a"].shape == (4, 3) and ours[1]["a"][0, 0] == -100 and "b" not in ours[3]
    quirk = [{"a": np.zeros((1, 9))}, {"a": np.zeros((4, 3))}]
    for padding in (collate.NumpyPadding, jax_collate.NumpyPadding):
        with pytest.raises(ValueError, match="negative"):
            padding({"a": 0})(copy.deepcopy(quirk))


def test_ssl_chain_through_dataset_and_collate_matches(files):
    """``make_split(ssl=True)`` through each package's dataset, collate
    chain and loader, two epochs: every array of every batch bit for bit."""
    split = ssl_split(files)
    loaders = []
    for factory in (BaseDataLoader, JaxBaseDataLoader):
        maker = factory({"seed": SEED})
        loaders.append(maker._get_dataloader(maker._load_dataset("CassiaDataset", split), split))
    ours, theirs = loaders
    assert len(ours) == len(theirs) == 2
    for epoch in range(2):
        np.random.seed(epoch)
        batches_ours = list(ours)
        np.random.seed(epoch)
        batches_theirs = list(theirs)
        assert len(batches_ours) == len(batches_theirs) == 2
        for a, b in zip(batches_ours, batches_theirs):
            assert set(b) >= {"pairwise_similarity_indices", "graph_edit_distance", "dgi",
                              "aug_adjacency_matrix", "negative_textline_encoding", "node_mask"}
            assert_same(a, b, f"epoch {epoch}")


def test_processor_chain_resolution(files):
    """``augmentations`` come from the augmentors; a ``data_process`` name
    from the processors, else the augmentors; an unknown name raises."""
    config = {key: value for key, value in make_split(*files, ssl=True).items() if key != "data_collate"}
    config["augmentations"] = {"DGINegativeSampling": {"seed": 1}}
    ours, theirs = datasets.CassiaDataset(config), jax_datasets.CassiaDataset(config)
    assert [type(p).__name__ for p in ours.data_processors] == [type(p).__name__ for p in theirs.data_processors]
    assert type(ours.data_processors[0]) is augmentor.DGINegativeSampling
    for key, name in (("augmentations", "NoSuchAugmentor"), ("data_process", "NoSuchProcessor")):
        with pytest.raises(KeyError, match=name):
            datasets.CassiaDataset({**config, key: {name: {}}})


def test_corpus_writes_the_same_files(files, tmp_path):
    """Cassia pages, a datapile and a dm page, and a file that is not JSON."""
    data_dir = files[0]
    extra = tmp_path / "extra"
    extra.mkdir()
    region = {"region_attributes": {"label": "Ｔｏｔａｌ：", "formal_key": "total"}}
    (extra / "datapile.json").write_text(json.dumps(
        {"attributes": {"_via_img_metadata": {"regions": [region]}}}))
    (extra / "dm.json").write_text(json.dumps(
        {"regions": [{"region_attributes": {"text": "ｶﾀｶﾅ", "formal_key": "kana"}}]}))
    (extra / "broken.json").write_text("{not json")
    folders = [data_dir, str(extra), str(tmp_path / "missing")]
    for normalized in (True, False):
        ours = corpus.build_corpus_and_classes(folders, str(tmp_path / f"ours{normalized}"), normalized)
        theirs = jax_corpus.build_corpus_and_classes(folders, str(tmp_path / f"theirs{normalized}"), normalized)
        for mine, reference in zip(ours, theirs):
            assert Path(mine).name == Path(reference).name
            assert Path(mine).read_bytes() == Path(reference).read_bytes()
    assert "total" in json.loads(Path(ours[1]).read_text())["classes"]


def test_chip_smoke_chain_is_this_chain(files):
    """chip_smoke.py's ssl phase feeds the chain these tests hold to
    grl_tpu's, at its batch size and with the loader's prefetch thread."""
    import chip_smoke

    expected = ssl_split(files)
    expected.update(batch_size=chip_smoke.B, shuffle=True)
    del expected["prefetch"]
    assert chip_smoke.ssl_split(*files, shuffle=True) == expected
