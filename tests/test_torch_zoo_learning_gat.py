"""The ``zoo`` phase's learning recipe in both packages on the CPU
(``tests/test_torch_zoo_learning.py``) for ``GATV2`` (``use_v2`` true and
false), which holds ``chip_smoke.ZOO_LEARN_SHARE`` too.

Run as a script, it measures the recipe for the GAT networks at the
``zoo`` phase's shape instead, on the first ``--pages`` of its training
pages (230 boxes, N 256, input 4369, 53 classes) at ``--lr``; the ratios
behind ``chip_smoke.ZOO_LEARN_LR`` (PERF.md §6)::

    python tests/test_torch_zoo_learning_gat.py --pages 2 --lr 5e-3
"""
from __future__ import annotations

import argparse
import copy
import os
import sys
import tempfile

import pytest
import torch

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [TESTS, os.path.dirname(TESTS)]

from test_torch_zoo_learning import check_learning_limit, first_batch, jax_ratio, port_ratio  # noqa: E402,F401


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", ["GATV2", "GATV2 v1"])
def test_zoo_learning_limits_follow_grl_tpu(first_batch, name):  # noqa: F811
    check_learning_limit(first_batch, name)


def main() -> None:
    import numpy as np

    import jax

    jax.config.update("jax_default_matmul_precision", "highest")
    import chip_smoke
    from grl_torch.data.dataloader import BaseDataLoader

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--pages", type=int, default=2)
    parser.add_argument("--lr", type=float, default=5e-3)
    args = parser.parse_args()
    tmp = tempfile.mkdtemp()
    dirs, classes_path, charset_path = chip_smoke.write_training_files(tmp)
    split = copy.deepcopy(chip_smoke.train_config(tmp, dirs, classes_path, charset_path)["data_config"]["training"])
    split.update(shuffle=False, batch_size=args.pages)
    maker = BaseDataLoader({"seed": 0})
    batch = next(iter(maker._get_dataloader(maker._load_dataset("CassiaDataset", split), split)))
    V = np.asarray(batch["textline_encoding"], np.float32)
    A = np.asarray(batch["adjacency_matrix"], np.float32)
    labels = np.asarray(batch["node_label"])
    classes = chip_smoke.NUM_CLASSES * 2 + 1
    for name, v2 in (("GATV2", True), ("GATV2 v1", False)):
        net = {"input_feature": V.shape[-1], "no_A": chip_smoke.L, "num_classes": classes, "use_v2": v2}
        theirs = jax_ratio("GATV2", net, V, A, labels, tmp, args.lr, classes)
        ours = port_ratio("GATV2", net, V, A, labels, tmp, args.lr, classes)
        print(f"{name} on {V.shape} at lr {args.lr}: grl_tpu {theirs:.4f}, grl_torch {ours:.4f}", flush=True)


if __name__ == "__main__":
    main()
