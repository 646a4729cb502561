"""Demo training entry point: the port's counterpart of
``scripts/demo_training.py``.

Usage::

    python -m grl_torch.demo_training --config configs/synthetic_kv.yaml [--epochs N] [--device cuda|cpu]

If the config carries a ``synthetic_data`` block with unset data paths, a
synthetic sumi-style dataset is generated first (under
``<output_dir>/synthetic_data``) and the config is patched in memory: the
data paths and the model's ``input_dim``. ``--device`` is where the model
runs: the GPU unless ``--device cpu`` is given; with no GPU the run stops
and names the flag instead of carrying on on the CPU. Prints the final
metric the procedure returns (``final macro F1: ...``).

Several processes train one model through the ``GRL_*`` launch contract
(:mod:`grl_torch.parallel.distributed`) and a ``parallel.mesh`` over as
many devices, e.g. two on the CPU::

    for i in 0 1; do GRL_COORDINATOR_ADDRESS=localhost:29511 GRL_NUM_PROCESSES=2 \
      GRL_PROCESS_ID=$i python -m grl_torch.demo_training --config ... --device cpu & done

Each rank generates its own copy of the synthetic dataset (the same seed
gives the same pages).
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

from grl_torch.utils.device import resolve_device


def maybe_generate_synthetic(config):
    """Generate the synthetic dataset and patch ``config`` to it where the
    config asks for one and names no training data (``scripts/
    demo_training.py:20-42``)."""
    if "synthetic_data" not in config:
        return config
    training = config.data_config.training
    if training.get("data_path"):
        return config
    from grl_torch.data.synthetic import synthetic_dataset_files

    from grl_torch.parallel.distributed import rank

    name = "synthetic_data" if rank() == 0 else f"synthetic_data_rank{rank()}"
    out_dir = os.path.join(config.get("output_dir", "./outputs"), name)
    num_pages = int(config.synthetic_data.get("num_pages", 64))
    data_dir, classes_path, charset_path = synthetic_dataset_files(
        out_dir, num_pages=num_pages, seed=int(config.get("seed", 0))
    )
    with open(charset_path) as handle:
        charset = json.load(handle)["charset"]
    for split in ("training", "validation"):
        split_cfg = config.data_config[split]
        split_cfg["data_path"] = [data_dir]
        split_cfg["class_path"] = classes_path
        split_cfg["charset_path"] = charset_path
    config.model.args["input_dim"] = len(charset) + 4
    return config


def main(argv: Optional[Sequence[str]] = None) -> float:
    parser = argparse.ArgumentParser(description="grl_torch training")
    parser.add_argument("--config", required=True, help="Path to YAML config.")
    parser.add_argument("--epochs", type=int, default=None, help="override num_epochs")
    parser.add_argument("--device", default=None, help="cuda|cpu (default: the GPU)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device, flag="--device cpu")

    from grl_torch.config import load_config
    from grl_torch.parallel.distributed import initialize_distributed
    from grl_torch.warper import GNNLearningWarper

    config = load_config(args.config)
    initialize_distributed(config, device)
    config = maybe_generate_synthetic(config)
    if args.epochs is not None:
        config["num_epochs"] = args.epochs
    warper = GNNLearningWarper(config=config, device=device)
    final = float(warper.train())
    print(f"final macro F1: {final:.4f}", flush=True)
    return final


if __name__ == "__main__":
    main()
