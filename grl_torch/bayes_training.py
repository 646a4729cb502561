"""Bayesian search over the RanPAC lambda: the port's counterpart of
``scripts/bayes_training.py``.

Usage::

    python -m grl_torch.bayes_training --config configs/synthetic_kv.yaml \
        [--init-points 5] [--n-iter 15] [--rp-size 128] [--device cuda|cpu]

Each probe trains a fresh ``RPGraphCNNDropEdge(rp_size=..., lambda_value=...)``
(parameters drawn from a generator seeded by the config's ``seed``) through
``GNNLearningWarper`` for the config's ``num_epochs`` and scores it by the
validation macro F1 the procedure returns; the Gaussian-process search
(:mod:`grl_torch.utils.bayes_opt`, seeded 1234) picks the next lambda in
[0, 1]. A config with a ``synthetic_data`` block and no data paths gets
its synthetic dataset first, as ``grl_torch.demo_training`` does.
``--device`` is where the models run: the GPU unless ``--device cpu`` is
given. Prints ``Best parameters: lambda=... f1=...``.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from grl_torch.utils.device import resolve_device


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description="Bayesian lambda search")
    parser.add_argument("--config", required=True)
    parser.add_argument("--init-points", type=int, default=5)
    parser.add_argument("--n-iter", type=int, default=15)
    parser.add_argument("--rp-size", type=int, default=128)
    parser.add_argument("--device", default=None, help="cuda|cpu (default: the GPU)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device, flag="--device cpu")

    import torch

    from grl_torch.config import load_config
    from grl_torch.demo_training import maybe_generate_synthetic
    from grl_torch.models import RPGraphCNNDropEdge
    from grl_torch.utils.bayes_opt import BayesianOptimization
    from grl_torch.warper import GNNLearningWarper

    base_config = maybe_generate_synthetic(load_config(args.config))

    def objective(lambda_value: float) -> float:
        config = base_config.copy()
        config["experiment_name"] = f"{config['experiment_name']}-bayes-lambda-{lambda_value:.4f}"
        model_args = dict(config.model.args)
        model = RPGraphCNNDropEdge(
            input_dim=int(model_args["input_dim"]),
            output_dim=int(model_args["output_dim"]),
            num_edges=int(model_args["num_edges"]),
            net_size=int(model_args.get("net_size", 256)),
            rp_size=args.rp_size,
            lambda_value=lambda_value,
            device=device,
            generator=torch.Generator().manual_seed(int(config.get("seed", 0))),
        )
        return float(GNNLearningWarper(model, config=config, device=device).train())

    optimizer = BayesianOptimization(f=objective, pbounds={"lambda_value": (0.0, 1.0)}, random_state=1234)
    optimizer.maximize(init_points=args.init_points, n_iter=args.n_iter)
    best = optimizer.max
    print(f"Best parameters: lambda={best['params']['lambda_value']:.4f} f1={best['target']:.4f}", flush=True)
    return best


if __name__ == "__main__":
    main()
