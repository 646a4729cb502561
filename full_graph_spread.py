"""Where two full-graph train steps at dropout 0.5 lose the agreement of
the kernel path and the plain path.

Runs on one NVIDIA GPU from a checkout: ``python3 full_graph_spread.py
[--json PATH]``. It builds ``chip_smoke.py``'s ``full_graph`` setup
(``configs/arxiv_full_graph.yaml`` with ``kernel_impl: pallas_csr`` and
sparse attention) and the weights of its learning check (the config's
200 steps at lr 1e-3), then takes two steps at the config's dropout 0.5
from those weights, in float32 and bfloat16, and compares:

- the kernels against the plain versions, in deterministic mode;
- each of six runs of the plain versions in other summation orders
  (outside deterministic mode, where ``index_add_`` sums in an order that
  changes from run to run) against the deterministic plain run and
  against the kernel run: which of the two it lands beside.

``chip_smoke.py`` holds the pair it can: a plain first step and a kernel
second step against two plain steps.

For each pair and step it prints ``chip_smoke.compare_steps``' measures
and whether they break ``FULL_GRAPH_STEP_LIMITS``; for the kernel pair
also the parameter entries the two runs leave further apart than lr/10,
by tensor, and the furthest such entries among those whose gradient is at
least ten times Adam's eps in both runs, with their gradients at each step
(kernel run first).
"""
import argparse
import json
import sys
import tempfile

import chip_smoke as smoke

# Plain runs in other summation orders, each compared with both sides.
OTHER_ORDERS = 6


def far_entries(run, reference, lr):
    """Per step, the entries further apart than lr/10, counted by tensor."""
    return [{n: int(c) for n, v in ref.items() if (c := ((mine[n] - v).abs() > lr / 10).sum())}
            for mine, ref in zip(run[1][1:], reference[1][1:])]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", help="write every row here")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; this script runs on an NVIDIA GPU")
        return 1
    import grl_torch

    config = smoke.full_graph_config(tempfile.mkdtemp(prefix="grl_torch_spread_"))
    trainer = grl_torch.GNNLearningWarper(config=config).trainer
    lr, K = smoke.FULL_GRAPH_LEARN_LR, int(config["scan_steps"])
    learner = smoke.procedure_copy(torch, trainer, int(config["seed"]), lr)
    for _ in range(smoke.FULL_GRAPH_LEARN_STEPS // K):
        learner.train_steps(K)
    learned = {k: v.detach().clone() for k, v in learner.model.state_dict().items()}
    del learner

    results = []

    def report(dtype, name, run, reference, details):
        rows = smoke.compare_steps(run, reference, lr)
        failed = smoke.step_failures(rows, smoke.FULL_GRAPH_STEP_LIMITS[dtype], scores=True)
        far = far_entries(run, reference, lr)
        results.append({"dtype": dtype, "pair": name, "failed_steps": failed, "far_by_tensor": far, "rows": rows})
        for k, row in enumerate(rows):
            print(f"{dtype} {name}, step {k + 1}: loss rel {row['loss_rel_diff']:.2e}; moved share beyond "
                  f"lr/10 {row['moved_share_beyond_lr_10']:.2e} of {row['moved']}; held entries beyond lr/10 "
                  f"{row['held_beyond_lr_10']} of {row['held']}; gradient rel diff {row['grad_rel_diff']:.2e}, "
                  f"score projections {row['score_grad_rel_diff']:.2e}; outside the limits: {k in failed}")
            if details:
                print(f"  beyond lr/10 by tensor {far[k]}; the largest difference "
                      f"{row['param_max_diff']:.3e} at {row['param_max_diff_at']}")
                for entry in row["held_beyond_lr_10_furthest"]:
                    print(f"  held {entry}")

    for dtype in ("float32", "bfloat16"):
        def two(swap=None, det=True):
            with smoke.deterministic(torch, det):
                return smoke.two_full_graph_steps(torch, trainer, learned, dtype, lr, swap, smoke.DROPOUT_ON)

        plain, kernel = two(smoke.plain_sparse()), two()
        report(dtype, "kernel vs plain", kernel, plain, True)
        for n in range(OTHER_ORDERS):
            other = two(smoke.plain_sparse(), det=False)
            report(dtype, f"plain in another order ({n + 1}) vs plain", other, plain, False)
            report(dtype, f"plain in another order ({n + 1}) vs kernel", other, kernel, False)
    if args.json:
        with open(args.json, "w") as out:
            json.dump(results, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
