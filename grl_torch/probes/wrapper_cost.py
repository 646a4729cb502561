"""What one K3, K1 or K2 call costs the host, beside its device time, in
any checkout of the repo; and, with ``--train``, that checkout's train
step.

The flagship's train step is bound by the host's enqueue (the device sits
idle for most of it, ``chip_smoke.py`` phase ``train``), so a wrapper that
takes longer to enqueue its kernel can slow the step while its kernel gets
faster. At bf16 B=8 N=256 L=6, F = 256 and 512, rate 0.3, density 0.002,
through the public wrappers of ``grl_torch.ops.relagg``, bf16 K3, K1 and
K2, then float32 K3 (the control: ``dropedge_f32.cu``'s forward with the
mask compiled out, launched through the same kind of wrapper as float32
K2) and float32 K2, each row holds

* ``enqueue_ms``: the median host time of one call, the card kept busy;
* ``ms``: CUDA events around one call after an L2 flush, as
  ``chip_smoke.py`` times every kernel row: the host's enqueue counts where
  it outlasts the flush;
* ``device_ms``: the same with the card kept busy until the call is
  enqueued, so the events hold the device's work alone.

``--train`` then runs the checkout's own ``chip_smoke.py`` train phase
(16 steps of the flagship at full width, with its checks) and reports its
``step_ms``: one train step timed on the card.

Run it by path, so that ``--root`` picks the checkout whose ``grl_torch``
and ``chip_smoke.py`` it measures (default: the one this file is in); the
timers are always this file's checkout's (``chip_smoke.time_ms`` and
``enqueue_ms``)::

    python grl_torch/probes/wrapper_cost.py [--root CHECKOUT] [--train]

It needs an NVIDIA GPU and prints one JSON line.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

OWN_ROOT = Path(__file__).resolve().parents[2]
N, FS, DENSITY, RATE, SEED = 256, (256, 512), 0.002, 0.3, 7


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(OWN_ROOT), help="checkout to measure")
    parser.add_argument("--train", action="store_true", help="also time its train step")
    args = parser.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("wrapper_cost: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    timers = load_module(OWN_ROOT / "chip_smoke.py", "_wrapper_cost_timers")
    smoke = load_module(root / "chip_smoke.py", "chip_smoke") if root != OWN_ROOT else timers
    from grl_torch.ops import relagg

    if Path(relagg.__file__).resolve().parents[2] != root:
        raise RuntimeError(f"imported {relagg.__file__}, not the grl_torch of {root}")
    torch.cuda.set_device(0)
    card = smoke.phase_env(torch)  # TF32 off, every kernel built
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    rows = []
    for F in FS:
        V, A = timers.operands(torch, "bfloat16", N, F, DENSITY, SEED)
        g = torch.randn(*A.shape[:3], F, device="cuda").to(torch.bfloat16)
        V32, A32, g32 = V.float(), A.float(), g.float()
        calls = {"K3": lambda: relagg.neighbor_aggregate(V, A),
                 "K1": lambda: relagg.dropedge_aggregate(V, A, SEED, RATE),
                 "K2": lambda: relagg.dropedge_aggregate_grad(g, A, SEED, RATE),
                 "K3 f32": lambda: relagg.neighbor_aggregate(V32, A32),
                 "K2 f32": lambda: relagg.dropedge_aggregate_grad(g32, A32, SEED, RATE)}
        for name, call in calls.items():
            rows.append({"kernel": name, "F": F, "enqueue_ms": timers.enqueue_ms(torch, call),
                         "ms": timers.time_ms(torch, call, flush),
                         "device_ms": timers.time_ms(torch, call, flush, cover=True)})
    del flush
    result = {"root": str(root), "card": card, "shape": f"B={timers.B} N={N} L={timers.L} rate={RATE}",
              "rows": rows}
    if args.train:
        result["step_ms"] = smoke.phase_train(torch, card)["step_ms"]
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
