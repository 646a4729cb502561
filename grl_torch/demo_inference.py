"""Demo inference entry point: the port's counterpart of
``scripts/demo_inference.py``.

Usage::

    python -m grl_torch.demo_inference --config <cfg.yaml> --input page.json [--output out.json] [--device cuda|cpu]

Input: a cassia-format JSON file of ``{"location": [[x,y]x4], "text":
...}`` boxes. Output: the same boxes annotated with ``key_type``,
``formal_key`` and ``confidence``, written to ``--output`` or the first
five printed. A config that leaves the model's ``input_dim`` unset takes
it from the charset (``len(charset) + 4``). ``--device`` as in
:mod:`grl_torch.demo_training`.
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

from grl_torch.utils.device import resolve_device


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description="grl_torch inference")
    parser.add_argument("--config", required=True)
    parser.add_argument("--input", required=True, help="cassia-format JSON path")
    parser.add_argument("--output", default=None, help="where to write predictions")
    parser.add_argument("--device", default=None, help="cuda|cpu (default: the GPU)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device, flag="--device cpu")

    from grl_torch.config import load_config
    from grl_torch.warper import GNNLearningWarper

    config = load_config(args.config)
    config["is_train"] = False
    charset_path = config.get_path("inference_settings.datasets.args.charset_path")
    if charset_path and not config.get_path("model.args.input_dim"):
        with open(charset_path, encoding="utf-8-sig") as handle:
            charset = json.load(handle)["charset"]
        config.model.args["input_dim"] = len(charset) + 4
    warper = GNNLearningWarper(config=config, device=device)
    outputs = warper.predict(args.input)
    if args.output:
        with open(args.output, "w", encoding="utf-8") as handle:
            json.dump(outputs, handle, ensure_ascii=False, indent=2)
        print(f"wrote {args.output}", flush=True)
    else:
        print(json.dumps(outputs[:5], ensure_ascii=False, indent=2), flush=True)
    return outputs


if __name__ == "__main__":
    main()
