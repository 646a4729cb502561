"""KV node-classification training of the dense zoo's networks on a corpus
held on the card: :mod:`portbench.harness.families.kv`'s cell, with a
network whose constructor keys are not the flagship's.

A zoo configuration's ``model`` block holds its network's constructor
arguments (``GATV2``: ``input_feature``, ``no_A``, ``output_feature``,
``num_classes``, ``use_v2``) and computes in float32, with no
``compute_dtype``. The family builds the network from those arguments
alone and hands the kv family the keys it reads: ``num_edges`` (the
relations, from ``no_A``), ``output_dim`` (the classes, from
``num_classes``) and ``compute_dtype`` (``float32`` where none is stated).
Everything else (the pages, the encode, the check's chunks through
``run_chunk``, the window, the reference's steps) is the kv family's.

Where the device is not a CUDA card (the harness's CPU tests), the
configuration's ``cpu`` block cuts the data, the model's input and class
widths and the traffic to a size that runs in seconds; the card always
runs the configuration as it is written.
"""
from __future__ import annotations

from typing import Dict

from portbench.harness.families import kv

# Imported in the import phase of set-up: the kv family's modules.
import_program = kv.import_program


def kv_keys(model: Dict) -> Dict:
    """``model`` with the keys the kv family reads, from the zoo's."""
    return {**model, "num_edges": model["no_A"], "output_dim": model["num_classes"],
            "compute_dtype": model.get("compute_dtype", "float32")}


def constructor(model: Dict) -> Dict:
    """The network's constructor arguments: ``model`` without its type and
    the compute dtype, which the zoo's networks do not take."""
    return {k: v for k, v in model.items() if k not in ("type", "compute_dtype")}


class Family(kv.Family):
    def __init__(self, torch, cell, seed: int, device, workdir: str):
        super().__init__(torch, cell, seed, device, workdir)
        config, traffic = self.config, self.traffic
        if self.device.type != "cuda":
            cut = config.get("cpu", {})
            config = {**config, "data": {**config["data"], **cut.get("data", {})},
                      "model": {**config["model"], **cut.get("model", {})}}
            traffic = {**traffic, **cut.get("traffic", {})}
        self.constructor = constructor(config["model"])
        self.config, self.traffic = {**config, "model": kv_keys(config["model"])}, traffic

    def build_model(self):
        """The configuration's network (its ``model.type`` in the program's
        registry) from its constructor arguments, on the device, holding
        the benchmark's weights."""
        from grl_torch.models import create_model

        net = create_model(self.config["model"]["type"], **self.constructor, device=self.device)
        net.load_state_dict(self.weights, strict=True)
        return net
