"""KV inference: annotate raw OCR textlines with predicted (formal_key,
key_type, confidence).

Counterpart of ``grl_tpu/inferencer/kv_inference.py`` with the same I/O
contract, single-page handling and batching: pages are sorted by node
count, cut into ``batch_size``-page batches and padded to a 64-quantum
node bucket. The weights are loaded onto the device once; every batch is
copied to the device once and enqueued under ``torch.inference_mode()``,
and results are fetched only after every batch is enqueued, so the host
waits on the device once per request.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from grl_torch.config import ConfigDict, instantiate
from grl_torch.data.collate import next_bucket
from grl_torch.data.dataloader import BaseDataLoader
from grl_torch.utils.checkpoint import CheckpointHandler
from grl_torch.utils.device import DeviceLike, resolve_device
from grl_torch.utils.input_wrapper import cast_label_to_list, handle_single_input
from grl_torch.utils.logging import get_logger


class BaseProcedure:
    """Inference setup: device, checkpoint load, post-processor registry
    (reference: inference_procedures/base_procedure.py:13-144)."""

    def __init__(self, model: torch.nn.Module, config: ConfigDict,
                 device: DeviceLike = None, **kwargs: Any):
        self.logger = get_logger(self.__class__.__name__)
        self.config = ConfigDict(config)
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.checkpointer = CheckpointHandler()
        self.weights_loaded = self._load_checkpoint_weights()
        self.post_processors = self._load_post_processors()

    @classmethod
    def _from_config(cls, model: Any, config: ConfigDict, **kwargs: Any):
        return cls(model, config, **kwargs)

    def _load_checkpoint_weights(self) -> bool:
        """Load the checkpoint's ``model`` state dict straight onto the device."""
        path = self.config.get("checkpoint_path")
        if not path:
            self.logger.warning("No checkpoint_path configured — random params.")
            return False
        raw = self.checkpointer.restore_checkpoint(path, map_location=self.device)
        self.model.load_state_dict(raw["model"])
        return True

    def _load_post_processors(self) -> List[Any]:
        from grl_torch.inferencer import post_processing as pp_module

        chain = []
        for spec in self.config.get_path("inference_settings.post_processing", []) or []:
            chain.append(instantiate(pp_module, spec))
        return chain


class KVInference(BaseProcedure):
    def __init__(self, model: torch.nn.Module, config: ConfigDict, batch_size: int = 8,
                 device: DeviceLike = None, **kwargs: Any):
        super().__init__(model, config, device=device, **kwargs)
        self.batch_size = batch_size
        self.model.eval()
        loader_factory = BaseDataLoader(self.config)
        ds_spec = self.config.get_path("inference_settings.datasets")
        self.dataset = loader_factory._load_dataset(
            ds_spec["type"], ds_spec.get("args", {}), data_type="inference"
        )
        self.id_to_class = dict(self.dataset.id_to_class)
        self.id_to_class[0] = ("other", "other")

    def _forward(self, V: torch.Tensor, A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        logits = self.model((V, A))
        probs = torch.softmax(logits, dim=-1)
        return probs.amax(dim=-1), probs.argmax(dim=-1)

    def _encode_samples(
        self, samples: List[List[Dict[str, Any]]]
    ) -> List[Tuple[Dict[str, Any], int]]:
        self.dataset.list_samples = self.dataset._load_samples(samples)
        encoded = []
        for idx in range(len(self.dataset)):
            sample = self.dataset[idx]
            encoded.append((sample, len(sample["label"])))
        return encoded

    def _annotate(
        self,
        raw: List[Dict[str, Any]],
        classes: np.ndarray,
        scores: np.ndarray,
    ) -> List[Dict[str, Any]]:
        """Write key_type/formal_key/confidence back onto the input boxes
        (reference: kv_inference.py:64-77)."""
        outputs = []
        for i, box in enumerate(raw):
            formal_key, key_type = self.id_to_class[int(classes[i])]
            box = dict(box)
            box["key_type"] = key_type
            box["formal_key"] = formal_key
            box["confidence"] = float(scores[i])
            outputs.append(box)
        return outputs

    @handle_single_input(cast_label_to_list)
    def __call__(
        self, samples: Union[List[Dict[str, Any]], List[List[Dict[str, Any]]]]
    ) -> List[List[Dict[str, Any]]]:
        """Predict entities for cassia-format pages.

        Each page is a list of ``{"location": [[x,y]x4], "text": ...}``
        boxes; outputs add ``key_type``/``formal_key``/``confidence`` per
        box. A single page (a list of box dicts) is also accepted and
        returns the annotated page itself.
        """
        if not self.weights_loaded:
            raise RuntimeError("KVInference requires a checkpoint_path.")
        samples = list(samples)
        single_page = bool(samples) and all(
            isinstance(box, dict) and "location" in box for box in samples
        )
        if single_page:
            samples = [samples]
        self.logger.info(f"Start processing {len(samples)} samples ...")
        encoded = self._encode_samples(samples)
        outputs: List[Optional[List[Dict[str, Any]]]] = [None] * len(encoded)

        # Same-bucket batches; every batch is enqueued on the device before
        # any result is fetched.
        order = sorted(range(len(encoded)), key=lambda i: encoded[i][1])
        pending = []
        with torch.inference_mode():
            for start in range(0, len(order), self.batch_size):
                chunk = order[start:start + self.batch_size]
                bucket = next_bucket(max(encoded[i][1] for i in chunk), quantum=64)
                feat_dim = encoded[chunk[0]][0]["textline_encoding"].shape[-1]
                V = np.zeros((len(chunk), bucket, feat_dim), np.float32)
                A = np.zeros((len(chunk), bucket, 6, bucket), np.float32)
                for row, i in enumerate(chunk):
                    sample, n = encoded[i]
                    V[row, :n] = sample["textline_encoding"]
                    adj = np.asarray(sample["adjacency_matrix"], np.float32)
                    A[row, :n, : adj.shape[1], :n] = adj
                scores, classes = self._forward(
                    torch.from_numpy(V).to(self.device), torch.from_numpy(A).to(self.device)
                )
                pending.append((chunk, scores, classes))
        for chunk, scores, classes in pending:
            scores, classes = scores.cpu().numpy(), classes.cpu().numpy()
            for row, i in enumerate(chunk):
                sample, n = encoded[i]
                raw = [sample["label"][k] for k in sorted(sample["label"])]
                page = self._annotate(raw, classes[row, :n], scores[row, :n])
                for processor in self.post_processors:
                    page = processor(page)
                outputs[i] = page
        return outputs[0] if single_page else outputs
