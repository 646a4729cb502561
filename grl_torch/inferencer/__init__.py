from grl_torch.inferencer import post_processing
from grl_torch.inferencer.kv_inference import BaseProcedure, KVInference


class inference_procedures:  # noqa: N801 — registry namespace
    """Name-lookup namespace for config-driven procedure selection."""

    BaseProcedure = BaseProcedure
    KVInference = KVInference


__all__ = ["BaseProcedure", "KVInference", "inference_procedures", "post_processing"]
