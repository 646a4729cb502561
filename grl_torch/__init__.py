"""grl_torch — the PyTorch/CUDA port of ``grl_tpu``.

Same YAML schema, registries, cassia I/O contract and model family as
``grl_tpu``, executed eagerly by PyTorch on an NVIDIA Hopper GPU. Plain
tensor work goes through PyTorch; every Pallas kernel of ``grl_tpu`` on a
ported path is a hand-written Hopper kernel under ``grl_torch/csrc``,
built at first use (:mod:`grl_torch.ops._build`).

The package imports neither JAX nor ``grl_tpu``: the numpy-only stages
it needs are its own copies. Entry points (:class:`GNNLearningWarper`,
:class:`grl_torch.inferencer.KVInference`, model construction) run on
CUDA unless the caller passes ``device="cpu"``; with no device argument
and no GPU they raise ``RuntimeError``.
"""

from grl_torch.version import __version__
from grl_torch.warper import GNNLearningWarper

_packages = [
    "grl_torch.ops",
    "grl_torch.models",
    "grl_torch.data",
    "grl_torch.trainer",
    "grl_torch.inferencer",
    "grl_torch.parallel",
    "grl_torch.utils",
    "grl_torch.probes",
]

__all__ = ["GNNLearningWarper", "__version__", "_packages"]
