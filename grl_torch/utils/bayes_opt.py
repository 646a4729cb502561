"""Minimal Gaussian-process Bayesian optimization, numpy only.

Counterpart of ``grl_tpu/utils/bayes_opt.py``: an RBF-kernel GP surrogate
with expected-improvement acquisition maximised over random candidates,
for the low-dimensional searches of ``python -m grl_torch.bayes_training``
(the RanPAC ``lambda_value`` in [0, 1]). Candidates come from
``np.random.RandomState(random_state)`` in the same order, so both
packages probe the same points for the same objective.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np


class BayesianOptimization:
    def __init__(
        self,
        f: Callable[..., float],
        pbounds: Dict[str, Tuple[float, float]],
        random_state: int = 0,
        length_scale: float = 0.2,
        noise: float = 1e-6,
    ):
        self.f = f
        self.keys = sorted(pbounds)
        self.bounds = np.array([pbounds[k] for k in self.keys], dtype=np.float64)
        self.rng = np.random.RandomState(random_state)
        self.length_scale = length_scale
        self.noise = noise
        self.X: List[np.ndarray] = []
        self.y: List[float] = []

    # ------------------------------------------------------------------
    def _normalize(self, x: np.ndarray) -> np.ndarray:
        lo, hi = self.bounds[:, 0], self.bounds[:, 1]
        return (x - lo) / np.maximum(hi - lo, 1e-12)

    def _kernel(self, A: np.ndarray, B: np.ndarray) -> np.ndarray:
        d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
        return np.exp(-0.5 * d2 / self.length_scale**2)

    def _posterior(self, Xq: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        X = self._normalize(np.array(self.X))
        y = np.array(self.y)
        mean_y = y.mean()
        K = self._kernel(X, X) + self.noise * np.eye(len(X))
        Ks = self._kernel(self._normalize(Xq), X)
        alpha = np.linalg.solve(K, y - mean_y)
        mu = mean_y + Ks @ alpha
        v = np.linalg.solve(K, Ks.T)
        var = np.clip(1.0 - np.sum(Ks * v.T, axis=1), 1e-12, None)
        return mu, np.sqrt(var)

    def _expected_improvement(self, Xq: np.ndarray, xi: float = 0.01) -> np.ndarray:
        from math import erf, sqrt

        mu, sigma = self._posterior(Xq)
        best = max(self.y)
        z = (mu - best - xi) / sigma
        cdf = np.array([0.5 * (1 + erf(zi / sqrt(2))) for zi in z])
        pdf = np.exp(-0.5 * z**2) / np.sqrt(2 * np.pi)
        return (mu - best - xi) * cdf + sigma * pdf

    def _sample(self, n: int) -> np.ndarray:
        lo, hi = self.bounds[:, 0], self.bounds[:, 1]
        return lo + (hi - lo) * self.rng.rand(n, len(self.keys))

    # ------------------------------------------------------------------
    def probe(self, x: np.ndarray) -> float:
        params = {k: float(v) for k, v in zip(self.keys, x)}
        value = float(self.f(**params))
        self.X.append(x)
        self.y.append(value)
        return value

    def maximize(self, init_points: int = 5, n_iter: int = 15) -> None:
        for x in self._sample(init_points):
            self.probe(x)
        for _ in range(n_iter):
            candidates = self._sample(512)
            ei = self._expected_improvement(candidates)
            self.probe(candidates[int(np.argmax(ei))])

    @property
    def max(self) -> Dict[str, object]:
        best = int(np.argmax(self.y))
        return {
            "target": self.y[best],
            "params": {k: float(v) for k, v in zip(self.keys, self.X[best])},
        }
