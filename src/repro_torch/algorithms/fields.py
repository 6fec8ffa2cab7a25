"""Synthetic scalar fields (the subset the critical-points path uses)."""

from __future__ import annotations

import numpy as np


def gaussians(seed: int = 0, k: int = 6, sigma: float = 6.0, scale=32.0):
    """Sum of k random Gaussian bumps — a generic multi-extremum field.
    Drawn from a numpy generator, so a seed gives the reference's field."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, scale, size=(k, 3))
    signs = rng.choice([-1.0, 1.0], size=k)

    def fn(p):
        p = np.asarray(p, dtype=np.float64)
        acc = np.zeros(len(p))
        for c, s in zip(centers, signs):
            d2 = ((p - c[None, :]) ** 2).sum(axis=1)
            acc += s * np.exp(-d2 / (2 * sigma * sigma))
        return acc.astype(np.float32)
    return fn
