"""Synthetic IoT-style datasets mirroring the paper's two benchmarks.

* tracking_like — feature vectors of moving objects from an IoVT camera
  simulator [paper DB1]: 62,702 x 20, trajectory-clustered (objects move
  along smooth tracks -> dense elongated clusters + sensor noise).
* ward_like — Wearable Action Recognition Database [paper DB2]:
  1,000,000 x 5 motion-sensor windows; a small number of dense activity
  clusters with heavy within-class concentration.

Host numpy, the same generators as the JAX package's
``repro.data.synthetic``: the same seed gives the same array.
"""
from __future__ import annotations

import numpy as np


def tracking_like(n: int = 62_702, dim: int = 20, seed: int = 0) -> np.ndarray:
    g = np.random.default_rng(seed)
    n_tracks = 24
    out = []
    remaining = n
    for t in range(n_tracks):
        m = remaining if t == n_tracks - 1 else max(1, int(n / n_tracks))
        remaining -= m
        start = g.normal(size=dim) * 40.0
        heading = g.normal(size=dim)
        heading /= np.linalg.norm(heading)
        ts = np.sort(g.uniform(0, 30.0, m))[:, None]
        pts = start + ts * heading * 2.0 + g.normal(size=(m, dim)) * 0.8
        out.append(pts)
    x = np.concatenate(out)[:n]
    # 3% uniform sensor-noise outliers
    k = max(1, int(0.03 * n))
    idx = g.choice(n, k, replace=False)
    x[idx] = g.uniform(x.min(), x.max(), size=(k, dim))
    return x.astype(np.float32)


def ward_like(n: int = 1_000_000, dim: int = 5, seed: int = 1) -> np.ndarray:
    g = np.random.default_rng(seed)
    n_classes = 13  # WARD's 13 activity classes
    centers = g.normal(size=(n_classes, dim)) * 25.0
    sizes = g.dirichlet(np.ones(n_classes) * 2.0)
    out = []
    for c, frac in zip(centers, sizes):
        m = max(1, int(n * frac))
        cov = g.uniform(0.5, 3.0, size=dim)
        out.append(c + g.normal(size=(m, dim)) * cov)
    x = np.concatenate(out)[:n]
    if len(x) < n:
        x = np.concatenate([x, g.normal(size=(n - len(x), dim)) * 25.0])
    return x.astype(np.float32)
