"""Synthetic IoT-style datasets mirroring the paper's two benchmarks.

* tracking_like — feature vectors of moving objects from an IoVT camera
  simulator [paper DB1]: 62,702 x 20, trajectory-clustered (objects move
  along smooth tracks -> dense elongated clusters + sensor noise).
* ward_like — Wearable Action Recognition Database [paper DB2]:
  1,000,000 x 5 motion-sensor windows; a small number of dense activity
  clusters with heavy within-class concentration.
* embedding_datastore — kNN-LM (key, next-token) pairs: clustered
  hidden-state keys with token ids.

Host numpy, the same generators as the JAX package's
``repro.data.synthetic``: the same seed gives the same array.
``embedding_datastore_on`` draws the same recipe on a torch device from a
``torch.Generator`` (other numbers than numpy's, the same distribution), for
datastores too large to build through float64 numpy on the host.
"""
from __future__ import annotations

import numpy as np
import torch


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


def embedding_datastore(
    n: int, dim: int, *, n_clusters: int = 32, seed: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """(keys, token_values) for the kNN-LM datastore: clustered hidden-state
    keys with associated next-token ids."""
    g = np.random.default_rng(seed)
    centers = g.normal(size=(n_clusters, dim)) * 4.0
    lab = g.integers(0, n_clusters, n)
    keys = centers[lab] + g.normal(size=(n, dim)) * 0.5
    tokens = (lab * 97 + g.integers(0, 13, n)) % 50_000
    return keys.astype(np.float32), tokens.astype(np.int32)


def embedding_datastore_on(
    device, n: int, dim: int, *, n_clusters: int = 32, seed: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """``embedding_datastore``'s recipe drawn on ``device`` in f32: centres
    N(0, 4^2), keys = centre + N(0, 0.5^2), tokens ``(label * 97 + U{0..12})
    mod 50,000``; (N, dim) f32 keys and (N,) i32 tokens."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    centers = torch.randn((n_clusters, dim), generator=g, device=device) * 4.0
    lab = torch.randint(0, n_clusters, (n,), generator=g, device=device)
    keys = torch.randn((n, dim), generator=g, device=device).mul_(0.5).add_(centers[lab])
    tokens = (lab * 97 + torch.randint(0, 13, (n,), generator=g, device=device)) % 50_000
    return keys, tokens.to(torch.int32)
