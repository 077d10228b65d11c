"""Frozen copies of the port's two dataset generators, split into a geometry
and a sample, both fixed by the configuration.

``repro_torch.data.synthetic.ward_like`` / ``tracking_like`` draw the class
centres, sizes and scales (or the tracks' starts and headings) from the same
generator as the points.  Here the geometry comes from the configuration's
``geometry_seed``: the generator of that seed is replayed draw for draw as the
original runs it (the point draws included, so each later geometry draw lands
where it does there), and the geometry it yields is that of
``ward_like(seed=geometry_seed)`` / ``tracking_like(seed=geometry_seed)``.  The
points within that geometry, the background rows and the outliers come from
the configuration's ``sample_seed``.  A run's ``--seed`` draws the queries
(``traffic.py``), never the rows the index is built from: a new sample of
Tracking's rows builds another forest, whose device time a call differs by
up to a fifth, so the rows are part of the deployment.  What a stream writes
later (``writes``) are fresh readings of the same geometry, drawn from the
run's seed in fixed amounts a class.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np


def sample_rng(seed: int, tag: int) -> np.random.Generator:
    """A generator for one use (``tag``) of a seed; any Python int."""
    return np.random.default_rng([tag, seed % (1 << 64)])


class WardGeometry(NamedTuple):
    centers: np.ndarray  # (classes, D)
    counts: np.ndarray  # (classes,) rows per class
    scales: np.ndarray  # (classes, D) per-axis standard deviations
    background: int  # rows drawn N(0, 25^2) to fill the set to n


def ward_geometry(n: int, dim: int, classes: int, geometry_seed: int) -> WardGeometry:
    g = np.random.default_rng(geometry_seed)
    centers = g.normal(size=(classes, dim)) * 25.0
    sizes = g.dirichlet(np.ones(classes) * 2.0)
    counts, scales = [], []
    for frac in sizes:
        m = max(1, int(n * frac))
        scales.append(g.uniform(0.5, 3.0, size=dim))
        g.normal(size=(m, dim))  # the class's points: replayed, not kept
        counts.append(m)
    counts = np.asarray(counts)
    # the original truncates the concatenation to n rows
    keep = np.minimum(counts, np.maximum(n - np.concatenate([[0], np.cumsum(counts)[:-1]]), 0))
    return WardGeometry(centers, keep, np.asarray(scales), int(max(0, n - keep.sum())))


def ward_sample(geo: WardGeometry, seed: int) -> np.ndarray:
    g = sample_rng(seed, 1)
    parts = [c + g.normal(size=(m, len(c))) * s
             for c, m, s in zip(geo.centers, geo.counts, geo.scales)]
    if geo.background:
        parts.append(g.normal(size=(geo.background, geo.centers.shape[1])) * 25.0)
    return np.concatenate(parts).astype(np.float32)


class TrackingGeometry(NamedTuple):
    starts: np.ndarray  # (tracks, D)
    headings: np.ndarray  # (tracks, D) unit vectors
    counts: np.ndarray  # (tracks,) rows per track
    outliers: int  # rows replaced by uniform sensor noise


def tracking_geometry(n: int, dim: int, tracks: int, outlier_share: float,
                      geometry_seed: int) -> TrackingGeometry:
    g = np.random.default_rng(geometry_seed)
    starts, headings, counts = [], [], []
    remaining = n
    for t in range(tracks):
        m = remaining if t == tracks - 1 else max(1, int(n / tracks))
        remaining -= m
        starts.append(g.normal(size=dim) * 40.0)
        h = g.normal(size=dim)
        headings.append(h / np.linalg.norm(h))
        g.uniform(0, 30.0, m)  # the track's times: replayed, not kept
        g.normal(size=(m, dim))  # its sensor noise: replayed, not kept
        counts.append(m)
    return TrackingGeometry(np.asarray(starts), np.asarray(headings), np.asarray(counts),
                            max(1, int(outlier_share * n)))


def tracking_sample(geo: TrackingGeometry, seed: int) -> np.ndarray:
    g = sample_rng(seed, 1)
    out = []
    for start, heading, m in zip(geo.starts, geo.headings, geo.counts):
        ts = np.sort(g.uniform(0, 30.0, m))[:, None]
        out.append(start + ts * heading * 2.0 + g.normal(size=(m, len(start))) * 0.8)
    x = np.concatenate(out)
    n = len(x)
    idx = g.choice(n, geo.outliers, replace=False)
    x[idx] = g.uniform(x.min(), x.max(), size=(geo.outliers, x.shape[1]))
    return x.astype(np.float32)


def _apportion(m: int, weights: np.ndarray) -> np.ndarray:
    """``m`` rows over the classes in proportion to ``weights``: the floor of
    each share, the rest to the largest remainders (ties to the lower
    class).  The same for every seed, so every seed writes the same amount
    into each class."""
    share = m * weights / weights.sum()
    out = np.floor(share).astype(np.int64)
    rest = np.argsort(-(share - out), kind="stable")[: m - int(out.sum())]
    out[rest] += 1
    return out


def writes(geo: WardGeometry, batches: int, rows: int, g: np.random.Generator, *,
           drift: float = 0.0, start: int = 0) -> list[np.ndarray]:
    """``batches`` batches of ``rows`` fresh (rows, D) f32 readings of the
    fixed WARD geometry, by ``ward_sample``'s recipe: each class gets the
    same number of rows in every batch, in proportion to its size (the few
    background rows are not written); the seed draws the points and their
    order.  With ``drift`` > 0, batch ``t`` (counted from ``start``; nothing
    drifts before 0) has a share ``min(1, drift * t)`` of its rows on the
    corridor between the two nearest classes instead, as
    ``examples/iot_stream.py`` makes a stream drift: a uniform point of the
    middle half of the segment between their centres plus Gaussian noise of
    ``1 + 10 drift * t`` times their readings' mean scale, so the corridor
    both fills and widens as the stream goes on (at ``drift`` 0.025 it holds
    half a batch at 6 times the scale after 20 batches, where the example's
    noise has grown 6-fold too).  It is the widening that raises the
    indexes' overlap: a corridor as narrow as its classes stays inside the
    one index they share."""
    if not isinstance(geo, WardGeometry):
        raise ValueError("a stream writes fresh readings of the WARD geometry only")
    centers, scales = geo.centers, geo.scales.mean(1)
    d2 = ((centers[:, None] - centers[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    a, b = np.unravel_index(np.argmin(d2), d2.shape)
    out = []
    for t in range(start, start + batches):
        grown = max(0.0, drift * t)
        n_cor = int(round(rows * min(1.0, grown)))
        parts = [centers[c] + g.normal(size=(m, centers.shape[1])) * geo.scales[c]
                 for c, m in enumerate(_apportion(rows - n_cor, geo.counts)) if m]
        if n_cor:
            f = g.uniform(0.25, 0.75, size=(n_cor, 1))
            parts.append(centers[a] * (1 - f) + centers[b] * f
                         + g.normal(size=(n_cor, centers.shape[1]))
                         * (0.5 * (scales[a] + scales[b]) * (1.0 + 10.0 * grown)))
        batch = np.concatenate(parts)
        out.append(batch[g.permutation(rows)].astype(np.float32))
    return out


def geometry(spec: dict[str, Any]):
    """The fixed geometry of a configuration's ``dataset`` entry."""
    kind = spec["generator"]
    if kind == "ward":
        return ward_geometry(spec["n"], spec["dim"], spec["classes"], spec["geometry_seed"])
    if kind == "tracking":
        return tracking_geometry(spec["n"], spec["dim"], spec["tracks"],
                                 spec["outlier_share"], spec["geometry_seed"])
    raise ValueError(f"unknown dataset generator {kind!r}")


def make(spec: dict[str, Any]) -> np.ndarray:
    """(n, dim) f32 rows of a configuration's dataset."""
    geo = geometry(spec)
    if isinstance(geo, WardGeometry):
        return ward_sample(geo, spec["sample_seed"])
    return tracking_sample(geo, spec["sample_seed"])
