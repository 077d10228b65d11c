"""The port's persistence and single-pair metrics against the JAX package, on
the CPU.

* ``save`` / ``load`` within the port: searches after the load bitwise equal
  to those before the save (f32 and int8 buckets, beam 1 and 4, ``forest``
  and ``all``, with a delta after ``ingest`` and a rebuild in the log); one
  more ingest + ``maintain()`` on the original and the loaded index gives
  equal deltas, triggers and rebuild log entries;
* across packages, both ways, in the JAX package's npz format: the arrays a
  loader restores are bit-equal to the file, and the reader's searches equal
  the writer's (ids exact on rows rounded to a 1/8 grid, where every
  distance the scan compares is exact; d^2 within 8 ulp of the norms, the
  standing tolerance, since the bounds' pivots are off the grid); a JAX
  snapshot with a ``sharded`` or ``routed`` layout section loads
  single-device;
* ``sq_l2`` / ``l2`` / ``l1`` / ``cosine``, ``distances_to_point`` and
  ``check_metric_axioms`` against ``repro.core.metric``.

The JAX side runs through its CPU dispatch (no Pallas interpret mode).
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro.api import (
    Config as JConfig,
    IndexConfig as JIndexConfig,
    LayoutConfig as JLayoutConfig,
    OverlapIndex as JIndex,
    StreamConfig as JStreamConfig,
)
from repro.core import metric as j_metric
from repro_torch.api import Config, IndexConfig, OverlapIndex, SearchConfig, StreamConfig
from repro_torch.api import persist
from repro_torch.core import metric
from repro_torch.core.forest import FOREST_FIELDS

D2_RTOL = 8 * float(np.finfo(np.float32).eps)
STAT_KEYS = ("buckets_visited", "distances", "bound_distances",
             "padded_distances", "comparisons", "steps")
BUILD = dict(method="vbm", eps=1.5, min_pts=8, xi_min=0.1, xi_max=0.7)
DELTA_FIELDS = ("x", "ids", "count", "pivot", "radius", "sum_x",
                "main_count", "main_sum", "main_radius", "dropped")
SEARCHES = [(beam, mode) for beam in (1, 4) for mode in ("forest", "all")]


def _points(x, n, seed, *, grid=False):
    g = np.random.default_rng(seed)
    p = x[g.choice(len(x), n)] + 0.3 * g.normal(size=(n, x.shape[1]))
    return (np.round(p * 8) / 8 if grid else p).astype(np.float32)


def _assert_bitwise(a, b):
    np.testing.assert_array_equal(a.dists, b.dists)
    np.testing.assert_array_equal(a.ids, b.ids)
    for name in STAT_KEYS:
        np.testing.assert_array_equal(a.stats[name], b.stats[name], err_msg=name)


def _assert_across(q, x, got, want):
    """Ids exact (grid rows), d^2 within 8 ulp of the norms, counters equal."""
    np.testing.assert_array_equal(got.ids, want.ids)
    tol = D2_RTOL * ((q.astype(np.float64) ** 2).sum(1)
                     + (x.astype(np.float64) ** 2).sum(1).max())[:, None]
    d2g, d2w = got.dists.astype(np.float64) ** 2, want.dists.astype(np.float64) ** 2
    assert (np.abs(d2g - d2w) <= tol).all(), np.abs(d2g - d2w).max()
    for name in STAT_KEYS:
        np.testing.assert_array_equal(got.stats[name], want.stats[name], err_msg=name)


def _strip_wall(log):
    return [{k: v for k, v in r.items() if k != "wall_time_s"} for r in log]


# --- within the port ---------------------------------------------------------


@pytest.mark.parametrize("quantize", [False, True])
def test_port_save_load_bitwise(blob_data, tmp_path, quantize):
    cfg = Config(index=IndexConfig(**BUILD), search=SearchConfig(quantize=quantize),
                 stream=StreamConfig(capacity=64, fill_rebuild=0.5))
    ix = OverlapIndex.build(blob_data, cfg, device="cpu")
    ix.ingest(_points(blob_data, 160, seed=1))
    assert ix.maintain().triggers, "the first batch should fill some buffer past 0.5"
    ix.ingest(_points(blob_data, 40, seed=2))
    assert sum(ix.structure()["delta_fill"]) > 0 and ix.rebuild_log
    q = _points(blob_data, 32, seed=3)
    before = {s: ix.search(q, k=7, beam=s[0], mode=s[1]) for s in SEARCHES}
    # report dicts may hold numpy scalars and tensors: they go out as JSON
    ix.rebuild_log[0]["probe"] = [np.int64(3), torch.tensor([2.5])]
    ix.forest.build_stats["probe"] = np.float32(1.5)

    path = ix.save(tmp_path / "ix")
    assert path.endswith(".npz")
    lx = OverlapIndex.load(path, device="cpu")
    assert lx.cfg == ix.cfg and lx.n_total == ix.n_total and lx.capacity == ix.capacity
    for name in FOREST_FIELDS:
        np.testing.assert_array_equal(getattr(lx.forest, name), getattr(ix.forest, name))
    assert lx.structure() == ix.structure()
    assert lx.rebuild_log[0]["probe"] == [3, [2.5]] and lx.forest.build_stats["probe"] == 1.5
    np.testing.assert_array_equal(lx.monitor.rates_baseline, ix.monitor.rates_baseline)
    for s in SEARCHES:
        _assert_bitwise(lx.search(q, k=7, beam=s[0], mode=s[1]), before[s])

    # the restarted index streams on exactly as the original does
    batch = _points(blob_data, 150, seed=4)
    n_log = len(ix.rebuild_log)
    for x in (ix, lx):
        x.ingest(batch)
    ro, rl = ix.maintain(), lx.maintain()
    assert ro.triggers and ro.triggers == rl.triggers and ro.reasons == rl.reasons
    for name in DELTA_FIELDS:
        assert torch.equal(getattr(lx.delta, name), getattr(ix.delta, name)), name
    assert _strip_wall(lx.rebuild_log[n_log:]) == _strip_wall(ix.rebuild_log[n_log:])
    for s in SEARCHES[:2]:
        _assert_bitwise(lx.search(q, k=7, beam=s[0], mode=s[1]),
                        ix.search(q, k=7, beam=s[0], mode=s[1]))


def test_load_refuses_newer_format(blob_data, tmp_path):
    ix = OverlapIndex.baseline(blob_data[:300], device="cpu")
    with np.load(ix.save(tmp_path / "ok")) as z:
        payload = dict(z)
    payload["format_version"] = np.int64(persist.FORMAT_VERSION + 1)
    np.savez_compressed(tmp_path / "new.npz", **payload)
    with pytest.raises(ValueError, match="newer format"):
        OverlapIndex.load(tmp_path / "new.npz", device="cpu")


def test_load_without_device_refuses_cpu(blob_data, tmp_path, monkeypatch):
    path = OverlapIndex.baseline(blob_data[:300], device="cpu").save(tmp_path / "b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OverlapIndex.load(path)
    assert OverlapIndex.load(path, device="cpu").backend.device.type == "cpu"


# --- across packages -----------------------------------------------------------


@pytest.fixture(scope="module")
def grid_blob(blob_data):
    return (np.round(blob_data * 8) / 8).astype(np.float32)


@pytest.fixture(scope="module")
def jax_snapshot(grid_blob, tmp_path_factory):
    """A JAX-built forest with a delta after ingest, saved."""
    jx = JIndex.build(grid_blob, JConfig(index=JIndexConfig(**BUILD),
                                         stream=JStreamConfig(capacity=64)))
    jx.ingest(_points(grid_blob, 120, seed=5, grid=True))
    assert jx.n_indexes > 2 and int(np.asarray(jx.delta.count).sum()) > 0
    return jx, jx.save(tmp_path_factory.mktemp("jax") / "jx")


def test_jax_snapshot_loads_in_port(grid_blob, jax_snapshot):
    jx, path = jax_snapshot
    tx = OverlapIndex.load(path, device="cpu")
    with np.load(path) as z:
        for name in FOREST_FIELDS:
            got = getattr(tx.forest, name)
            # bucket_x is not stored: the loader rebuilds it from x_all
            want = (np.asarray(jx.forest.bucket_x) if name == "bucket_x"
                    else z[f"forest_{name}"])
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=name)
        for name in DELTA_FIELDS:
            got = getattr(tx.delta, name).numpy()
            assert got.dtype == z[f"delta_{name}"].dtype, name
            np.testing.assert_array_equal(got, z[f"delta_{name}"], err_msg=name)
        np.testing.assert_array_equal(tx.monitor.rates_baseline, z["monitor_baseline"])
    assert tx.structure() == jx.structure()
    assert tx.rebuild_log == jx.rebuild_log and tx.x_all.shape == jx.x_all.shape
    q = _points(grid_blob, 40, seed=6, grid=True)
    for beam, mode in SEARCHES:
        _assert_across(q, tx.x_all, tx.search(q, k=8, beam=beam, mode=mode),
                       jx.search(q, k=8, beam=beam, mode=mode))


def test_port_snapshot_loads_in_jax(grid_blob, tmp_path):
    tx = OverlapIndex.build(grid_blob, Config(index=IndexConfig(**BUILD),
                                              stream=StreamConfig(capacity=64)), device="cpu")
    tx.ingest(_points(grid_blob, 120, seed=7, grid=True))
    jx = JIndex.load(tx.save(tmp_path / "tx"))
    for node in ("index", "search", "stream"):
        want = dataclasses.asdict(getattr(tx.cfg, node))
        assert dataclasses.asdict(getattr(jx.cfg, node)) == want, node
    for name in FOREST_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jx.forest, name)),
                                      getattr(tx.forest, name), err_msg=name)
    for name in DELTA_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jx.delta, name)),
                                      getattr(tx.delta, name).numpy(), err_msg=name)
    assert jx.build_report.n_indexes == tx.build_report.n_indexes
    q = _points(grid_blob, 40, seed=8, grid=True)
    for beam, mode in SEARCHES:
        _assert_across(q, tx.x_all, jx.search(q, k=8, beam=beam, mode=mode),
                       tx.search(q, k=8, beam=beam, mode=mode))


@pytest.mark.parametrize("kind", ["sharded", "routed"])
def test_jax_layout_snapshot_loads_single_device(grid_blob, jax_snapshot, tmp_path, kind):
    """Snapshots hold the logical state: a 4-shard layout section loads."""
    jx, _ = jax_snapshot
    laid = dataclasses.replace(jx.cfg, layout=JLayoutConfig(kind=kind, shards=4))
    src = copy.copy(jx)  # the same state, saved under the layout
    src.cfg = laid
    path = src.save(tmp_path / kind)
    tx = OverlapIndex.load(path, device="cpu")
    assert tx.backend.kind == "single"
    q = _points(grid_blob, 24, seed=9, grid=True)
    _assert_across(q, tx.x_all, tx.search(q, k=8, beam=4), jx.search(q, k=8, beam=4))


# --- single-pair metric primitives --------------------------------------------


@pytest.mark.parametrize("name", sorted(j_metric.METRICS))
def test_metric_primitives_match_jax(name):
    g = np.random.default_rng(11)
    pts = (g.normal(size=(12, 6)) * 3).astype(np.float32)
    tp = torch.from_numpy(pts)
    got = np.array([[float(metric.METRICS[name](tp[i], tp[j])) for j in range(12)]
                    for i in range(12)])
    want = np.array([[float(j_metric.METRICS[name](pts[i], pts[j])) for j in range(12)]
                     for i in range(12)])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert metric.check_metric_axioms(metric.METRICS[name], tp) == \
        j_metric.check_metric_axioms(j_metric.METRICS[name], pts)
    np.testing.assert_allclose(
        metric.distances_to_point(tp, tp[0], metric=name).numpy(),
        np.asarray(j_metric.distances_to_point(pts, pts[0], metric=name)), rtol=1e-5, atol=1e-5)
