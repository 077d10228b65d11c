"""The port's streaming slice against the JAX package, on the CPU.

Same numpy inputs through ``repro`` and ``repro_torch`` (``device="cpu"``):

* ``append_routed`` / ``ingest_impl``: ``x``, ``ids``, ``count``,
  ``dropped`` and ``accepted`` equal, parked rows and capacity rejects
  included; ``radius`` and ``sum_x`` within 2 ulp;
* ``updated_geometry``, the drift monitor's rates and its triggers and
  reasons (equal; the data keeps every rate more than 1e-4 from a
  threshold).  Rates agree within 1e-6 + 1e-5 x rate,
  ``test_torch_build.py``'s overlap tolerance: the updated radii differ
  from the JAX package's by an ulp (the running max of a distance summed in
  another order), and VBM's volume ratio raises a radius to the D-th power.
  OBM also counts objects inside balls, where an object at a ball's
  boundary is in or out by rounding: it is held where no object is in band;
* ``rebuild_indexes`` / ``swap_trees``: ``ForestArrays`` equal field by
  field, ``build_stats`` and the rebuild log equal;
* search after ingest and after a swap: ids equal up to near ties, d^2
  within 8 ulp of the norms (``test_torch_search.py``'s rule);
* the no-loss ingest under overflow, and ``mode="all"`` over forest + delta
  against a brute force.

The data is ``blob_data`` (2,100 x 8) and batches drawn around it.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import (
    Config as JConfig,
    IndexConfig as JIndexConfig,
    OverlapIndex as JIndex,
    StreamConfig as JStreamConfig,
)
from repro.core.forest import swap_trees as j_swap_trees
from repro.core.knn import knn_exact as j_knn_exact
from repro.stream.ingest import (
    alloc_delta as j_alloc_delta,
    append_routed as j_append_routed,
    ingest_impl as j_ingest_impl,
    main_index_sums as j_main_index_sums,
    updated_geometry as j_updated_geometry,
)
from repro.stream.maintenance import (
    MaintenanceConfig as JMaintenanceConfig,
    OverlapMonitor as JOverlapMonitor,
    object_assignment as j_object_assignment,
)
from repro_torch.api import Config, ConfigError, IndexConfig, OverlapIndex, StreamConfig
from repro_torch.core.forest import FOREST_FIELDS, swap_trees
from repro_torch.core.knn import knn_exact
from repro_torch.data.synthetic import drifting_batches
from repro_torch.stream.ingest import (
    alloc_delta,
    append_routed,
    delta_view,
    ingest_impl,
    main_index_sums,
    pull_delta_meta,
    route_batch_host,
    updated_geometry,
)
from repro_torch.stream.maintenance import (
    MaintenanceConfig,
    OverlapMonitor,
    object_assignment,
    rebuild_indexes,
)

D2_RTOL = 8 * float(np.finfo(np.float32).eps)
EXACT = ("x", "ids", "count", "dropped")
STAT_KEYS = ("buckets_visited", "distances", "bound_distances",
             "padded_distances", "comparisons")
BUILD = dict(method="vbm", eps=1.5, min_pts=8, xi_min=0.1, xi_max=0.7)


def _pair(x, **stream):
    """(port index on the CPU, JAX index) over the same rows and config."""
    tx = OverlapIndex.build(
        x, Config(index=IndexConfig(**BUILD), stream=StreamConfig(**stream)), device="cpu")
    jx = JIndex.build(x, JConfig(index=JIndexConfig(**BUILD), stream=JStreamConfig(**stream)))
    return tx, jx


@pytest.fixture(scope="module")
def built(blob_data):
    """One port/JAX index pair with several indexes and overlap links."""
    tx, jx = _pair(blob_data, capacity=64)
    assert tx.n_indexes == jx.n_indexes > 2
    return tx, jx


def _stream_points(x, n, seed):
    g = np.random.default_rng(seed)
    base = x[g.choice(len(x), n)]
    return (base + 0.3 * g.normal(size=base.shape)).astype(np.float32)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _within_ulp(got, want, n_ulp):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin) and np.array_equal(got[~fin], want[~fin])
    ulp = np.spacing(np.abs(want[fin]))
    assert (np.abs(got[fin] - want[fin]) <= n_ulp * ulp).all(), np.abs(got - want).max()


def _assert_delta_equal(dt, dj):
    for name in EXACT:
        np.testing.assert_array_equal(getattr(dt, name).numpy(), np.asarray(getattr(dj, name)),
                                      err_msg=name)
    for name in ("radius", "sum_x"):
        _within_ulp(getattr(dt, name).numpy(), np.asarray(getattr(dj, name)), 2)
    for name in ("pivot", "main_count", "main_sum", "main_radius"):
        np.testing.assert_array_equal(getattr(dt, name).numpy(), np.asarray(getattr(dj, name)),
                                      err_msg=name)


def _d2_tol(q, x):
    return D2_RTOL * ((q.astype(np.float64) ** 2).sum(1)
                      + (x.astype(np.float64) ** 2).sum(1).max())[:, None]


def _assert_same_result(q, x, rt, rj):
    """ids equal except where a swapped pair of neighbours is a near tie;
    d^2 within 8 ulp of the norms; the integer cost counters equal."""
    tol = _d2_tol(q, x)
    d2t, d2j = rt.dists.astype(np.float64) ** 2, rj.dists.astype(np.float64) ** 2
    assert (np.abs(d2t - d2j) <= tol).all()
    for qi, j in zip(*np.nonzero(rt.ids != rj.ids)):
        row = rj.ids[qi]
        assert rt.ids[qi, j] in row, (qi, j)
        jr = int(np.nonzero(row == rt.ids[qi, j])[0][0])
        assert abs(d2j[qi, jr] - d2j[qi, j]) <= tol[qi, 0], (qi, j)
    for name in STAT_KEYS:
        np.testing.assert_array_equal(rt.stats[name], rj.stats[name], err_msg=name)
    assert rt.stats["steps"] == rj.stats["steps"]


# --- ingest ------------------------------------------------------------------


def test_main_index_sums_bitwise(built):
    tx, jx = built
    ct, st = main_index_sums(tx.forest)
    cj, sj = j_main_index_sums(jx.forest)
    np.testing.assert_array_equal(ct, cj)
    assert st.dtype == sj.dtype == np.float32
    np.testing.assert_array_equal(st, sj)


@pytest.mark.parametrize("case", ["fits", "overflow", "parked", "prefilled"])
def test_append_routed_matches_jax(built, case):
    """Random destinations straight into ``append_routed``: a batch that fits,
    one that overflows small buffers, one with parked rows (idx == I, valid
    False), and a second append onto partly filled buffers."""
    tx, jx = built
    n_idx = tx.n_indexes
    g = np.random.default_rng({"fits": 1, "overflow": 2, "parked": 3, "prefilled": 4}[case])
    cap = 4 if case == "overflow" else 48
    b = 80
    xb = (g.normal(size=(b, 8)) * 5).astype(np.float32)
    ids = np.arange(5000, 5000 + b, dtype=np.int32)
    idx = g.integers(0, n_idx, b).astype(np.int32)
    valid = np.ones(b, bool)
    if case == "parked":
        valid = g.random(b) < 0.6
        idx = np.where(valid, idx, n_idx).astype(np.int32)
    dt = alloc_delta(tx.forest, cap, device="cpu")
    dj = j_alloc_delta(jx.forest, cap)
    if case == "prefilled":
        first = (g.normal(size=(30, 8)) * 5).astype(np.float32)
        fidx = g.integers(0, n_idx, 30).astype(np.int32)
        fids = np.arange(100, 130, dtype=np.int32)
        dt, _ = append_routed(dt, _t(first), _t(fids), _t(fidx), _t(np.ones(30, bool)))
        dj, _ = j_append_routed(dj, jnp.asarray(first), jnp.asarray(fids), jnp.asarray(fidx),
                                jnp.ones(30, bool))
    nt, at = append_routed(dt, _t(xb), _t(ids), _t(idx), _t(valid))
    nj, aj = j_append_routed(dj, jnp.asarray(xb), jnp.asarray(ids), jnp.asarray(idx),
                             jnp.asarray(valid))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    _assert_delta_equal(nt, nj)
    acc = at.numpy()
    if case == "overflow":
        assert (~acc).sum() > 0 and nt.dropped.sum() == (~acc).sum()
    if case == "parked":
        # a parked row counts nowhere, not even in dropped
        assert int(nt.count.sum()) == acc.sum() and int(nt.dropped.sum()) == 0
        assert not acc[~valid].any()


def test_ingest_is_functional(built):
    """An ingest returns new buffers and leaves its input as it was, so a
    probe ingest can be thrown away."""
    tx, _ = built
    d0 = alloc_delta(tx.forest, 8, device="cpu")
    before = [t.clone() for t in d0]
    xb = _stream_points(tx.x_all, 40, seed=5)
    d1, acc = ingest_impl(_t(tx.forest.index_centers), d0, _t(xb),
                          _t(np.arange(40, dtype=np.int32)))
    for name, a, b in zip(d0._fields, d0, before):
        assert torch.equal(a, b), name
    assert int(d1.count.sum()) == int(acc.sum()) > 0


@pytest.mark.parametrize("valid_frac", [1.0, 0.5])
def test_ingest_impl_matches_jax(built, valid_frac):
    """Routing by the index centers, two chained batches into buffers small
    enough to reject some rows, with and without a ``valid`` mask."""
    tx, jx = built
    g = np.random.default_rng(int(valid_frac * 10))
    ct = _t(tx.forest.index_centers)
    cj = jnp.asarray(jx.forest.index_centers)
    dt = alloc_delta(tx.forest, 24, device="cpu")
    dj = j_alloc_delta(jx.forest, 24)
    for r in range(2):
        xb = _stream_points(tx.x_all, 96, seed=20 + r)
        ids = np.arange(3000 + 96 * r, 3096 + 96 * r, dtype=np.int32)
        valid = None if valid_frac == 1.0 else g.random(96) < valid_frac
        dt, at = ingest_impl(ct, dt, _t(xb), _t(ids), None if valid is None else _t(valid))
        dj, aj = j_ingest_impl(cj, dj, jnp.asarray(xb), jnp.asarray(ids),
                               None if valid is None else jnp.asarray(valid))
        np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
        _assert_delta_equal(dt, dj)
    assert int(dt.dropped.sum()) > 0
    # routing alone, as the host helper gives it
    xb = _stream_points(tx.x_all, 50, seed=30)
    want = ((xb[:, None, :] - tx.forest.index_centers[None]) ** 2).sum(-1).argmin(1)
    np.testing.assert_array_equal(route_batch_host(tx.device, xb), want)


def test_updated_geometry_matches_jax(built):
    tx, jx = built
    xb = _stream_points(tx.x_all, 120, seed=40)
    ids = np.arange(4000, 4120, dtype=np.int32)
    dt, _ = ingest_impl(_t(tx.forest.index_centers), alloc_delta(tx.forest, 64, device="cpu"),
                        _t(xb), _t(ids))
    dj, _ = j_ingest_impl(jnp.asarray(jx.forest.index_centers), j_alloc_delta(jx.forest, 64),
                          jnp.asarray(xb), jnp.asarray(ids))
    ct, rt = updated_geometry(dt)
    cj, rj = j_updated_geometry(dj)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-6, atol=1e-6)
    meta = pull_delta_meta(dt, ids=True)
    assert set(meta) == {"count", "radius", "sum_x", "main_count", "main_sum",
                         "main_radius", "dropped", "ids"}


# --- facade: ingest, monitor, rebuild, search -------------------------------


def _in_band(x, centers, radii):
    """Objects whose ball membership rounding decides: the exact squared
    distance within 8 ulp of ||x||^2 + ||p||^2 of the squared radius (an
    index's farthest member lies at exactly its radius)."""
    xd, cd = x.astype(np.float64), centers.astype(np.float64)
    d2 = ((xd[:, None, :] - cd[None]) ** 2).sum(-1)
    band = 8 * 2.0 ** -23 * ((xd ** 2).sum(1)[:, None] + (cd ** 2).sum(1)[None])
    return int((np.abs(d2 - radii.astype(np.float64)[None] ** 2) <= band).sum())


def _assert_rates(got, want, xi):
    """Rates within 1e-6 + 1e-5 x rate, and every index's worst rate more
    than 1e-4 from ``xi``, so the triggers cannot flip."""
    assert (np.abs(got - want) <= 1e-6 + 1e-5 * np.abs(want)).all(), np.abs(got - want).max()
    worst = np.where(np.eye(len(want), dtype=bool), -1.0, want).max(1)
    assert (np.abs(worst - xi) > 1e-4).all(), "a rate lies too near the threshold"


def _assert_reports(rt, rj, xi):
    _assert_rates(rt.rates_baseline, rj.rates_baseline, xi)
    _assert_rates(rt.rates, rj.rates, xi)
    np.testing.assert_allclose(rt.centers, rj.centers, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(rt.radii, rj.radii, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(rt.fill, rj.fill)
    np.testing.assert_array_equal(rt.dropped, rj.dropped)
    assert rt.triggers == rj.triggers and rt.reasons == rj.reasons


@pytest.mark.parametrize("method", ["dbm", "vbm", "obm"])
def test_monitor_matches_jax(blob_data, method):
    """The facade's ``check()`` on the build-time and the updated geometry:
    rates within the tolerance, triggers and reasons equal, indexes firing.

    OBM counts the objects inside each ball, and each index's farthest
    member lies at exactly its radius, in or out by the rounding of its
    distance (the in-band rule).  So OBM is held on a forest (and delta
    ``main_radius``) whose radii are raised by 1e-4 of themselves, in both
    packages alike, after checking
    that no object is in band there (on the facade's own forest the two
    packages may fire differently on an index whose farthest member is in
    band)."""
    xi = 0.35
    stream = dict(capacity=96, monitor_method=method, xi_rebuild=xi, fill_rebuild=0.4)
    tx, jx = _pair(blob_data, **stream)
    for seed in (50, 51):
        xb = _stream_points(blob_data, 150, seed=seed)
        np.testing.assert_array_equal(tx.ingest(xb), jx.ingest(xb))
        rt, rj = tx.check(), jx.check()
        assert rt.rates.shape == (tx.n_indexes,) * 2 and np.isfinite(rt.rates).all()
        if method != "obm":
            _assert_reports(rt, rj, xi)
            continue
        radii = tx.forest.index_radii * np.float32(1 + 1e-4)
        ft = dataclasses.replace(tx.forest, index_radii=radii)
        fj = dataclasses.replace(jx.forest, index_radii=radii)
        assert _in_band(tx.x_all, ft.index_centers, radii) == 0
        mt = OverlapMonitor(ft, tx._maint_cfg(), x=tx.x_all, device="cpu")
        mj = JOverlapMonitor(fj, jx._maint_cfg(), x=jx.x_all)
        dt = tx.delta._replace(main_radius=torch.from_numpy(radii))
        dj = jx.delta._replace(main_radius=jnp.asarray(radii))
        rt, rj = mt.check(dt, x=tx.x_all), mj.check(dj, x=jx.x_all)
        assert _in_band(jx.x_all, rj.centers, rj.radii) == 0
        _assert_reports(rt, rj, xi)
    assert rt.triggers


def test_object_assignment_matches_jax(built):
    tx, jx = built
    dt = alloc_delta(tx.forest, 32, device="cpu")
    xb = _stream_points(tx.x_all, 60, seed=60)
    n = len(tx.x_all)
    dt, _ = ingest_impl(_t(tx.forest.index_centers), dt, _t(xb),
                        _t(np.arange(n, n + 60, dtype=np.int32)))
    host = pull_delta_meta(dt, ids=True)
    got = object_assignment(tx.forest, host, n + 70)  # 10 ids in no index
    want = j_object_assignment(jx.forest, host, n + 70)
    np.testing.assert_array_equal(got, want)
    assert (got[-10:] == -1).all()


def test_overlap_trigger_fires_at_xi():
    """The threshold is sharp: xi just below the worst rate fires, just above
    does not, and the JAX package's monitor agrees."""
    g = np.random.default_rng(5)
    dim = 6
    c2 = np.zeros(dim)
    c2[0] = 18.0
    x0 = np.concatenate([g.normal(size=(300, dim)), c2 + g.normal(size=(300, dim))]
                        ).astype(np.float32)
    stream = dict(capacity=512, monitor_method="dbm", xi_rebuild=0.99, fill_rebuild=0.99)
    tx = OverlapIndex.build(x0, Config(index=IndexConfig(method="vbm", eps=1.5, min_pts=8),
                                       stream=StreamConfig(**stream)), device="cpu")
    jx = JIndex.build(x0, JConfig(index=JIndexConfig(method="vbm", eps=1.5, min_pts=8),
                                  stream=JStreamConfig(**stream)))
    assert tx.n_indexes == 2
    mid = np.zeros(dim)
    mid[0] = 9.0
    xb = (mid + g.normal(size=(150, dim)) * [4, 1, 1, 1, 1, 1]).astype(np.float32)
    tx.ingest(xb)
    jx.ingest(xb)
    worst = float(np.max(tx.check().rates))
    assert worst > 0.05
    for xi, fires in ((worst - 0.02, True), (worst + 0.02, False)):
        rt = OverlapMonitor(tx.forest, MaintenanceConfig(method="dbm", xi_rebuild=xi,
                                                         fill_rebuild=0.99),
                            device="cpu").check(tx.delta)
        rj = JOverlapMonitor(jx.forest, JMaintenanceConfig(method="dbm", xi_rebuild=xi,
                                                           fill_rebuild=0.99)).check(jx.delta)
        assert any("overlap" in v for v in rt.reasons.values()) == fires
        assert rt.reasons == rj.reasons


def test_rebuild_swap_matches_jax(blob_data):
    """Ingest + maintain with a low fill threshold: the rebuilt forests equal
    field by field after every round, with the same rebuild log, stats and
    delta buffers, and searches agree after the last swap."""
    stream = dict(capacity=128, monitor_method="dbm", xi_rebuild=0.95, fill_rebuild=0.2)
    tx, jx = _pair(blob_data, **stream)
    stats0 = dict(tx.forest.build_stats)
    for step in range(4):
        xb = _stream_points(blob_data, 120, seed=10 + step)
        tx.ingest(xb)
        jx.ingest(xb)
        rt, rj = tx.maintain(), jx.maintain()
        assert rt.triggers == rj.triggers and rt.reasons == rj.reasons
        for name in FOREST_FIELDS:
            a, b = getattr(tx.forest, name), getattr(jx.forest, name)
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        assert tx.forest.c_max == jx.forest.c_max
        assert tx.forest.build_stats == jx.forest.build_stats
        _assert_delta_equal(tx.delta, jx.delta)
    assert tx.forest.build_stats["rebuilds"] > 0
    assert tx.forest.build_stats["tree_distances"] > stats0["tree_distances"]
    assert len(tx.rebuild_log) == len(jx.rebuild_log)
    for a, b in zip(tx.rebuild_log, jx.rebuild_log):
        for key in ("n_rebuilt", "n_absorbed", "rebuild_distances", "triggers", "reasons",
                    "n_migrated"):
            assert a[key] == b[key], key
    s = tx.structure()
    assert s == jx.structure()
    assert s["total_leaves"] == tx.forest.n_buckets
    assert s["n_objects"] == tx.n_total == len(blob_data) + 4 * 120
    q = _stream_points(blob_data, 40, seed=70)
    for mode in ("forest", "all"):
        for beam in (1, 3):
            _assert_same_result(q, tx.x_all, tx.search(q, k=10, mode=mode, beam=beam),
                                jx.search(q, k=10, mode=mode, beam=beam))


def test_swap_trees_matches_jax(built, blob_data):
    """``swap_trees`` alone, on the trees of a forest built over a second
    sample: the re-flattened arrays, geometry and accumulated stats equal."""
    tx, jx = built
    n_idx = tx.n_indexes
    rebuilt_t = OverlapIndex.baseline(blob_data[::2], device="cpu").forest.trees[0]
    rebuilt_j = JIndex.baseline(blob_data[::2]).forest.trees[0]
    centers = tx.forest.index_centers + 0.5
    radii = tx.forest.index_radii + 1.0
    st = swap_trees(tx.forest, blob_data, {n_idx - 1: rebuilt_t},
                    index_centers=centers, index_radii=radii)
    sj = j_swap_trees(jx.forest, blob_data, {n_idx - 1: rebuilt_j},
                      index_centers=centers, index_radii=radii)
    for name in FOREST_FIELDS:
        np.testing.assert_array_equal(getattr(st, name), getattr(sj, name), err_msg=name)
    assert st.build_stats == sj.build_stats and st.build_stats["rebuilds"] == 1
    with pytest.raises(ValueError, match="unknown index"):
        swap_trees(tx.forest, blob_data, {n_idx: rebuilt_t})


def test_rebuild_indexes_matches_jax(built):
    tx, jx = built
    xb = _stream_points(tx.x_all, 90, seed=80)
    n = len(tx.x_all)
    ids = np.arange(n, n + 90, dtype=np.int32)
    dt, _ = ingest_impl(_t(tx.forest.index_centers), alloc_delta(tx.forest, 64, device="cpu"),
                        _t(xb), _t(ids))
    dj, _ = j_ingest_impl(jnp.asarray(jx.forest.index_centers), j_alloc_delta(jx.forest, 64),
                          jnp.asarray(xb), jnp.asarray(ids))
    x_all = np.concatenate([tx.x_all, xb])
    from repro.stream.maintenance import rebuild_indexes as j_rebuild_indexes

    ft, st = rebuild_indexes(tx.forest, dt, x_all, [0, 2], MaintenanceConfig())
    fj, sj = j_rebuild_indexes(jx.forest, dj, x_all, [0, 2], JMaintenanceConfig())
    for name in FOREST_FIELDS:
        np.testing.assert_array_equal(getattr(ft, name), getattr(fj, name), err_msg=name)
    for key in ("n_rebuilt", "n_absorbed", "rebuild_distances"):
        assert st[key] == sj[key], key


def test_search_with_live_delta_matches_jax(blob_data):
    """After ingest (no rebuild yet) the port's search over forest + delta
    gives the JAX package's, in forest and all mode, beam 1 and 4."""
    tx, jx = _pair(blob_data, capacity=256, fill_rebuild=1.0, xi_rebuild=1.0)
    xb = _stream_points(blob_data, 300, seed=90)
    tx.ingest(xb)
    jx.ingest(xb)
    assert sum(tx.structure()["delta_fill"]) == 300
    assert tx.plans.stats()["misses"] == 0
    q = _stream_points(tx.x_all, 48, seed=91)
    for mode in ("forest", "all"):
        for beam in (1, 4):
            rt = tx.search(q, k=10, mode=mode, beam=beam)
            assert rt.plan.key.delta_capacity == 256
            _assert_same_result(q, tx.x_all, rt, jx.search(q, k=10, mode=mode, beam=beam))


def test_forest_plus_delta_matches_brute_force(built, rng):
    tx, _ = built
    x = tx.x_all
    delta = alloc_delta(tx.forest, 256, device="cpu")
    xs = _stream_points(x, 300, seed=2)
    delta, acc = ingest_impl(_t(tx.forest.index_centers), delta, _t(xs),
                             _t(np.arange(len(x), len(x) + 300, dtype=np.int32)))
    assert bool(acc.all())
    from repro_torch.core.knn import knn_search_impl

    x_all = np.concatenate([x, xs])
    q = (rng.normal(size=(24, x.shape[1])) * 8).astype(np.float32)
    d, ids, _ = knn_search_impl(tx.device, _t(q), k=12, mode="all", delta=delta_view(delta))
    de, ie = knn_exact(_t(x_all), _t(q), k=12)
    tol = _d2_tol(q, x_all)
    assert (np.abs(d.numpy().astype(np.float64) ** 2 - de.numpy().astype(np.float64) ** 2)
            <= tol).all()
    dj, _ = j_knn_exact(jnp.asarray(x_all), jnp.asarray(q), k=12)
    np.testing.assert_allclose(d.numpy(), np.asarray(dj), rtol=1e-4, atol=1e-4)
    # streamed points are findable: each is its own nearest neighbour
    _, ids1, _ = knn_search_impl(tx.device, _t(xs[:8]), k=1, mode="all",
                                 delta=delta_view(delta))
    np.testing.assert_array_equal(ids1.numpy()[:, 0], np.arange(8) + len(x))


def test_empty_delta_is_noop(built, rng):
    tx, _ = built
    from repro_torch.core.knn import knn_search_impl

    q = _t((rng.normal(size=(8, 8)) * 8).astype(np.float32))
    d0, i0, _ = knn_search_impl(tx.device, q, k=7, mode="all")
    d1, i1, _ = knn_search_impl(tx.device, q, k=7, mode="all",
                                delta=delta_view(alloc_delta(tx.forest, 32, device="cpu")))
    assert torch.equal(d0, d1) and torch.equal(i0, i1)


def test_ingest_never_loses_points_under_overflow(blob_data):
    """Capacity 16 and 400 points: forced rebuilds on rejects keep every
    point; each streamed point is its own nearest neighbour, and the JAX
    package takes the same rebuilds."""
    stream = dict(capacity=16, monitor_method="dbm", xi_rebuild=0.95, fill_rebuild=0.95)
    tx, jx = _pair(blob_data, **stream)
    xs = _stream_points(blob_data, 400, seed=21)
    ids = tx.ingest(xs)
    np.testing.assert_array_equal(ids, jx.ingest(xs))
    got = tx.search(xs[:32], k=1, mode="all")
    np.testing.assert_array_equal(got.ids[:, 0], ids[:32])
    assert tx.forest.build_stats["rebuilds"] > 0
    assert tx.forest.build_stats == jx.forest.build_stats
    assert [r["triggers"] for r in tx.rebuild_log] == [r["triggers"] for r in jx.rebuild_log]
    _assert_delta_equal(tx.delta, jx.delta)
    # every point is stored exactly once, in a bucket or a delta buffer
    stored = np.concatenate([tx.forest.bucket_ids[tx.forest.bucket_mask],
                             tx.delta.ids.numpy()[delta_view(tx.delta).mask.numpy()]])
    np.testing.assert_array_equal(np.sort(stored), np.arange(tx.n_total))


def test_ingest_pads_to_powers_of_two(blob_data):
    """Ragged batches pad up to a power of two (clamped to the capacity):
    ``traces`` counts the distinct padded lengths (the JAX package's ingest
    traces one program per length), ``calls`` every round."""
    tx = OverlapIndex.build(blob_data, Config(index=IndexConfig(**BUILD),
                                              stream=StreamConfig(capacity=100)), device="cpu")
    assert tx.ingest_stats() == dict(traces=0, calls=0)
    assert [tx._pad_batch(n) for n in (1, 3, 64, 65, 100)] == [1, 4, 64, 100, 100]
    tx.ingest(_stream_points(blob_data, 64, seed=0))
    tx.ingest(_stream_points(blob_data, 40, seed=1))  # pads to 64
    assert tx.ingest_stats() == dict(traces=1, calls=2)
    tx.ingest(_stream_points(blob_data, 17, seed=2))  # pads to 32: a new shape
    assert tx.ingest_stats() == dict(traces=2, calls=3)
    with pytest.raises(ConfigError, match="ingest batch"):
        tx.ingest(np.zeros((3, 5), np.float32))


def test_capacity_comes_from_config(blob_data):
    tx = OverlapIndex.build(blob_data, Config(index=IndexConfig(**BUILD)), device="cpu")
    assert tx.capacity == 64  # sqrt(2100) -> 45, floor 64
    assert tx.delta is None and tx.structure()["delta_fill"] == [0] * tx.n_indexes
    ty = OverlapIndex.build(blob_data, Config(index=IndexConfig(**BUILD),
                                              stream=StreamConfig(capacity=7)), device="cpu")
    ty.check()  # allocates the empty buffers
    assert ty.capacity == 7 and ty.delta.x.shape == (ty.n_indexes, 7, 8)
    assert "delta=on" in repr(ty)


BAD_STREAM = [
    (dict(capacity=0), "capacity"),
    (dict(monitor_method="nope"), "registered overlap method"),
    (dict(xi_rebuild=0.0), "xi_rebuild"),
    (dict(drift_margin=0.0), "drift_margin"),
    (dict(fill_rebuild=1.5), "fill_rebuild"),
    (dict(wasted_rebuild=0.0), "wasted_rebuild"),
    (dict(pivot_method="median"), "pivot_method"),
    (dict(c_max=1), "c_max"),
]


@pytest.mark.parametrize("kwargs, fragment", BAD_STREAM)
def test_stream_config_messages_match(kwargs, fragment):
    with pytest.raises(ConfigError, match=fragment) as got:
        StreamConfig(**kwargs)
    with pytest.raises(ValueError) as want:
        JStreamConfig(**kwargs)
    assert str(got.value) == str(want.value).replace("repro.api.", "repro_torch.api.")


def test_config_stream_node_is_type_checked():
    with pytest.raises(ConfigError, match="Config.stream"):
        Config(stream=IndexConfig())


def test_drifting_batches_match_the_benchmark_recipe():
    from benchmarks.bench_stream import _drifting_batches

    got = drifting_batches(2_500, 1_024, 12, seed=11)
    want = _drifting_batches(2_500, 1_024, 12, seed=11)
    assert [len(b) for b in got] == [1024, 1024, 452]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_stream_points_drive_a_drifting_workload():
    """bench_stream's lifecycle at a small size: VBM build, a DBM monitor,
    ``maintain()`` after every batch; ``mode="all"`` stays exact against a
    brute force over every object ingested so far, across the rebuilds."""
    x0 = np.concatenate(drifting_batches(1_500, 1_500, 8, seed=3))
    tx = OverlapIndex.build(x0, Config(
        index=IndexConfig(method="vbm", eps=2.5, min_pts=8),
        stream=StreamConfig(capacity=256, monitor_method="dbm", xi_rebuild=0.6,
                            fill_rebuild=0.7)), device="cpu")
    q = _stream_points(x0, 32, seed=7)
    for xb in drifting_batches(1_500, 256, 8, seed=11):
        tx.ingest(xb)
        tx.maintain()
    assert len(tx.rebuild_log) > 0
    res = tx.search(q, k=10, mode="all")
    de, _ = knn_exact(_t(tx.x_all), _t(q), k=10)
    tol = _d2_tol(q, tx.x_all)
    assert (np.abs(res.dists.astype(np.float64) ** 2 - de.numpy().astype(np.float64) ** 2)
            <= tol).all()
