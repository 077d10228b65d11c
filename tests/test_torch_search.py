"""The port's slice end to end against the JAX package, on the CPU.

Same numpy inputs through ``repro`` and ``repro_torch``:

* the BCCF baseline build gives bitwise-equal ``ForestArrays`` fields;
* ``OverlapIndex.baseline(x).search`` gives the same ids, distances and
  integer ``SearchStats`` for beam 1/4/7, f32 and int8 buckets;
* ``mode='all'`` equals the brute-force ``knn_exact``;
* a forest the JAX package built with the paper's overlap pipeline (several
  indexes with overlap-neighbour links), carried across as numpy arrays,
  searches the same through the port's executor, before and after a JAX
  ``ingest`` filled the delta buffers.

Tolerance on distances: the search computes squared distances by the
expansion ||q||^2 + ||x||^2 - 2 q.x in f32, and the two packages sum the
three terms in different orders.  Near a neighbour (d^2 ~ 1) of a point with
||x||^2 ~ 10^3 (``blob_data``'s clusters sit ~30 from the origin), the f32
rounding of those sums is a few ulp of ||q||^2 + ||x||^2, i.e. up to ~1e-4
in d^2, far above 1e-5.  So d^2 is held to ``D2_RTOL * (||q||^2 + max
||x||^2)`` per query (8 ulp of the norms), and a pair of neighbours whose
d^2 differ by less than that may come back in either order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import (
    Config as JConfig,
    IndexConfig as JIndexConfig,
    OverlapIndex as JIndex,
    SearchConfig as JSearchConfig,
    StreamConfig as JStreamConfig,
)
from repro.core.knn import (
    DeltaView as JDeltaView,
    bucket_bounds as j_bucket_bounds,
    delta_bounds as j_delta_bounds,
    device_forest as j_device_forest,
    knn_exact as j_knn_exact,
    knn_search_impl as j_impl,
    scan_sorted as j_scan_sorted,
)
from repro.core.pipeline import build_baseline_core as j_build_baseline
from repro.data.synthetic import tracking_like as j_tracking, ward_like as j_ward
from repro.stream.ingest import delta_view as j_delta_view
from repro_torch.api import (
    Config,
    ConfigError,
    IndexConfig,
    OverlapIndex,
    SearchConfig,
)
from repro_torch.core.forest import FOREST_FIELDS
from repro_torch.core.knn import (
    delta_view_from_numpy,
    device_forest_from_numpy,
    knn_exact,
    knn_search_impl,
)
from repro_torch.core.pipeline import build_baseline_core
from repro_torch.data.synthetic import tracking_like, ward_like
from repro_torch.kernels import ref as tref

D2_RTOL = 8 * float(np.finfo(np.float32).eps)
STAT_KEYS = ("buckets_visited", "distances", "bound_distances",
             "padded_distances", "comparisons")


def _queries(x, n, seed):
    g = np.random.default_rng(seed)
    base = x[g.choice(len(x), n)]
    return (base + 0.5 * g.normal(size=base.shape)).astype(np.float32)


def _d2_tol(q, x):
    return D2_RTOL * ((q ** 2).sum(1) + (x ** 2).sum(1).max())[:, None]


def _assert_same_result(q, x, d_port, i_port, d_ref, i_ref):
    """Distances within the expansion's rounding; ids equal except where a
    swapped pair of neighbours is a near tie."""
    assert d_port.shape == d_ref.shape and i_port.shape == i_ref.shape
    tol = _d2_tol(q, x)
    d2p, d2r = d_port.astype(np.float64) ** 2, d_ref.astype(np.float64) ** 2
    assert (np.abs(d2p - d2r) <= tol).all(), np.abs(d2p - d2r).max()
    for qi, j in zip(*np.nonzero(i_port != i_ref)):
        # a differing id must be a reference neighbour at a near-tied d^2
        row = i_ref[qi]
        assert i_port[qi, j] in row, (qi, j)
        jr = int(np.nonzero(row == i_port[qi, j])[0][0])
        assert abs(d2r[qi, jr] - d2r[qi, j]) <= tol[qi, 0], (qi, j)


def _assert_same_stats(s_port, s_ref):
    for name in STAT_KEYS:
        np.testing.assert_array_equal(s_port[name], np.asarray(s_ref[name]), err_msg=name)
    assert s_port["steps"] == int(s_ref["steps"])


def test_baseline_build_bitwise(blob_data):
    f_j, rep_j = j_build_baseline(blob_data, None)
    f_t, rep_t = build_baseline_core(blob_data, None)
    for name in FOREST_FIELDS:
        a, b = getattr(f_t, name), getattr(f_j, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert f_t.c_max == f_j.c_max
    assert f_t.build_stats == f_j.build_stats
    assert rep_t.detail == rep_j.detail
    assert (rep_t.tree_distances, rep_t.tree_comparisons) == (
        rep_j.tree_distances, rep_j.tree_comparisons)


def test_baseline_honors_gh_with_warning(blob_data):
    with pytest.warns(UserWarning, match="documented BCCF baseline"):
        f_t, _ = build_baseline_core(blob_data, IndexConfig(pivot_method="gh", c_max=64))
    f_j, _ = j_build_baseline(blob_data, JIndexConfig(pivot_method="gh", c_max=64))
    np.testing.assert_array_equal(f_t.bucket_ids, f_j.bucket_ids)


@pytest.fixture(scope="module")
def baseline_pair(blob_data):
    """(port index, JAX index) per quantize setting, built once."""
    out = {}
    for quantize in (False, True):
        out[quantize] = (
            OverlapIndex.baseline(
                blob_data,
                Config(index=IndexConfig(pivot_method="kmeans"),
                       search=SearchConfig(quantize=quantize)),
                device="cpu",
            ),
            JIndex.baseline(
                blob_data,
                JConfig(index=JIndexConfig(pivot_method="kmeans"),
                        search=JSearchConfig(quantize=quantize)),
            ),
        )
    return out


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("beam", [1, 4, 7])
def test_baseline_search_parity(blob_data, baseline_pair, beam, quantize):
    tx, jx = baseline_pair[quantize]
    q = _queries(blob_data, 48, seed=beam)
    rt = tx.search(q, k=10, beam=beam)
    rj = jx.search(q, k=10, beam=beam)
    _assert_same_result(q, blob_data, rt.dists, rt.ids, rj.dists, rj.ids)
    _assert_same_stats(rt.stats, rj.stats)
    assert rt.ids.dtype == np.int32 and rt.dists.dtype == np.float32
    assert (rt.ids >= 0).all()


def test_default_baseline_matches_jax(blob_data):
    """cfg=None: the documented 2-means baseline, same config tree."""
    tx = OverlapIndex.baseline(blob_data, device="cpu")
    jx = JIndex.baseline(blob_data)
    assert tx.cfg.index.pivot_method == jx.cfg.index.pivot_method == "kmeans"
    assert tx.n_indexes == jx.n_indexes == 1
    assert tx.structure() == jx.structure()
    np.testing.assert_array_equal(tx.x_all, jx.x_all)
    assert tx.device.bucket_x.dtype == torch.float32
    assert tx.device.bucket_x.device.type == "cpu"


def test_mode_all_equals_knn_exact(blob_data, baseline_pair):
    tx, _ = baseline_pair[False]
    q = _queries(blob_data, 32, seed=11)
    res = tx.search(q, k=10, mode="all")
    de, ie = knn_exact(torch.from_numpy(blob_data), torch.from_numpy(q), k=10)
    _assert_same_result(q, blob_data, res.dists, res.ids, de.numpy(), ie.numpy())
    dj, ij = j_knn_exact(jnp.asarray(blob_data), jnp.asarray(q), k=10)
    _assert_same_result(q, blob_data, de.numpy(), ie.numpy(), np.asarray(dj), np.asarray(ij))


def test_search_truncates_to_dataset_size():
    """Def. 4: |X| <= k returns the whole set, k' = n."""
    x = np.random.default_rng(4).normal(size=(6, 3)).astype(np.float32)
    tx = OverlapIndex.baseline(x, device="cpu")
    jx = JIndex.baseline(x)
    rt, rj = tx.search(x[:2], k=10), jx.search(x[:2], k=10)
    assert rt.k == rj.k == 6
    _assert_same_result(x[:2], x, rt.dists, rt.ids, rj.dists, rj.ids)


OVERLAP_CFG = JConfig(
    index=JIndexConfig(method="vbm", eps=1.5, min_pts=8, xi_min=0.1, xi_max=0.7),
    stream=JStreamConfig(capacity=128),
)


@pytest.fixture(scope="module")
def overlap_index(blob_data):
    """A JAX-built overlap forest: several indexes with neighbour links."""
    jx = JIndex.build(blob_data, OVERLAP_CFG)
    assert jx.n_indexes > 2 and (jx.forest.neighbors >= 0).sum() > 0
    return jx


def _port_forest(jx, quantize=False):
    arrays = {n: np.asarray(getattr(jx.forest, n)) for n in FOREST_FIELDS}
    return device_forest_from_numpy(arrays, device="cpu", quantize=quantize)


@pytest.mark.parametrize("beam", [1, 4])
def test_carried_overlap_forest_parity(blob_data, overlap_index, beam):
    jx = overlap_index
    q = _queries(blob_data, 48, seed=30 + beam)
    for quantize in (False, True):
        dj, ij, sj = j_impl(
            j_device_forest(jx.forest, quantize=quantize), jnp.asarray(q),
            k=10, beam=beam,
        )
        dt, it, st = knn_search_impl(
            _port_forest(jx, quantize), torch.from_numpy(q), k=10, beam=beam
        )
        _assert_same_result(q, blob_data, dt.numpy(), it.numpy(), np.asarray(dj), np.asarray(ij))
        for name in STAT_KEYS + ("steps",):
            np.testing.assert_array_equal(
                getattr(st, name).numpy(), np.asarray(getattr(sj, name)), err_msg=name
            )


def test_carried_forest_with_delta_parity(blob_data):
    """After a JAX ingest fills the delta buffers, the port's two-phase scan
    (main rows, then delta rows) gives the JAX package's search."""
    jx = JIndex.build(blob_data, OVERLAP_CFG)
    g = np.random.default_rng(40)
    batch = (blob_data[g.choice(len(blob_data), 200)]
             + 0.3 * g.normal(size=(200, blob_data.shape[1]))).astype(np.float32)
    jx.ingest(batch)
    x_all = jx.x_all
    dv = j_delta_view(jx.delta)
    assert int(np.asarray(dv.mask).sum()) > 0
    q = _queries(x_all, 48, seed=41)
    for beam in (1, 3):
        rj = jx.search(q, k=10, beam=beam)
        dt, it, st = knn_search_impl(
            _port_forest(jx), torch.from_numpy(q), k=10, beam=beam,
            delta=delta_view_from_numpy(
                {n: np.asarray(getattr(dv, n)) for n in dv._fields}, device="cpu"
            ),
        )
        _assert_same_result(q, x_all, dt.numpy(), it.numpy(), rj.dists, rj.ids)
        for name in STAT_KEYS:
            np.testing.assert_array_equal(getattr(st, name).numpy(), rj.stats[name], err_msg=name)
        assert int(st.steps) == rj.stats["steps"]


def _grid_blobs(g, n, d):
    """Clustered rows on a 1/8 grid in [-15.875, 15.875], plus a constant
    feature 15.875 that makes every row's int8 scale exactly 1/8: f32 and
    int8 buckets then hold the same values, and every sum of the expansion
    is exact in f32, whatever its order."""
    centers = g.uniform(-10, 10, size=(6, d))
    x = centers[g.integers(0, 6, n)] + 2.0 * g.normal(size=(n, d))
    x = np.clip(np.round(x * 8) / 8, -15.875, 15.875)
    return np.concatenate([x, np.full((n, 1), 15.875)], axis=1).astype(np.float32)


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("beam", [1, 3, 4])
def test_phase_ref_matches_jax_scan_sorted(quantize, beam):
    """The plain K1 phase (``bucket_scan_phase_ref``) over the JAX package's
    own ``PhaseBounds``: the main phase, then a delta phase seeded with its
    carry, equal the JAX ``scan_sorted`` bit for bit in top_d, top_i, every
    counter and steps."""
    g = np.random.default_rng(60 + beam)
    x = _grid_blobs(g, 600, 6)
    qn, kk = 24, 10
    q = x[g.choice(len(x), qn)].copy()
    q[:, :-1] += np.round(g.normal(size=(qn, 6)) * 4) / 8
    jx = JIndex.baseline(x, JConfig(index=JIndexConfig(pivot_method="kmeans", c_max=32)))
    jf = j_device_forest(jx.forest, quantize=quantize)
    jq = jnp.asarray(q)
    n_d, cap_d = 5, 9
    dx = _grid_blobs(g, n_d * cap_d, 6).reshape(n_d, cap_d, 7)
    dmask = g.random((n_d, cap_d)) < 0.7
    dmask[0] = False  # an empty buffer is never eligible
    dids = np.where(dmask, 10_000 + np.arange(n_d * cap_d).reshape(n_d, cap_d), -1)
    dpiv = dx.mean(axis=1).astype(np.float32)
    drad = np.sqrt(((dx - dpiv[:, None]) ** 2).sum(-1)).max(1).astype(np.float32)
    jdelta = JDeltaView(x=jnp.asarray(dx), ids=jnp.asarray(dids, jnp.int32),
                        mask=jnp.asarray(dmask), pivot=jnp.asarray(dpiv),
                        radius=jnp.asarray(drad))
    sel = jnp.ones((qn, jf.index_centers.shape[0]), bool)
    jb = j_bucket_bounds(jf, jq, sel, beam=beam, kernel=False)
    jdb = j_delta_bounds(jdelta, jq, jnp.ones((qn, n_d), bool), beam=beam, kernel=False)
    want = j_scan_sorted(jf, jq, jb, kk=kk, beam=beam, kernel=False,
                         delta=jdelta, dbounds=jdb)

    tf = _port_forest(jx, quantize)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    main = tref.bucket_scan_phase_ref(
        t(q), tf.bucket_x, tf.bucket_ids, torch.sum(tf.bucket_mask, 1, dtype=torch.int32),
        t(jb.order), t(jb.lb_sorted), beam, torch.full((qn, kk), float("inf")),
        torch.full((qn, kk), -1, dtype=torch.int32), tf.bucket_scale)
    delta = tref.bucket_scan_phase_ref(
        t(q), t(dx), t(dids.astype(np.int32)), t(dmask.sum(1).astype(np.int32)),
        t(jdb.order), t(jdb.lb_sorted), beam, main[0], main[1])
    np.testing.assert_array_equal(delta[0].numpy().view(np.int32),
                                  np.asarray(want.top_d).view(np.int32))
    np.testing.assert_array_equal(delta[1].numpy(), np.asarray(want.top_i))
    np.testing.assert_array_equal(main[2].numpy(), np.asarray(want.visits_main))
    for j, name in ((2, "visits"), (3, "ndist"), (4, "npad")):
        np.testing.assert_array_equal((main[j] + delta[j]).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    assert int(main[5].max()) + int(delta[5].max()) == int(want.steps)
    assert int(delta[5].max()) > 0 and int(main[5].max()) > 1


def test_synthetic_datasets_match():
    np.testing.assert_array_equal(ward_like(20_000), j_ward(20_000))
    np.testing.assert_array_equal(tracking_like(5_000), j_tracking(5_000))


BAD = [
    (dict(method="vbmm"), "registered overlap method"),
    (dict(xi_min=0.8, xi_max=0.4), "xi_min < xi_max"),
    (dict(eps=0.0), "eps"),
    (dict(min_pts=0), "min_pts"),
    (dict(c_max=1), "c_max"),
    (dict(pivot_method="median"), "pivot_method"),
    (dict(dbscan_block=0), "dbscan_block"),
]


@pytest.mark.parametrize("kwargs, fragment", BAD)
def test_index_config_messages_match(kwargs, fragment):
    with pytest.raises(ConfigError, match=fragment) as got:
        IndexConfig(**kwargs)
    with pytest.raises(ValueError) as want:
        JIndexConfig(**kwargs)
    # the registry hint names each package's own api module
    assert str(got.value) == str(want.value).replace("repro.api.", "repro_torch.api.")


@pytest.mark.parametrize("kwargs", [dict(k=0), dict(mode="fast"), dict(beam=0)])
def test_search_config_messages_match(kwargs):
    with pytest.raises(ConfigError) as got:
        SearchConfig(**kwargs)
    with pytest.raises(ValueError) as want:
        JSearchConfig(**kwargs)
    assert str(got.value) == str(want.value)


def test_plan_cache_and_overrides(blob_data, baseline_pair):
    tx, _ = baseline_pair[False]
    q = _queries(blob_data, 8, seed=50)
    before = tx.plans.stats()
    tx.search(q, k=5, beam=2)
    tx.search(q, k=5, beam=2)
    after = tx.plans.stats()
    assert after["misses"] == before["misses"] + 1
    assert after["hits"] == before["hits"] + 1
    for bad in (dict(k=0), dict(beam=0), dict(mode="fast")):
        with pytest.raises(ConfigError):
            tx.search(q, **bad)
    with pytest.raises(TypeError):
        OverlapIndex()
