"""The port's overlap build (``OverlapIndex.build``: DBSCAN -> VBM/DBM/OBM ->
decision -> forest) against the JAX package, on the CPU.

Same numpy inputs through ``repro`` and ``repro_torch``:

* ``betainc`` against ``jax.scipy.special.betainc`` and
  ``scipy.special.betainc``; the cap geometry and the VBM/DBM/OBM rate
  matrices ``allclose`` (``RTOL``, ``ATOL``) at D = 2, 8, 20;
* ``decide`` on the JAX package's DBSCAN partitions: the same groups
  (members exact, neighbours, overlap flags) and stats;
* ``build_index_core``: bit-equal ``ForestArrays`` and the same report;
* ``OverlapIndex.build(x, cfg, device="cpu").search``: the JAX search's ids
  and integer stats at beam 1 and 4, f32 and int8.

The decision thresholds are hard cuts on the rates, and the rates agree only
to ``RTOL``/``ATOL``: each decision test first asserts that no off-diagonal
rate lies within that tolerance of ``xi_min``, ``xi_max`` or 0, so a
difference in the groups can only be a fault.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import torch
from jax.scipy.special import betainc as j_betainc

from repro.api import (
    Config as JConfig,
    IndexConfig as JIndexConfig,
    OverlapIndex as JIndex,
    SearchConfig as JSearchConfig,
)
from repro.core import decision as jdec
from repro.core import overlap as jovl
from repro.core.dbscan import dbscan as j_dbscan, partitions_from_labels as j_partitions
from repro.core.pipeline import build_index_core as j_build
from repro_torch.api import (
    Config,
    ConfigError,
    IndexConfig,
    OverlapIndex,
    SearchConfig,
    available_overlap_methods,
    register_overlap_method,
    unregister_overlap_method,
)
from repro_torch.core import overlap as tovl
from repro_torch.core.decision import decide
from repro_torch.core.forest import FOREST_FIELDS
from repro_torch.core.pipeline import build_index_core
from repro_torch.kernels.ops import quantize_datastore
from test_torch_search import STAT_KEYS, _d2_tol, _queries

RTOL, ATOL = 1e-5, 1e-6
METHODS = ("vbm", "dbm", "obm")
# tests/test_torch_search.py's OVERLAP_CFG: several indexes, overlap links
BUILD_KW = dict(eps=1.5, min_pts=8, xi_min=0.1, xi_max=0.7)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


@pytest.mark.parametrize("n_dim", [2, 8, 20])
def test_betainc_matches_jax_and_scipy(n_dim):
    """I_x((n+1)/2, 1/2), the cap volume's factor, over the whole of [0, 1]
    (both sides of the symmetry switch; x = 0, 1 and their neighbours)."""
    g = np.random.default_rng(n_dim)
    x = np.concatenate([g.uniform(0, 1, 400), [0.0, 1.0, 1e-7, 1 - 1e-7, 0.5]]).astype(np.float32)
    a = np.float32(0.5 * (n_dim + 1))
    got = tovl.betainc(torch.tensor(a), 0.5, _t(x)).numpy()
    want = np.asarray(j_betainc(a, 0.5, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    exact = scipy.special.betainc(float(a), 0.5, x.astype(np.float64))
    np.testing.assert_allclose(got, exact, rtol=1e-4, atol=1e-5)  # f32 against f64
    assert got.dtype == np.float32 and got[x == 0][0] == 0.0 and got[x == 1][0] == 1.0


def test_betainc_special_cases_match_jax():
    a = np.array([0.0, 2.0, 2.0, -1.0, 3.0, np.inf, 0.5], np.float32)
    b = np.array([0.5, 0.0, 0.0, 0.5, 0.5, 0.5, np.inf], np.float32)
    x = np.array([0.3, 0.3, 1.0, 0.5, 1.5, 0.2, 0.4], np.float32)
    got = tovl.betainc(_t(a), _t(b), _t(x)).numpy()
    want = np.asarray(j_betainc(jnp.asarray(a), jnp.asarray(b), jnp.asarray(x)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got[~np.isnan(got)], want[~np.isnan(want)], rtol=RTOL, atol=ATOL)


def _geometry(n_dim, seed):
    """Radii and centre distances covering partial overlap, theta > pi/2
    (one centre deep inside the other ball), containment and disjoint."""
    g = np.random.default_rng(seed)
    r1 = g.uniform(0.5, 5.0, 300).astype(np.float32)
    r2 = g.uniform(0.5, 5.0, 300).astype(np.float32)
    d = (g.uniform(0.0, 1.2, 300) * (r1 + r2)).astype(np.float32)
    return r1, r2, d


@pytest.mark.parametrize("n_dim", [2, 8, 20])
def test_cap_geometry_matches_jax(n_dim):
    r1, r2, d = _geometry(n_dim, seed=n_dim)
    tr1, tr2, td = _t(r1), _t(r2), _t(d)
    jr1, jr2, jd = jnp.asarray(r1), jnp.asarray(r2), jnp.asarray(d)
    cos_t = tovl.cap_cos_theta(tr1, tr2, td)
    cos_j = jovl.cap_cos_theta(jr1, jr2, jd)
    assert (cos_t.numpy() < 0).any()  # theta > pi/2 is covered
    for got, want in [(cos_t, cos_j),
                      (tovl.cap_height(tr1, cos_t), jovl.cap_height(jr1, cos_j))]:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    # log volumes on the same cos theta.  Each sums terms of up to ~40
    # (n log r, lgamma(n/2 + 1), n/2 log pi, log I), and the f32 rounding of
    # a sum is relative to its terms, not to the result: at D = 20 the JAX
    # package's lgamma(11) alone is 3.5 ulp off.  So each is held to RTOL of
    # the magnitude of its terms (``scale``).  (From r and d, a shallow cap
    # at D = 20 amplifies a 1-ulp difference in cos theta ~n/2-fold through
    # 1 - cos^2; the rates below take that path end to end.)
    c1 = cos_t.numpy()
    c2 = tovl.cap_cos_theta(tr2, tr1, td).numpy()
    scale = (0.5 * n_dim * np.log(np.pi) + math.lgamma(0.5 * n_dim + 1)
             + n_dim * np.abs(np.log(np.maximum(r1, r2))))
    reg = scipy.special.betainc(0.5 * (n_dim + 1), 0.5, np.clip(1 - np.minimum(c1, c2) ** 2, 0, 1))
    scale = scale + np.log(2) + np.abs(np.log(np.maximum(reg, 1e-12)))
    vol_t = [tovl.ball_log_volume(n_dim, tr1), tovl.cap_log_volume(n_dim, tr1, _t(c1))]
    vol_j = [jovl.ball_log_volume(n_dim, jr1), jovl.cap_log_volume(n_dim, jr1, jnp.asarray(c1))]
    vol_t.append(torch.logaddexp(vol_t[1], tovl.cap_log_volume(n_dim, tr2, _t(c2))))
    vol_j.append(jnp.logaddexp(vol_j[1], jovl.cap_log_volume(n_dim, jr2, jnp.asarray(c2))))
    for got, want in zip(vol_t, vol_j):
        err = np.abs(got.numpy().astype(np.float64) - np.asarray(want, np.float64))
        assert (err <= ATOL + RTOL * scale).all(), (err / scale).max()
    for fn in ("vbm_rate", "dbm_rate"):
        args = (n_dim,) if fn == "vbm_rate" else ()
        got = getattr(tovl, fn)(tr1, tr2, td, *args).numpy()
        want = np.asarray(getattr(jovl, fn)(jr1, jr2, jd, *args))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _partitions(n_dim, seed, c=9, n=600):
    g = np.random.default_rng(seed)
    pivots = (g.normal(size=(c, n_dim)) * 3).astype(np.float32)
    radii = g.uniform(1.0, 6.0, c).astype(np.float32)
    assign = g.integers(0, c, n).astype(np.int32)
    x = (pivots[assign] + g.normal(size=(n, n_dim))).astype(np.float32)
    return x, pivots, radii, assign


@pytest.mark.parametrize("n_dim", [2, 8, 20])
@pytest.mark.parametrize("method", METHODS)
def test_overlap_matrices_match_jax(method, n_dim):
    x, pivots, radii, assign = _partitions(n_dim, seed=10 * n_dim + len(method))
    got = tovl.overlap_matrix(method, _t(pivots), _t(radii), x=_t(x),
                              assign=torch.from_numpy(assign))
    want = jovl.overlap_matrix(method, jnp.asarray(pivots), jnp.asarray(radii),
                               x=jnp.asarray(x), assign=jnp.asarray(assign))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert (np.diag(got.numpy()) == 0).all()
    np.testing.assert_allclose(tovl.max_neighbor_rate(got).numpy(),
                               np.asarray(jovl.max_neighbor_rate(want)), rtol=RTOL, atol=ATOL)
    member = tovl.ball_membership(_t(x), _t(pivots), _t(radii)).numpy()
    np.testing.assert_array_equal(
        member, np.asarray(jovl.ball_membership(jnp.asarray(x), jnp.asarray(pivots),
                                                jnp.asarray(radii))))


def test_overlap_registry_mirrors_jax():
    assert available_overlap_methods() == jovl.available_overlap_methods()
    with pytest.raises(ValueError) as got:
        tovl.get_overlap_method("nope")
    with pytest.raises(ValueError) as want:
        jovl.get_overlap_method("nope")
    assert str(got.value) == str(want.value).replace("repro.core", "repro_torch.core")
    with pytest.raises(ValueError, match="object-based"):
        tovl.overlap_matrix("obm", torch.zeros(2, 3), torch.ones(2))


def test_registered_method_flows_through_config_and_decide(blob_data):
    """A heuristic registered at run time is a valid IndexConfig.method and
    drives decide, as in the JAX package."""
    with pytest.raises(ConfigError):
        IndexConfig(method="half_dbm")
    register_overlap_method(
        "half_dbm", lambda p, r, *, x=None, assign=None: 0.5 * tovl._dbm_matrix(p, r))
    try:
        with pytest.raises(ValueError, match="already registered"):
            register_overlap_method("half_dbm", tovl._dbm_matrix)
        assert IndexConfig(method="half_dbm").method == "half_dbm"
        res = j_dbscan(blob_data, 1.5, 8)
        pv, rd, asg = j_partitions(blob_data, res.labels, res.n_clusters)
        groups, stats = decide(blob_data, pv, rd, asg, method="half_dbm", xi_min=0.05,
                               xi_max=0.35, device="cpu")
        assert stats.n_final == len(groups) > 0
    finally:
        unregister_overlap_method("half_dbm")
    assert "half_dbm" not in available_overlap_methods()


def _assert_margins(rates, xi_min, xi_max):
    """No off-diagonal rate within the comparison tolerance of a threshold
    or of 0, so the port's rates fall on the same side of every cut."""
    off = rates[~np.eye(len(rates), dtype=bool)]
    for cut in (xi_min, xi_max, 0.0):
        near = np.abs(off - cut) <= ATOL + RTOL * abs(cut)
        near &= ~((cut == 0.0) & (off == 0.0))  # an exact 0 is disjoint on both sides
        assert not near.any(), f"a rate lies within tolerance of {cut}: change the thresholds"


@pytest.mark.parametrize("method", METHODS)
def test_decide_matches_jax(blob_data, method, monkeypatch):
    res = j_dbscan(blob_data, 1.5, 8)
    pivots, radii, assign = j_partitions(blob_data, res.labels, res.n_clusters)
    kw = dict(method=method, xi_min=BUILD_KW["xi_min"], xi_max=BUILD_KW["xi_max"])
    seen = []  # every rate matrix the JAX decide cuts on (initial, then merged)
    rate_matrix = jdec._rate_matrix
    monkeypatch.setattr(jdec, "_rate_matrix",
                        lambda *a: seen.append(rate_matrix(*a)) or seen[-1])
    want, wst = jdec.decide(blob_data, pivots, radii, assign, **kw)
    assert seen
    for rates in seen:
        _assert_margins(rates, kw["xi_min"], kw["xi_max"])
    got, gst = decide(blob_data, pivots, radii, assign, **kw, device="cpu")
    assert gst.__dict__ == wst.__dict__
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.members, b.members)
        np.testing.assert_array_equal(a.pivot, b.pivot)
        assert a.radius == b.radius
        assert a.neighbors == b.neighbors and a.is_overlap_index == b.is_overlap_index


@pytest.mark.parametrize("method", METHODS)
def test_build_index_core_bitwise(blob_data, method):
    cfg = IndexConfig(method=method, **BUILD_KW)
    f_t, rep_t = build_index_core(blob_data, cfg, device="cpu")
    f_j, rep_j = j_build(blob_data, JIndexConfig(method=method, **BUILD_KW))
    for name in FOREST_FIELDS:
        a, b = getattr(f_t, name), getattr(f_j, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert f_t.c_max == f_j.c_max and f_t.build_stats == f_j.build_stats
    for name in ("n_objects", "n_clusters", "n_indexes", "n_overlap_indexes",
                 "dbscan_distances", "overlap_distances", "tree_distances",
                 "tree_comparisons"):
        assert getattr(rep_t, name) == getattr(rep_j, name), name
    assert rep_t.detail == rep_j.detail
    assert set(rep_t.phase_s) == {"dbscan", "decide", "forest"}
    if method == "vbm":
        assert f_t.n_indexes > 2 and f_t.is_overlap_index.any() and (f_t.neighbors >= 0).any()


@pytest.fixture(scope="module")
def built_pair(blob_data):
    """(port index, JAX index) per (method, quantize), built once."""
    out = {}
    for method in ("vbm", "obm"):
        for quantize in (False, True):
            out[method, quantize] = (
                OverlapIndex.build(
                    blob_data, Config(index=IndexConfig(method=method, **BUILD_KW),
                                      search=SearchConfig(quantize=quantize)),
                    device="cpu"),
                JIndex.build(
                    blob_data, JConfig(index=JIndexConfig(method=method, **BUILD_KW),
                                       search=JSearchConfig(quantize=quantize))),
            )
    return out


def _assert_same_up_to_ties(q, rows, rt, rj):
    """Rank by rank, the port's d2 is the reference's within the expansion's
    rounding (``_d2_tol``); where the ids differ, the port's row lies at the
    reference's d2 of that rank up to that rounding (two rows tied up to
    rounding may come back in either order, and the last rank may hold
    either of them)."""
    assert rt.ids.shape == rj.ids.shape
    tol = _d2_tol(q, rows)
    d2p, d2r = rt.dists.astype(np.float64) ** 2, rj.dists.astype(np.float64) ** 2
    assert (np.abs(d2p - d2r) <= tol).all(), np.abs(d2p - d2r).max()
    for qi, j in zip(*np.nonzero(rt.ids != rj.ids)):
        exact = ((rows[rt.ids[qi, j]].astype(np.float64) - q[qi]) ** 2).sum()
        assert abs(exact - d2r[qi, j]) <= 2 * tol[qi, 0], (qi, j)
    assert all(len(set(r)) == len(r) for r in rt.ids.tolist())


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("beam", [1, 4])
@pytest.mark.parametrize("method", ["vbm", "obm"])
def test_build_search_parity(blob_data, built_pair, method, beam, quantize):
    tx, jx = built_pair[method, quantize]
    assert tx.n_indexes == jx.n_indexes and tx.structure() == jx.structure()
    q = _queries(blob_data, 48, seed=60 + beam)
    rt = tx.search(q, k=10, beam=beam)
    rj = jx.search(q, k=10, beam=beam)
    rows = blob_data
    if quantize:  # the rows the index stores and ranks by
        xq, scale = quantize_datastore(torch.from_numpy(blob_data))
        rows = (xq.float() * scale[:, None]).numpy()
    _assert_same_up_to_ties(q, rows, rt, rj)
    for name in STAT_KEYS:
        np.testing.assert_array_equal(rt.stats[name], np.asarray(rj.stats[name]), err_msg=name)
    assert rt.stats["steps"] == int(rj.stats["steps"])


def test_build_without_device_refuses_cpu(blob_data, monkeypatch):
    """No device named and no CUDA: the entry point raises, never runs on
    the CPU by itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OverlapIndex.build(blob_data, Config(index=IndexConfig(**BUILD_KW)))
