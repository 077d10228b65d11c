"""The port's DBSCAN (``repro_torch.core.dbscan``) and its plain K3/K4/K5
(``repro_torch.kernels.ref.eps_*_ref``) against the JAX package, on the CPU.

Same numpy inputs through both packages:

* the plain eps-graph reductions against ``repro.kernels.ref.eps_*_ref`` and
  the Pallas kernels in interpret mode: counts and labels exact, K5's d2
  within ``D2_ATOL``;
* ``dbscan`` on the shapes of ``tests/test_dbscan.py`` and on ``blob_data``:
  labels, core mask, ``n_iterations`` and ``distance_computations`` equal,
  through the kernel path (on the CPU: the plain versions) and the in-place
  plain path (``kernel=False``);
* ``partitions_from_labels`` bit for bit.

Exactness of the threshold: ``d2 <= eps_sq`` is a hard cut on an f32
expansion.  A pair whose d2 lies within a few ulp of ||q||^2 + ||x||^2 of
eps_sq may be decided differently by two correct implementations.  The
cases here either sit on a 1/8 grid, where every sum of the expansion is
exact in f32 (so eps_sq is put on a data value and ties at the threshold
really occur), or use the JAX package's own nudge of eps_sq off the data
(``tests/test_dbscan.py``), and hold counts and labels exactly.  K5's d2
near zero suffers cancellation in the expansion (a query that is its own
nearest core point gets 0 on one side and ~1e-5 on the other), so it is held
with ``D2_ATOL``, not ``atol=0``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dbscan as j_dbscan
from repro.core import partitions_from_labels as j_partitions
from repro.kernels import ref as jref
from repro.kernels.pairwise_l2 import (
    eps_count_pallas,
    eps_min_label_pallas,
    eps_nearest_core_pallas,
)
from repro_torch.core.dbscan import dbscan, partitions_from_labels
from repro_torch.kernels import ops, ref
from repro_torch.kernels.eps_graph import (
    eps_count_cuda,
    eps_min_label_cuda,
    eps_nearest_core_cuda,
)

D2_ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eps_all(q, x, labels, core, eps_sq):
    """(port plain, JAX ref, Pallas interpret) results of K3, K4, K5."""
    tq, tx, tl, tc = _t(q), _t(x), _t(labels), _t(core)
    port = (
        ops.eps_count(tq, tx, eps_sq).numpy(),
        ops.eps_min_label(tq, tx, tl, tc, eps_sq).numpy(),
        *(a.numpy() for a in ops.eps_nearest_core(tq, tx, tl, tc)),
    )
    jq, jx, jl, jc = (jnp.asarray(a) for a in (q, x, labels, core))
    je = jnp.float32(eps_sq)
    jr = (
        jref.eps_count_ref(jq, jx, je),
        jref.eps_min_label_ref(jq, jx, jl, jc, je),
        *jref.eps_nearest_core_ref(jq, jx, jl, jc),
    )
    kw = dict(bq=32, bn=32, interpret=True)
    jp = (
        eps_count_pallas(jq, jx, je, **kw),
        eps_min_label_pallas(jq, jx, jl, jc, je, **kw),
        *eps_nearest_core_pallas(jq, jx, jl, jc, **kw),
    )
    return port, tuple(np.asarray(a) for a in jr), tuple(np.asarray(a) for a in jp)


def _assert_eps_equal(port, other):
    cnt, lab, dmin, nlab = port
    assert cnt.dtype == np.int32 and lab.dtype == np.int32 and nlab.dtype == np.int32
    np.testing.assert_array_equal(cnt, other[0])
    np.testing.assert_array_equal(lab, other[1])
    np.testing.assert_array_equal(nlab, other[3])
    np.testing.assert_allclose(dmin, other[2], rtol=1e-6, atol=D2_ATOL)


@pytest.mark.parametrize("qn,n,d", [(37, 117, 6), (64, 64, 2), (5, 150, 20), (150, 129, 5)])
def test_eps_plain_matches_jax(qn, n, d):
    """Continuous data, eps_sq nudged off the median distance as the JAX
    package's own test does."""
    g = np.random.default_rng(qn * 1000 + n + d)
    x = (g.normal(size=(n, d)) * 2).astype(np.float32)
    q = x[:qn].copy()
    labels = g.integers(0, n, size=n).astype(np.int32)
    core = g.random(n) < 0.6
    d_all = np.asarray(jref.pairwise_sq_l2_ref(jnp.asarray(q), jnp.asarray(x)))
    eps_sq = float(np.float32(np.median(d_all) * 1.0009))
    port, jr, jp = _eps_all(q, x, labels, core, eps_sq)
    _assert_eps_equal(port, jr)
    _assert_eps_equal(port, jp)


@pytest.mark.parametrize("qn,n,d", [(33, 97, 3), (64, 130, 8), (1, 64, 20)])
def test_eps_plain_matches_jax_on_grid_ties(qn, n, d):
    """Rows on a 1/8 grid: the expansion is exact, eps_sq is a data value
    (pairs sit exactly on the threshold) and K5 meets exact d2 ties, which
    the first index must win on every side."""
    g = np.random.default_rng(qn + n + d)
    x = (g.integers(-12, 13, size=(n, d)) / 8).astype(np.float32)
    q = (g.integers(-12, 13, size=(qn, d)) / 8).astype(np.float32)
    labels = g.permutation(n).astype(np.int32)
    core = g.random(n) < 0.5
    d_all = ((q[:, None, :].astype(np.float64) - x[None]) ** 2).sum(-1)
    eps_sq = float(np.sort(d_all, axis=None)[d_all.size // 2])  # a data value
    assert (d_all == eps_sq).sum() > 0
    port, jr, jp = _eps_all(q, x, labels, core, eps_sq)
    for other in (jr, jp):
        _assert_eps_equal(port, other)
        np.testing.assert_array_equal(port[2], other[2])  # exact on the grid


def test_eps_plain_no_core_points():
    """No core point: sentinel N labels and (+inf, N) nearest, as JAX."""
    g = np.random.default_rng(11)
    x = g.normal(size=(40, 3)).astype(np.float32)
    labels = np.arange(40, dtype=np.int32)
    core = np.zeros(40, bool)
    port, jr, jp = _eps_all(x, x, labels, core, 1.0)
    for other in (jr, jp):
        _assert_eps_equal(port, other)
    assert (port[1] == 40).all() and np.isinf(port[2]).all() and (port[3] == 40).all()


def test_eps_dispatch_on_cpu_counts_nothing():
    """A CPU tensor runs the plain version and launches no kernel; the CUDA
    wrappers refuse CPU tensors rather than fall back."""
    x = torch.randn(20, 4)
    core = torch.ones(20, dtype=torch.bool)
    labels = torch.arange(20, dtype=torch.int32)
    before = ops.launch_counts()
    ops.eps_count(x, x, 1.0)
    ops.eps_min_label(x, x, labels, core, 1.0)
    ops.eps_nearest_core(x, x, labels, core)
    assert ops.launch_counts() == before
    assert {"eps_count", "eps_min_label", "eps_nearest_core"} <= set(before)
    with pytest.raises(ValueError, match="CUDA device"):
        eps_count_cuda(x, x, 1.0)
    with pytest.raises(ValueError, match="CUDA device"):
        eps_min_label_cuda(x, x, labels, core, 1.0)
    with pytest.raises(ValueError, match="CUDA device"):
        eps_nearest_core_cuda(x, x, labels, core)


def _clusters(seed):
    """tests/test_dbscan.py::test_dbscan_matches_reference's data."""
    g = np.random.default_rng(seed)
    centers = g.normal(size=(4, 4)) * 8
    return np.concatenate(
        [c + g.normal(size=(120, 4)) for c in centers] + [g.uniform(-12, 12, (40, 4))]
    ).astype(np.float32)


def _assert_same_dbscan(got, want):
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.core_mask, want.core_mask)
    assert got.labels.dtype == np.int32 and got.core_mask.dtype == bool
    assert got.n_clusters == want.n_clusters
    assert got.n_iterations == want.n_iterations
    assert got.distance_computations == want.distance_computations


@pytest.mark.parametrize("kernel", [True, False])
@pytest.mark.parametrize("seed,block", [(0, 64), (1, 1000), (2, 64), (2, 1000)])
def test_dbscan_matches_jax(seed, block, kernel):
    x = _clusters(seed)
    got = dbscan(x, 1.2, 6, block=block, kernel=kernel, device="cpu")
    want = j_dbscan(x, 1.2, 6, block=block, kernel=kernel)
    _assert_same_dbscan(got, want)


@pytest.mark.parametrize("kernel", [True, False])
def test_dbscan_blob_data_matches_jax(blob_data, kernel):
    got = dbscan(blob_data, 1.5, 8, kernel=kernel, device="cpu")
    want = j_dbscan(blob_data, 1.5, 8, kernel=kernel)
    _assert_same_dbscan(got, want)
    assert got.n_clusters > 1 and got.n_iterations > 1


@pytest.mark.parametrize("case", ["all_noise", "single_cluster", "max_iter"])
def test_dbscan_edge_cases_match_jax(case):
    if case == "all_noise":
        x = np.random.default_rng(3).uniform(-100, 100, size=(50, 6)).astype(np.float32)
        args, kw = (0.01, 5), {}
    elif case == "single_cluster":
        x = np.random.default_rng(4).normal(size=(200, 3)).astype(np.float32)
        args, kw = (3.0, 4), {}
    else:  # a chain whose labels need more sweeps than allowed
        x = np.stack([np.arange(300, dtype=np.float32), np.zeros(300, np.float32)], 1)
        args, kw = (1.0, 2), dict(max_iter=2)
    got = dbscan(x, *args, **kw, device="cpu")
    _assert_same_dbscan(got, j_dbscan(x, *args, **kw))
    if case == "max_iter":
        assert got.n_iterations == 2


def test_dbscan_accepts_a_tensor_and_a_device(blob_data):
    got = dbscan(torch.from_numpy(blob_data), 1.5, 8, device="cpu")
    _assert_same_dbscan(got, dbscan(blob_data, 1.5, 8, device="cpu"))


@pytest.mark.parametrize("eps", [1.5, 0.01])
def test_partitions_from_labels_bitwise(blob_data, eps):
    """Pivots, radii and the noise-assigned partition of every object, bit
    for bit (0.01: all noise, the degenerate single partition)."""
    res = dbscan(blob_data, eps, 8, device="cpu")
    got = partitions_from_labels(blob_data, res.labels, res.n_clusters)
    want = j_partitions(blob_data, res.labels, res.n_clusters)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
