"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: these need an NVIDIA GPU and ``nvcc`` (the kernels build
from ``src/repro_torch/csrc`` at first use) and skip elsewhere.  Run them on
the card with ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.

Tolerances: the kernels sum ||q||^2, ||x||^2 and q.x with FMA contraction in
their own order, the plain versions through cuBLAS/reductions in another;
on unit-scale data the difference is ~1e-6, held to ``rtol = atol = 1e-5``
(int8: ``1e-4``).  Ids are compared exactly where the case pins ties.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.bucket_scan import bucket_scan_phase_cuda
from repro_torch.kernels.pairwise_l2 import pairwise_sq_l2_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("q_n,x_n,d", [
    (1, 1, 1), (65, 130, 33), (128, 257, 96), (1024, 841, 20), (1024, 1498, 5),
    (7, 9, 13), (9, 17, 128), (70, 3, 200),
])
def test_pairwise_kernel_matches_plain(dev, q_n, x_n, d):
    g = np.random.default_rng(q_n + x_n + d)
    q = torch.from_numpy(g.normal(size=(q_n, d)).astype(np.float32)).to(dev)
    x = torch.from_numpy(g.normal(size=(x_n, d)).astype(np.float32)).to(dev)
    n0 = pairwise_sq_l2_cuda.launches
    got = ops.pairwise_sq_l2(q, x)
    torch.cuda.synchronize()
    assert pairwise_sq_l2_cuda.launches == n0 + 1
    want = ref.pairwise_sq_l2_ref(q, x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("qn,n", [(1, 1), (7, 9), (31, 130), (33, 257), (64, 1498), (100, 841)])
@pytest.mark.parametrize("d", list(range(1, 41)))
def test_pairwise_kernel_bit_equal_on_grid(dev, qn, n, d):
    """On 1/8-grid rows the expansion is exact in f32, so K2 equals its plain
    version bit for bit: every width of the small-D kernel (D <= 32) and the
    tiled one above it, N not a multiple of 4 (rows start off 16-byte
    alignment) and Q below one tile."""
    g = np.random.default_rng(1000 * d + n + qn)
    q = torch.from_numpy(_grid(g, qn, d)).to(dev)
    x = torch.from_numpy(_grid(g, n, d)).to(dev)
    got = ops.pairwise_sq_l2(q, x)
    want = ref.pairwise_sq_l2_ref(q, x)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _phase_problem(g, qn, nb, cap, dim, beam, kk, *, pad_frac=0.3, inf_frac=0.2,
                   int8=False, dev="cuda"):
    """A K1 scan phase on grid rows (int8: integers with scale 1/8), so the
    expansion is exact and the kernel must equal the plain phase bit for bit.
    Bounds per bucket with a share of +inf rows, sorted and padded to a beam
    multiple by the search's own ``_sorted_bounds``."""
    from repro_torch.core.knn import _sorted_bounds

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    q = _grid(g, qn, dim)
    if int8:
        bx = g.integers(-127, 128, size=(nb, cap, dim)).astype(np.int8)
        scale = t(np.full((nb, cap), 0.125, np.float32))
    else:
        bx = _grid(g, nb * cap, dim).reshape(nb, cap, dim)
        scale = None
    ids = np.arange(nb * cap, dtype=np.int32).reshape(nb, cap)
    ids = np.where(g.random((nb, cap)) < pad_frac, -1, ids).astype(np.int32)
    lb = (g.random((qn, nb)) * 1.5 * np.sqrt(dim) * (8.0 if int8 else 1.0)).astype(np.float32)
    lb[g.random((qn, nb)) < inf_frac] = np.inf
    order, lb_sorted, _ = _sorted_bounds(t(lb), beam)
    top_d = torch.full((qn, kk), float("inf"), device=dev)
    top_i = torch.full((qn, kk), -1, dtype=torch.int32, device=dev)
    return [t(q), t(bx), t(ids), t((ids >= 0).sum(1).astype(np.int32)), order, lb_sorted,
            beam, top_d, top_i, scale]


def _assert_phase_equal(args, **kw):
    """The phase kernel (one launch) against the plain lockstep phase: bit
    for bit in top_d, top_i, visits, ndist, npad and qsteps (``kw``: the
    ``extent`` both are given)."""
    n0 = bucket_scan_phase_cuda.launches
    got = ops.bucket_scan_phase(*args, **kw)
    torch.cuda.synchronize()
    assert bucket_scan_phase_cuda.launches == n0 + 1
    want = ref.bucket_scan_phase_ref(*args, **kw)
    for name, a, b in zip(("top_d", "top_i", "visits", "ndist", "npad", "qsteps"), got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    return got


def _packed(g, args):
    """The problem's buckets with their live members a prefix, as the forests
    keep them, of random length: 0 and C among them."""
    ids = args[2]
    nb, cap = ids.shape
    live = torch.from_numpy(g.integers(0, cap + 1, nb).astype(np.int32)).to(ids.device)
    live[0], live[-1] = 0, cap
    cols = torch.arange(cap, device=ids.device)
    full = torch.arange(nb * cap, dtype=torch.int32, device=ids.device).reshape(nb, cap)
    args[2] = torch.where(cols[None, :] < live[:, None], full, -1).to(torch.int32)
    args[3] = live
    return args


def _assert_staged_equal(args, extent=None):
    """The kernel's staged rows (added to what ``staged`` holds) against the
    plain phase's, with the extent given or derived from the ids."""
    qn = args[0].shape[0]
    got = torch.full((qn,), 7, dtype=torch.int32, device=args[0].device)
    want = got.clone()
    bucket_scan_phase_cuda(*args, extent=extent, staged=got)
    ref.bucket_scan_phase_ref(*args, extent=extent, staged=want)
    assert torch.equal(got, want)
    return got - 7


@pytest.mark.parametrize("qn,nb,cap,dim,beam,kk", [
    (4, 7, 5, 6, 3, 4), (2, 9, 8, 16, 4, 7), (1, 3, 2, 33, 1, 5), (5, 13, 4, 8, 4, 11),
    (64, 40, 1000, 5, 1, 10), (64, 40, 1000, 5, 4, 10), (48, 30, 250, 20, 1, 10),
    (32, 12, 2500, 20, 3, 10), (16, 10, 300, 20, 3, 300),
])
@pytest.mark.parametrize("int8", [False, True])
def test_bucket_scan_kernel_matches_plain(dev, qn, nb, cap, dim, beam, kk, int8):
    """Beams 1/3/4, WARD's C = 1000 at D = 5 and Tracking's C = 250 at
    D = 20, C = 2500 (several shared-memory tiles a bucket) and kk = 300."""
    g = np.random.default_rng(qn * 7 + cap + beam)
    got = _assert_phase_equal(_phase_problem(g, qn, nb, cap, dim, beam, kk, int8=int8))
    assert int(got[5].max()) > 0


@pytest.mark.parametrize("qn,nb,cap,dim,beam,kk", [
    (4, 7, 5, 6, 3, 4), (64, 40, 1000, 5, 1, 10), (48, 30, 250, 20, 1, 10),
    (32, 12, 2500, 20, 3, 10),
])
@pytest.mark.parametrize("int8", [False, True])
def test_bucket_scan_kernel_explicit_extent_with_holes(dev, qn, nb, cap, dim, beam, kk, int8):
    """30% holes anywhere in a bucket: the extent (last live row + 1) given
    explicitly gives the plain phase's six outputs, and the rows staged are
    the plain phase's."""
    g = np.random.default_rng(qn * 7 + cap + beam + 1)
    args = _phase_problem(g, qn, nb, cap, dim, beam, kk, int8=int8)
    got = _assert_phase_equal(args, extent=ref.bucket_extent(args[2]))
    assert int(got[5].max()) > 0
    staged = _assert_staged_equal(args, ref.bucket_extent(args[2]))
    assert bool((staged <= got[4]).all())


@pytest.mark.parametrize("qn,nb,cap,dim,beam,kk", [
    (64, 40, 1000, 5, 1, 10), (64, 40, 1000, 5, 4, 10), (64, 40, 1000, 5, 1, 100),
    (48, 30, 250, 20, 1, 10), (48, 30, 250, 20, 4, 10), (5, 13, 4, 8, 4, 11),
])
@pytest.mark.parametrize("int8", [False, True])
def test_bucket_scan_kernel_packed_buckets(dev, qn, nb, cap, dim, beam, kk, int8):
    """Live members a prefix of random length (0 and C among them) at WARD's
    (C 1000, D 5) and Tracking's (C 250, D 20) shapes: bit for bit the plain
    phase's with the extent derived and given; the staged rows equal the
    plain phase's, and below npad where buckets are short."""
    g = np.random.default_rng(qn + cap + beam + kk + int8)
    args = _packed(g, _phase_problem(g, qn, nb, cap, dim, beam, kk, int8=int8))
    got = _assert_phase_equal(args)
    _assert_phase_equal(args, extent=args[3])
    assert int(got[5].max()) > 0
    staged = _assert_staged_equal(args)
    assert torch.equal(staged, _assert_staged_equal(args, args[3]))
    assert int(staged.sum()) < int(got[4].sum())


def test_bucket_scan_kernel_capacity_past_16_bits(dev):
    """C >= 65,536: the window holds no extent, which the kernel reads from
    device memory instead; live prefixes longer than 65,535 rows."""
    g = np.random.default_rng(65536)
    args = _packed(g, _phase_problem(g, 4, 4, 70_000, 2, 1, 5))
    cols = torch.arange(70_000, device=dev)
    args[2][1] = torch.where(cols < 65_537, cols + 70_000, -1).to(torch.int32)
    args[3][1] = 65_537
    got = _assert_phase_equal(args)
    assert int(got[5].max()) > 0
    _assert_staged_equal(args)


@pytest.mark.parametrize("cell,cap,dim,kk,blocks", [
    ("ward-vbm.b16k-k10", 1000, 5, 10, 7), ("tracking-vbm.b16k-k10", 250, 20, 10, 4),
    ("ward-vbm.b16k-k100", 1000, 5, 100, 6),
])
def test_bucket_scan_blocks_per_sm_at_the_cells_shapes(dev, cell, cap, dim, kk, blocks):
    """The window carries the extents in the counts' word, so K1 holds at
    least the blocks an SM it held before the extents (f32 buckets, beam 1):
    7, 4 and 6."""
    from repro_torch.kernels.bucket_scan import blocks_per_sm

    assert blocks_per_sm(cap, dim, kk, 1) >= blocks, cell


def test_bucket_scan_kernel_ties_and_dry_pool(dev):
    """Exact ties across the slots of a step (one row in every bucket);
    fewer than k reachable (kth stays +inf: every slot active, pad slots
    re-scan bucket 0, the tail stays (+inf, -1)); a delta phase seeded with
    the main phase's carry; and a carry whose kth is below every bound (no
    step runs)."""
    g = np.random.default_rng(9)
    args = _phase_problem(g, 5, 6, 4, 5, 3, 7, pad_frac=0.0, inf_frac=0.0)
    args[1][:] = args[1][0, 0]
    got = _assert_phase_equal(args)
    assert (torch.diff(got[0], dim=1) == 0).all()

    args = _phase_problem(g, 4, 5, 3, 3, 4, 40, pad_frac=0.5)
    got = _assert_phase_equal(args)
    assert (got[5] == args[4].shape[1] // 4).all() and torch.isinf(got[0]).any()
    assert torch.equal(torch.isinf(got[0]), got[1] == -1)

    main = _phase_problem(g, 32, 20, 64, 5, 2, 10)
    carry = _assert_phase_equal(main)
    delta = _phase_problem(g, 32, 6, 50, 5, 2, 10, pad_frac=0.5)
    delta[0] = main[0]
    delta[7], delta[8] = carry[0], carry[1]
    _assert_phase_equal(delta)

    done = _phase_problem(g, 3, 6, 4, 4, 2, 5, inf_frac=0.0)
    done[5] = done[5] + 1.0
    done[7] = torch.full_like(done[7], 0.25)
    got = _assert_phase_equal(done)
    assert int(got[5].max()) == 0 and torch.equal(got[0], done[7])


# --- K3, K4, K5: the DBSCAN eps-graph passes ---------------------------------


def _grid(g, n, d):
    """Rows on a 1/8 grid: the expansion is exact in f32, so the kernels and
    the plain versions agree bit for bit and d2 == eps_sq really occurs."""
    return (g.integers(-16, 17, size=(n, d)) / 8).astype(np.float32)


def _eps_pair(q, x, labels, core, eps_sq):
    kernel = (
        ops.eps_count(q, x, eps_sq), ops.eps_min_label(q, x, labels, core, eps_sq),
        *ops.eps_nearest_core(q, x, labels, core),
    )
    plain = (
        ref.eps_count_ref(q, x, eps_sq), ref.eps_min_label_ref(q, x, labels, core, eps_sq),
        *ref.eps_nearest_core_ref(q, x, labels, core),
    )
    torch.cuda.synchronize()
    return kernel, plain


@pytest.mark.parametrize("qn,n,d", [
    (1, 1, 1), (63, 65, 5), (64, 129, 20), (65, 300, 33), (1000, 4097, 5),
    (257, 1000, 20), (33, 130, 70), (17, 260, 200),
])
def test_eps_kernels_match_plain_exactly(dev, qn, n, d):
    g = np.random.default_rng(qn + 7 * n + d)
    q = torch.from_numpy(_grid(g, qn, d)).to(dev)
    x = torch.from_numpy(_grid(g, n, d)).to(dev)
    labels = torch.from_numpy(g.integers(0, n, n).astype(np.int32)).to(dev)
    core = torch.from_numpy(g.random(n) < 0.5).to(dev)
    eps_sq = float(torch.sort(ref.pairwise_sq_l2_ref(q, x).flatten()).values[qn * n // 2])
    n0 = ops.launch_counts()
    kernel, plain = _eps_pair(q, x, labels, core, eps_sq)
    after = ops.launch_counts()
    for name in ("eps_count", "eps_min_label", "eps_nearest_core"):
        assert after[name] == n0[name] + 1
    for a, b in zip(kernel, plain):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_eps_kernels_sentinel_and_ties(dev):
    """Tied core rows in three tiles (the first index wins K5), a non-core
    row tied before them, a query with no core neighbour (K4's sentinel N),
    and no core point at all ((+inf, N))."""
    n, d = 300, 5
    g = np.random.default_rng(5)
    x = 40.0 + _grid(g, n, d)
    x[2], x[5], x[140], x[290] = np.eye(d)[2], np.eye(d)[0], -np.eye(d)[0], np.eye(d)[1]
    x = torch.from_numpy(x.astype(np.float32)).to(dev)
    core = torch.ones(n, dtype=torch.bool, device=dev)
    core[2] = False
    labels = torch.arange(n, 0, -1, dtype=torch.int32, device=dev)
    q = torch.zeros((3, d), device=dev)
    q[2] = -3.0
    kernel, plain = _eps_pair(q, x, labels, core, 1.0)
    for a, b in zip(kernel, plain):
        assert torch.equal(a, b)
    assert kernel[3][:2].tolist() == [int(labels[5])] * 2
    assert kernel[1].tolist() == [int(labels[290])] * 2 + [n]
    none = torch.zeros(n, dtype=torch.bool, device=dev)
    kernel, plain = _eps_pair(q, x, labels, none, 1.0)
    assert (kernel[1] == n).all() and torch.isinf(kernel[2]).all() and (kernel[3] == n).all()
    for a, b in zip(kernel, plain):
        assert torch.equal(a, b)


@pytest.mark.parametrize("d", [5, 20])
def test_eps_core_ties_across_column_chunks(dev, d):
    """K4/K5 over N several ``CHUNK``s of core columns: core rows tied at
    d2 = 1 sit at compact positions in three different column chunks, a
    non-core row is tied ahead of them; the first tied core row wins K5 and
    the min label over them K4, exactly as the plain versions say."""
    from repro_torch.kernels.eps_graph import CHUNK, compact_core

    n = 3 * CHUNK + 77
    g = np.random.default_rng(d)
    x = 40.0 + _grid(g, n, d)
    unit = np.eye(d, dtype=np.float32)
    tied = [1, CHUNK + 1, 2 * CHUNK + 6]  # compact positions 0, CHUNK, 2 CHUNK + 5
    x[0], x[tied[0]], x[tied[1]], x[tied[2]] = unit[2], unit[0], -unit[0], unit[1]
    x = torch.from_numpy(x).to(dev)
    core = torch.ones(n, dtype=torch.bool, device=dev)
    core[0] = False
    labels = torch.arange(n, 0, -1, dtype=torch.int32, device=dev)
    q = torch.zeros((3, d), device=dev)
    q[2] = -3.0
    x_core, _ = compact_core(x, labels, core)
    assert torch.equal(x_core[CHUNK], -torch.from_numpy(unit[0]).to(dev))
    kernel, plain = _eps_pair(q, x, labels, core, 1.0)
    for a, b in zip(kernel, plain):
        assert torch.equal(a, b)
    assert kernel[3][:2].tolist() == [int(labels[tied[0]])] * 2
    assert kernel[2][:2].tolist() == [1.0, 1.0]
    assert kernel[1].tolist() == [int(labels[tied[2]])] * 2 + [n]


@pytest.mark.parametrize("d", [5, 20, 70])
def test_eps_core_few_queries(dev, d):
    """A Q far below one wave of blocks (one query tile, a few column
    chunks): K4/K5 still equal the plain versions exactly."""
    from repro_torch.kernels.eps_graph import eps_min_label_cuda, eps_nearest_core_cuda

    g = np.random.default_rng(d + 1)
    n = 10_000
    x = torch.from_numpy(_grid(g, n, d)).to(dev)
    q = x[:37].clone()
    labels = torch.from_numpy(g.integers(0, n, n).astype(np.int32)).to(dev)
    core = torch.from_numpy(g.random(n) < 0.7).to(dev)
    eps_sq = float(torch.sort(ref.pairwise_sq_l2_ref(q, x).flatten()).values[37 * n // 100])
    kernel, plain = _eps_pair(q, x, labels, core, eps_sq)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for wrapper in (eps_min_label_cuda, eps_nearest_core_cuda):
        tiles, chunks = wrapper.grid
        assert tiles == 1 and tiles * chunks < sms
    for a, b in zip(kernel, plain):
        assert torch.equal(a, b)


@pytest.mark.parametrize("d", [5, 20, 70])
def test_eps_count_chunks_few_queries(dev, d):
    """K3 over N = 2 CHUNK + 5 columns with a Q far below one wave: rows on
    the threshold sit on both sides of each column-chunk edge, the counts
    equal the plain version's bit for bit, and the launch reports its grid
    (one query tile, three column chunks) and counts once."""
    from repro_torch.kernels.eps_graph import CHUNK, eps_count_cuda

    g = np.random.default_rng(d + 11)
    n = 2 * CHUNK + 5
    x = _grid(g, n, d)
    q = _grid(g, 37, d)
    unit = np.eye(d, dtype=np.float32)
    edges = [CHUNK - 1, CHUNK, 2 * CHUNK - 1, 2 * CHUNK, 2 * CHUNK + 4]
    for k, row in enumerate(edges):
        x[row] = q[0] + unit[k % d]  # d2 = 1 from query 0, exactly
    q, x = torch.from_numpy(q).to(dev), torch.from_numpy(x).to(dev)
    n0 = eps_count_cuda.launches
    got = ops.eps_count(q, x, 1.0)
    torch.cuda.synchronize()
    assert eps_count_cuda.launches == n0 + 1
    assert eps_count_cuda.grid == (1, 3)
    want = ref.eps_count_ref(q, x, 1.0)
    assert got.dtype == want.dtype and torch.equal(got, want)
    d2 = ref.pairwise_sq_l2_ref(q[:1], x)[0]
    assert bool((d2[edges] == 1.0).all()) and int(got[0]) >= len(edges)


def test_eps_count_in_band_at_data_scale(dev):
    """Tracking-like rows (||x||^2 ~ 10^4): a count may differ from the plain
    one only by pairs whose d2 lies within 8 ulp of ||q||^2 + ||x||^2 of
    eps_sq."""
    from repro_torch.data.synthetic import tracking_like

    x = torch.from_numpy(tracking_like(6000)).to(dev)
    eps_sq = 36.0
    got = ops.eps_count(x, x, eps_sq).long()
    d2 = ref.pairwise_sq_l2_ref(x, x).double()
    nn = (x.double() ** 2).sum(1)
    band = 8 * 2.0 ** -23 * (nn[:, None] + nn[None, :])
    lo = (d2 <= eps_sq - band).sum(1)
    hi = (d2 <= eps_sq + band).sum(1)
    assert bool(((got >= lo) & (got <= hi)).all())


def test_overlap_build_on_the_card(dev, blob_data):
    """OverlapIndex.build on the card: DBSCAN through K3-K5, a forest with
    overlap indexes and links, and searches exact against a brute force:
    mode 'all' over every row, mode 'forest' over the rows of each query's
    closest index and its overlap neighbours (Alg. 2's routing)."""
    from repro_torch.api import Config, IndexConfig, OverlapIndex
    from repro_torch.core.knn import knn_exact

    cfg = Config(index=IndexConfig(method="vbm", eps=1.5, min_pts=8, xi_min=0.1, xi_max=0.7))
    n0 = ops.launch_counts()
    ix = OverlapIndex.build(blob_data, cfg, device=dev)
    launched = {k: v - n0[k] for k, v in ops.launch_counts().items()}
    assert launched["eps_count"] == 1 and launched["eps_nearest_core"] == 1
    assert launched["eps_min_label"] == ix.build_report.detail["dbscan_iterations"]
    f = ix.forest
    assert f.n_indexes > 2 and f.is_overlap_index.any() and (f.neighbors >= 0).any()
    g = np.random.default_rng(3)
    q = (blob_data[g.choice(len(blob_data), 64)] + 0.5 * g.normal(size=(64, 8))).astype(np.float32)
    qt, xt = torch.from_numpy(q).to(dev), torch.from_numpy(blob_data).to(dev)
    _, want = knn_exact(xt, qt, k=10, kernel=False)
    for beam in (1, 4):
        res = ix.search(q, k=10, beam=beam, mode="all")
        _same_neighbours(q, blob_data, res.ids, want.cpu().numpy())
        # forest mode: the brute force over the routed indexes' rows
        res = ix.search(q, k=10, beam=beam)
        closest = np.argmin(((q[:, None] - f.index_centers[None]) ** 2).sum(-1), 1)
        owner = np.empty(len(blob_data), np.int64)
        live = f.bucket_ids >= 0
        owner[f.bucket_ids[live]] = np.broadcast_to(f.bucket_index[:, None], live.shape)[live]
        for qi in range(len(q)):
            ok = {int(closest[qi])} | {int(v) for v in f.neighbors[closest[qi]] if v >= 0}
            rows = np.nonzero(np.isin(owner, list(ok)))[0]
            d2 = ((blob_data[rows] - q[qi]) ** 2).sum(-1)
            _same_neighbours(q[qi:qi + 1], blob_data, res.ids[qi:qi + 1],
                             rows[np.argsort(d2, kind="stable")[:10]][None])


def _same_neighbours(q, x, got, want):
    """Equal neighbour sets up to ties within the expansion's rounding."""
    for qi in range(len(q)):
        dg = np.sort(((x[got[qi]] - q[qi]) ** 2).sum(-1))
        dw = np.sort(((x[want[qi]] - q[qi]) ** 2).sum(-1))
        tol = 1e-5 * (1 + (q[qi] ** 2).sum() + (x ** 2).sum(1).max())
        np.testing.assert_allclose(dg, dw, rtol=0, atol=tol)


# --------------------------------------------------------------------------
# K6 (knn_topk) and K7 (pairwise_sq_l2_int8): bit-equal on grid rows, where
# the expansion is exact in any order; N < k; exact ties over two row ranges
# --------------------------------------------------------------------------


@pytest.mark.parametrize("qn,n,d,k", [
    (3, 5, 5, 8), (8, 1000, 64, 8), (9, 3000, 5, 1), (17, 2049, 896, 16),
    (8, 700, 896, 64), (1, 1, 1, 1), (64, 5000, 20, 10), (1030, 300, 7, 5),
    (32, 4099, 96, 8), (33, 4099, 96, 8), (31, 70_001, 383, 64), (40, 70_001, 20, 1),
])
def test_knn_topk_kernel_equals_plain(dev, qn, n, d, k):
    """Both block shapes (stream Q <= 32, tiled above) and their boundary."""
    from repro_torch.kernels.topk import STREAM_MAX_Q, plan

    g = np.random.default_rng(qn + n + d + k)
    q = torch.from_numpy(_grid(g, qn, d)).to(dev)
    x = torch.from_numpy(_grid(g, n, d)).to(dev)
    if n > 2:
        x[n - 1] = x[1]  # an exact tie, far apart: the lower row wins
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert plan(qn, n, k, sms).regime == ("stream" if qn <= STREAM_MAX_Q else "tiled")
    n0 = ops.launch_counts()["knn_topk"]
    kv, ki = ops.knn_topk(q, x, k=k)
    torch.cuda.synchronize()
    assert ops.launch_counts()["knn_topk"] == n0 + 1
    rv, ri = ref.knn_topk_ref(q, x, k)
    assert torch.equal(kv, rv) and torch.equal(ki, ri)
    if n < k:
        assert bool(torch.isinf(kv[:, n:]).all()) and bool((ki[:, n:] == -1).all())


@pytest.mark.parametrize("qn", [16, 40])
def test_knn_topk_ties_across_chunks(dev, qn):
    """Rows duplicated into the planner's last row range (another block of
    the launch, in both regimes): the in-kernel merge keeps the lower row
    first."""
    from repro_torch.kernels.topk import plan

    g = np.random.default_rng(1)
    n, d = 1 << 18, 32
    x = torch.from_numpy(_grid(g, n, d)).to(dev)
    p = plan(qn, n, 4, torch.cuda.get_device_properties(dev).multi_processor_count)
    first, last = p.row_range(0, n), p.row_range(p.ranges - 1, n)
    dup = last[0] + 3
    assert p.ranges > 1 and first[1] >= 5 + qn and dup + qn <= last[1]
    x[dup:dup + qn] = x[5:5 + qn]
    q = x[5:5 + qn].clone()
    kv, ki = ops.knn_topk(q, x, k=4)
    rv, ri = ref.knn_topk_ref(q, x, 4)
    assert torch.equal(kv, rv) and torch.equal(ki, ri)
    assert torch.equal(ki[:, 0].cpu(), torch.arange(5, 5 + qn, dtype=torch.int32))
    assert torch.equal(ki[:, 1].cpu(), torch.arange(dup, dup + qn, dtype=torch.int32))


def test_knn_topk_decode_is_one_device_launch(dev):
    """A decode-batch call (Q = 8, many row ranges) runs exactly one device
    kernel: no query-norm pre-pass and no merge launch."""
    from torch.profiler import ProfilerActivity, profile

    g = np.random.default_rng(2)
    x = torch.from_numpy(g.normal(size=(1 << 17, 896)).astype(np.float32)).to(dev)
    q = torch.from_numpy(g.normal(size=(8, 896)).astype(np.float32)).to(dev)
    ops.knn_topk(q, x, k=8)  # the ticket counters are zeroed once, here
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ops.knn_topk(q, x, k=8)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 1 and "knn_topk" in names[0], names


@pytest.mark.parametrize("k", [1, 8, 64])
def test_knn_topk_plan_smem_matches_kernel(dev, k):
    """The planner's shared-memory bytes are the kernel's, for every shape."""
    from repro_torch.kernels.topk import SHAPES, _lib

    lib = _lib()
    for shape in SHAPES:
        assert lib.knn_topk_smem(shape.index, k) == shape.smem_bytes(k)


@pytest.mark.parametrize("qn,n,d", [(3, 5, 5), (8, 1000, 64), (17, 2049, 896), (9, 300, 7),
                                    (1, 1, 1), (70, 4097, 20)])
def test_pairwise_int8_kernel_equals_plain(dev, qn, n, d):
    """Power-of-two scales: the dequantized rows are exact, so is the result."""
    g = np.random.default_rng(qn * 3 + n + d)
    q = torch.from_numpy(_grid(g, qn, d)).to(dev)
    xq = torch.from_numpy(g.integers(-127, 128, size=(n, d)).astype(np.int8)).to(dev)
    s = torch.from_numpy((2.0 ** -g.integers(4, 8, size=n)).astype(np.float32)).to(dev)
    n0 = ops.launch_counts()["pairwise_sq_l2_int8"]
    got = ops.pairwise_sq_l2_int8(q, xq, s)
    torch.cuda.synchronize()
    assert ops.launch_counts()["pairwise_sq_l2_int8"] == n0 + 1
    assert torch.equal(got, ref.pairwise_sq_l2_int8_ref(q, xq, s))


def test_serving_on_the_card(dev):
    """A smoke model served on the card through K6 and K7: every request
    completes and each run launches its kernel once per decode step."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import RetrievalConfig
    from repro_torch.data.synthetic import embedding_datastore_on
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.retrieval import build_flat_datastore

    cfg = get_smoke_config("qwen2-0.5b").replace(
        retrieval=RetrievalConfig(enabled=True, k=8, lam=0.25))
    model = Model(cfg, device=dev, seed=0)
    keys, values = embedding_datastore_on(dev, 5000, cfg.d_model)
    g = np.random.default_rng(0)
    for quantized, kname in ((False, "knn_topk"), (True, "pairwise_sq_l2_int8")):
        ds = build_flat_datastore(keys, values % cfg.vocab_size, quantized=quantized, device=dev)
        eng = ServeEngine(model, num_slots=3, max_len=32, datastore=ds)
        for rid in range(5):
            eng.submit(Request(rid=rid, prompt=g.integers(0, cfg.vocab_size, 4 + rid)
                               .astype(np.int32), max_new_tokens=5))
        n0 = ops.launch_counts()[kname]
        done = eng.run()
        assert len(done) == 5 and all(r.done and len(r.out_tokens) == 5 for r in done)
        assert ops.launch_counts()[kname] - n0 == eng.steps


@pytest.mark.parametrize("qn", [1, 8, 9, 17])
@pytest.mark.parametrize("d", [5, 64, 896, 900])
@pytest.mark.parametrize("offset", [0, 1])
def test_pairwise_int8_ragged_shapes(dev, qn, d, offset):
    """K7 on grid queries, int8 rows and power-of-two scales, bit-equal to the
    plain version: Q below and across the 8-query tile, N not a multiple of
    the 256-row block, D not a multiple of the 32-feature stage (5, 900) or of
    the 16-byte copy (5, 900), and rows that start one byte off alignment
    (offset 1: the plain-load path)."""
    g = np.random.default_rng(qn * 1000 + d + offset)
    n = 1537 + 3 * qn
    q = torch.from_numpy(_grid(g, qn, d)).to(dev)
    rows = torch.from_numpy(g.integers(-127, 128, size=n * d + offset).astype(np.int8)).to(dev)
    xq = rows[offset:].view(n, d)
    assert xq.is_contiguous() and xq.data_ptr() % 16 == offset
    s = torch.from_numpy((2.0 ** -g.integers(4, 8, size=n)).astype(np.float32)).to(dev)
    n0 = ops.launch_counts()["pairwise_sq_l2_int8"]
    got = ops.pairwise_sq_l2_int8(q, xq, s)
    torch.cuda.synchronize()
    assert ops.launch_counts()["pairwise_sq_l2_int8"] == n0 + 1
    assert got.shape == (qn, n)
    assert torch.equal(got, ref.pairwise_sq_l2_int8_ref(q, xq, s))


# --------------------------------------------------------------------------
# streaming: K1's delta phase, K1 at the forest datastore's width, and the
# card's ingest state
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [
    # (qn, main nb, main C, D, delta I, delta CAPD): WARD's forest (C=1000,
    # 12 indexes of 1000 delta slots) and bench_stream's (C=141 at D=12, a
    # few indexes of 2048 delta slots)
    (64, 40, 1000, 5, 12, 1000), (64, 60, 141, 12, 6, 2048),
])
@pytest.mark.parametrize("beam", [1, 4])
def test_delta_phase_seeded_with_main_carry(dev, shape, beam):
    """The search's second K1 phase over (I, CAPD, D) f32 delta buffers
    (half filled), seeded with the main phase's top-k, bit for bit against
    the plain phase."""
    qn, nb, cap, dim, n_d, capd = shape
    g = np.random.default_rng(nb + cap + beam)
    main = _phase_problem(g, qn, nb, cap, dim, beam, 10)
    carry = _assert_phase_equal(main)
    delta = _phase_problem(g, qn, n_d, capd, dim, beam, 10, pad_frac=0.5, inf_frac=0.1)
    delta[0] = main[0]
    delta[7], delta[8] = carry[0], carry[1]
    got = _assert_phase_equal(delta)
    assert int(got[5].max()) > 0


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("beam", [1, 4])
def test_bucket_scan_at_datastore_width(dev, int8, beam):
    """K1 at the forest datastore's shape: D = 896 (qwen2-0.5b's keys),
    C = 256 (sqrt of 65,536 rows), k = 8, eight decode slots as queries."""
    g = np.random.default_rng(896 + beam + int8)
    got = _assert_phase_equal(_phase_problem(g, 8, 24, 256, 896, beam, 8, int8=int8))
    assert int(got[5].max()) > 0


def test_card_ingest_is_deterministic_and_matches_the_cpu(dev):
    """The same batches ingested twice on the card give the same buffers bit
    for bit (the coordinate sums included), and the CPU's: ids, rows,
    counts, drops and accepts equal, radius and coordinate sums within a
    few ulp (another summation order)."""
    from repro_torch.api import OverlapIndex
    from repro_torch.data.synthetic import drifting_batches
    from repro_torch.stream.ingest import alloc_delta, ingest_impl

    x0 = np.concatenate(drifting_batches(4000, 4000, 12, seed=3))
    forest = OverlapIndex.baseline(x0, device="cpu").forest
    batches = drifting_batches(3 * 1024, 1024, 12, seed=11)

    def run(device):
        delta = alloc_delta(forest, 700, device=device)
        centers = torch.from_numpy(forest.index_centers).to(device)
        accs = []
        for i, xb in enumerate(batches):
            ids = torch.arange(4000 + 1024 * i, 4000 + 1024 * (i + 1), dtype=torch.int32)
            valid = torch.from_numpy(np.arange(1024) % 7 != 3)
            delta, acc = ingest_impl(centers, delta, torch.from_numpy(xb).to(device),
                                     ids.to(device), valid.to(device))
            accs.append(acc.cpu())
        return [t.cpu() for t in delta], torch.cat(accs)

    (d1, a1), (d2, a2), (dc, ac) = run(dev), run(dev), run("cpu")
    assert torch.equal(a1, a2) and torch.equal(a1, ac) and not bool(a1.all())
    names = ("x", "ids", "count", "pivot", "radius", "sum_x", "main_count", "main_sum",
             "main_radius", "dropped")
    for name, a, b, c in zip(names, d1, d2, dc):
        assert torch.equal(a, b), name
        if name == "radius":
            torch.testing.assert_close(a, c, rtol=1e-6, atol=0.0)
        elif name == "sum_x":
            # two f32 orders of n terms differ by at most n eps sum|x|
            live = torch.arange(dc[0].shape[1])[None, :] < dc[2][:, None]
            abs_sum = (dc[0].double().abs() * live[..., None]).sum(1)
            bound = dc[2].double()[:, None] * 2.0 ** -23 * abs_sum
            assert bool(((a.double() - c.double()).abs() <= bound).all()), name
        else:
            assert torch.equal(a, c), name
    assert int(d1[-1].sum()) > 0  # capacity rejects happened


@pytest.mark.parametrize("beam", [1, 4])
def test_load_and_explain_on_the_card(dev, blob_data, tmp_path, beam):
    """A snapshot written on the CPU loads onto the card; there ``explain``
    returns the search's result bit for bit, conserves visits (contributing
    + wasted == buckets_visited), and its decoded prefixes account for the
    kernel's own distances counter: each query's K1 ``distances`` equal the
    bucket sizes summed over the first ``visits`` entries of each phase's
    order.  Searches after the load launch K1 twice (main and delta)."""
    from repro_torch.api import Config, IndexConfig, OverlapIndex, StreamConfig
    from repro_torch.core.knn import knn_search_explain_impl
    from repro_torch.stream.ingest import delta_view

    cfg = Config(index=IndexConfig(method="vbm", eps=1.5, min_pts=8, xi_min=0.1, xi_max=0.7),
                 stream=StreamConfig(capacity=64))
    host = OverlapIndex.build(blob_data, cfg, device="cpu")
    g = np.random.default_rng(7)
    host.ingest((blob_data[g.choice(len(blob_data), 100)]
                 + 0.3 * g.normal(size=(100, 8))).astype(np.float32))
    ix = OverlapIndex.load(host.save(tmp_path / "blob"), device=dev)
    q = (blob_data[g.choice(len(blob_data), 64)] + 0.5 * g.normal(size=(64, 8))).astype(np.float32)
    n0 = ops.launch_counts()["bucket_scan_topk"]
    res = ix.search(q, k=10, beam=beam)
    assert ops.launch_counts()["bucket_scan_topk"] == n0 + 2
    rep = ix.explain(q, k=10, beam=beam)
    np.testing.assert_array_equal(rep.result.dists, res.dists)
    np.testing.assert_array_equal(rep.result.ids, res.ids)
    np.testing.assert_array_equal(rep.contributing + rep.wasted, res.stats["buckets_visited"])
    qt = torch.from_numpy(q).to(dev)
    dv = delta_view(ix.device_delta)
    _, _, st, rows = knn_search_explain_impl(ix.device, qt, k=10, beam=beam, delta=dv)
    count = ix.device.bucket_mask.sum(1, dtype=torch.int32)
    dcount = dv.mask.sum(1, dtype=torch.int32)

    def prefix_sum(order, visits, sizes):
        cols = torch.arange(order.shape[1], device=dev)[None]
        return torch.where(cols < visits[:, None], sizes[order.long()], 0).sum(1)

    ndist = prefix_sum(rows.order, rows.visits[0], count)
    ndist = ndist + prefix_sum(rows.dorder, rows.dvisits[0], dcount)
    assert int(rows.dvisits.sum()) > 0
    assert torch.equal(ndist.to(torch.int32), st.distances)


@pytest.mark.parametrize("qn,nb,cap,dim,beam,kk", [
    (5, 13, 4, 8, 4, 11), (64, 40, 1000, 5, 1, 10), (48, 30, 250, 20, 4, 10),
])
@pytest.mark.parametrize("int8", [False, True])
def test_bucket_scan_qmask(dev, qn, nb, cap, dim, beam, kk, int8):
    """K1 with a ``qmask``: bit for bit the plain phase's, a masked query
    keeps its carry with zero counters, and an all-true mask equals none."""
    g = np.random.default_rng(qn + cap + beam)
    args = _phase_problem(g, qn, nb, cap, dim, beam, kk, int8=int8)
    mask = torch.from_numpy(g.random(qn) < 0.5).to(dev)
    mask[0] = False
    got = bucket_scan_phase_cuda(*args, qmask=mask)
    want = ref.bucket_scan_phase_ref(*args, qmask=mask)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    off = ~mask
    assert torch.equal(got[0][off], args[7][off]) and torch.equal(got[1][off], args[8][off])
    assert all(bool((c[off] == 0).all()) for c in got[2:])
    full = bucket_scan_phase_cuda(*args, qmask=torch.ones_like(mask))
    none = bucket_scan_phase_cuda(*args)
    assert all(torch.equal(a, b) for a, b in zip(full, none))


@pytest.mark.parametrize("kind", ["sharded", "routed"])
def test_layouts_on_the_card(dev, blob_data, kind):
    """Four islands on one card: the sharded and routed searches (with a
    delta) equal the single layout's and launch K1 once an island a phase."""
    from repro_torch.api import Config, IndexConfig, LayoutConfig, OverlapIndex, StreamConfig

    kw = dict(index=IndexConfig(method="vbm", eps=1.5, min_pts=8, xi_min=0.3, xi_max=0.7),
              stream=StreamConfig(capacity=64))
    single = OverlapIndex.build(blob_data, Config(**kw), device=dev)
    ix = OverlapIndex._wire(single.x_all, single.forest,
                            Config(**kw, layout=LayoutConfig(kind=kind, shards=4)),
                            single.build_report, [dev] * 4)
    g = np.random.default_rng(9)
    batch = (blob_data[g.choice(len(blob_data), 40)] + 0.3 * g.normal(size=(40, 8))
             ).astype(np.float32)
    single.ingest(batch)
    ix.ingest(batch)
    q = (blob_data[g.choice(len(blob_data), 64)] + 0.3 * g.normal(size=(64, 8))).astype(np.float32)
    for beam in (1, 4):
        n0 = ops.launch_counts()["bucket_scan_topk"]
        res = ix.search(q, k=10, beam=beam)
        assert ops.launch_counts()["bucket_scan_topk"] == n0 + 8
        ref_res = single.search(q, k=10, beam=beam)
        np.testing.assert_array_equal(res.dists, ref_res.dists)
        np.testing.assert_array_equal(res.ids, ref_res.ids)


FAMILY_ARCHS = ["whisper-tiny", "pixtral-12b", "jamba-1.5-large-398b", "granite-20b",
                "deepseek-67b", "rwkv6-3b", "deepseek-v2-236b", "qwen3-moe-235b-a22b"]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_model_families_on_the_card(dev, arch):
    """Each family's smoke configuration at f32 compute on the card against
    the same seeded weights on the CPU: forward logits and router losses,
    prefill and two decode steps, to 1e-4 of the logits' scale (cuBLAS and
    the CPU's f32 products in other orders)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import Model

    cfg = get_smoke_config(arch).replace(compute_dtype="float32")
    host = Model(cfg, device="cpu", seed=3)
    card = Model(cfg, device=dev, seed=None)
    card.load_state_dict(host.state_dict())
    card.cast_weights()
    g = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (2, 8), generator=g)
    kw = {}
    if cfg.family == "encdec":
        kw["frames"] = 0.1 * torch.randn((2, cfg.encoder_seq, cfg.d_model), generator=g)
    if cfg.frontend == "vision_stub":
        kw["patches"] = 0.1 * torch.randn((2, cfg.num_stub_patches, cfg.d_model), generator=g)
    out = {}
    for name, m in (("cpu", host), ("card", card)):
        mk = {k: v.to(m.device) for k, v in kw.items()}
        logits, aux, _ = m.forward(toks.to(m.device), **mk)
        _, cache = m.prefill(toks[:, :6].to(m.device), max_len=12, **mk)
        steps = [m.decode_step(toks[:, p:p + 1].to(m.device), cache, p) for p in (6, 7)]
        out[name] = [t.cpu() for t in (logits, *steps, aux["router_aux"], aux["router_z"])]
    for got, want in zip(out["card"], out["cpu"]):
        tol = 1e-4 * max(1.0, float(want.abs().max()))
        torch.testing.assert_close(got, want, rtol=1e-4, atol=tol)


def test_moe_capacity_drops_on_the_card(dev):
    """Forced drops (capacity factor 0.5): the card keeps and drops the
    assignments the CPU does, and its MoE output equals the CPU's."""
    from repro_torch.configs.base import ModelConfig, MoEConfig
    from repro_torch.models import moe

    cfg = ModelConfig(name="t", family="moe", num_layers=1, d_model=16, num_heads=2,
                      num_kv_heads=2, d_ff=32, vocab_size=64,
                      moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=16,
                                    capacity_factor=0.5, num_shared=1))
    host = moe.MoE(cfg, "cpu")
    host.init_(torch.Generator().manual_seed(0))
    host.cast(torch.float32)
    card = moe.MoE(cfg, dev)
    card.load_state_dict(host.state_dict())
    card.cast(torch.float32)
    x = torch.randn((2, 16, 16), generator=torch.Generator().manual_seed(1))
    top_e, _, _ = moe.route(x.reshape(32, 16), host.router, 2)
    _, _, row = moe.dispatch(top_e, 4, 8)
    _, _, row_card = moe.dispatch(top_e.to(dev), 4, 8)
    assert (row < 0).any() and torch.equal(row_card.cpu(), row)
    torch.testing.assert_close(card(x.to(dev))[0].cpu(), host(x)[0], rtol=1e-5, atol=1e-5)


class _Grads:
    """Stands in for ``torch.autograd.grad`` inside a train step: records
    what it returns, or returns ``replay`` (moved to the CPU) instead."""

    def __init__(self, replay=None):
        self.fn, self.replay, self.got = torch.autograd.grad, replay, []

    def __call__(self, outputs, inputs, **kw):
        out = self.fn(outputs, inputs, **kw) if self.replay is None else tuple(
            g.to(p.device) for g, p in zip(self.replay, inputs))
        self.got.append(out)
        return out


def test_train_step_on_the_card(dev, monkeypatch):
    """One smoke-config train step (AdamW, f32 compute) on the card against
    the same seeded weights and batch on the CPU: the loss (rtol 1e-5), the
    gradients (rtol 1e-5, atol 1e-4 of each parameter's largest gradient:
    two f32 evaluations), and the updated parameters and moments (rtol
    1e-5, atol 1e-5 of each leaf's largest |value|) against the CPU's step
    fed the card's gradients, since AdamW's sign-like first update moves a
    gradient element within rounding of zero either way."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models.model import Model
    from repro_torch.optim import get_optimizer
    from repro_torch.tree import tree_leaves
    from repro_torch.train.train_step import init_train_state, make_train_step

    cfg = get_smoke_config("smollm-135m").replace(compute_dtype="float32")
    batch = TokenPipeline(DataConfig(seq_len=16, global_batch=4, vocab_size=256)).batch_at(0)
    models = {"cpu": Model(cfg, device="cpu", seed=0), "replay": Model(cfg, device="cpu", seed=0),
              "card": Model(cfg, device=dev, seed=None)}
    models["card"].load_state_dict(models["cpu"].state_dict())
    out = {}
    for name in ("card", "cpu", "replay"):
        m = models[name]
        opt = get_optimizer("adamw")
        rec = _Grads(out["card"][1][0] if name == "replay" else None)
        monkeypatch.setattr(torch.autograd, "grad", rec)
        step = make_train_step(m, opt, lambda s: torch.tensor(1e-3, device=s.device))
        state, met = step(init_train_state(m, opt), batch)
        monkeypatch.undo()
        out[name] = (float(met["loss"]), rec.got,
                     [t.value().cpu() if hasattr(t, "value") else t.cpu()
                      for t in tree_leaves({"params": state["params"], "opt": state["opt"]})])
    np.testing.assert_allclose(out["card"][0], out["cpu"][0], rtol=1e-5)
    for got, want in zip(out["card"][1][0], out["cpu"][1][0]):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5,
                                   atol=1e-4 * float(want.abs().max()))
    for got, want in zip(out["card"][2], out["replay"][2]):
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * max(float(want.float().abs().max()), 1e-30))


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("tokens,a2a", [(8, False), (4096, False), (4096, True)],
                         ids=["weight-stationary", "token-sharded", "all-to-all"])
def test_moe_island_paths_on_the_card(dev, shape, tokens, a2a):
    """The MoE layer's three island paths on four islands of the card
    (``["cuda:0"] * 4``) at the CPU tests' widths, held to the single-device
    layer on the card (f32, atol 1e-4 of the output's scale, no drops)."""
    from repro_torch.configs.base import ModelConfig, MoEConfig
    from repro_torch.distributed.context import Mesh, use_mesh
    from repro_torch.models import moe

    cfg = ModelConfig(name="t", family="moe", num_layers=1, d_model=16, num_heads=2,
                      num_kv_heads=2, d_ff=32, vocab_size=64, moe_a2a=a2a,
                      param_dtype="float32", compute_dtype="float32",
                      moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=16,
                                    capacity_factor=8.0, num_shared=1))
    layer = moe.MoE(cfg, dev)
    layer.init_(torch.Generator(device=dev).manual_seed(0))
    layer.cast(torch.float32)
    x = torch.randn((1, tokens, 16), generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev)
    mesh = Mesh([dev] * 4, shape=shape, axis_names=("data", "model"))
    with torch.no_grad():
        ref, _ = layer(x)
        assert int(layer.dropped) == 0
        with use_mesh(mesh):
            got, _ = layer(x)
        assert int(layer.dropped) == 0
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-4 * float(ref.abs().max()))
