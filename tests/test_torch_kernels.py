"""The port's plain K1/K2, and K7 at D = 900 (``repro_torch.kernels``), against
the JAX package; and K1's one-launch phase reformulation against the
lockstep loop it replaces.

Each case feeds the same numpy-seeded inputs to the port's plain version, to
``repro.kernels.ref`` and to the Pallas kernel in interpret mode.  On a CPU
tensor the port's dispatch layer runs the plain version, so these tests hold
the arithmetic the CUDA kernels are held to on the card (the card-only
comparison lives in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``).

Tolerances: squared distances agree to ``rtol = atol = 1e-5`` on unit-scale
f32 data (the three implementations sum ||q||^2, ||x||^2 and q.x in
different orders; at these magnitudes the rounding is ~1e-6) and ``1e-4``
for int8 members (dequantized magnitudes reach 127 * scale, so the sums
carry larger rounding).  Ids are compared exactly where the case pins the
tie order (exact duplicates, a dry pool, fewer than k reachable), and by
the distance they achieve elsewhere.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.bucket_scan import bucket_scan_topk_pallas
from repro.kernels.ops import quantize_datastore as j_quantize
from repro.kernels.pairwise_l2 import pairwise_sq_l2_int8_pallas, pairwise_sq_l2_pallas
from repro_torch.kernels import ops, ref
from repro_torch.kernels.bucket_scan import bucket_scan_phase_cuda
from repro_torch.kernels.pairwise_l2 import pairwise_sq_l2_cuda

TOL = 1e-5
TOL_INT8 = 1e-4

# (Q, N, D): the sweep of tests/test_kernels_pairwise.py, then the widths
# D = 1, 5, 13, 20, 128 (5 and 20 are the paper's datasets)
PAIRWISE_SHAPES = [
    (8, 16, 4), (64, 64, 64), (65, 130, 33), (128, 257, 96), (1, 300, 20),
    (7, 9, 1), (33, 70, 5), (16, 40, 13), (50, 61, 20), (9, 17, 128),
]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("q_n,x_n,d", PAIRWISE_SHAPES)
def test_pairwise_plain_matches_jax(q_n, x_n, d):
    g = np.random.default_rng(q_n * 1000 + x_n + d)
    q = g.normal(size=(q_n, d)).astype(np.float32)
    x = g.normal(size=(x_n, d)).astype(np.float32)
    got = ops.pairwise_sq_l2(_t(q), _t(x)).numpy()
    want = np.asarray(jref.pairwise_sq_l2_ref(jnp.asarray(q), jnp.asarray(x)))
    pallas = np.asarray(pairwise_sq_l2_pallas(
        jnp.asarray(q), jnp.asarray(x), bq=64, bn=64, bd=64, interpret=True
    ))
    assert got.dtype == np.float32 and got.shape == (q_n, x_n)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, pallas, rtol=TOL, atol=TOL)
    assert (got >= 0).all()


def test_pairwise_plain_bf16_inputs():
    """bf16 operands upcast to f32 before the expansion, as in the JAX
    oracle: both sides round the same f32 values to bf16 (round to nearest
    even), so the f32 results agree to the f32 tolerance."""
    g = np.random.default_rng(3)
    q = g.normal(size=(65, 33)).astype(np.float32)
    x = g.normal(size=(130, 33)).astype(np.float32)
    got = ref.pairwise_sq_l2_ref(_t(q).bfloat16(), _t(x).bfloat16()).numpy()
    want = np.asarray(jref.pairwise_sq_l2_ref(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16)
    ))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _problem(g, qn, nb, cap, dim, beam, kk, *, pad_frac=0.3, seeded_topk=True):
    """numpy twin of tests/test_bucket_scan.py::_problem."""
    q = g.normal(size=(qn, dim)).astype(np.float32)
    bx = g.normal(size=(nb, cap, dim)).astype(np.float32)
    ids = np.arange(nb * cap, dtype=np.int32).reshape(nb, cap)
    ids = np.where(g.random((nb, cap)) < pad_frac, -1, ids).astype(np.int32)
    bsel = g.integers(0, nb, size=(qn, beam)).astype(np.int32)
    act = g.random((qn, beam)) < 0.75
    if seeded_topk:
        top_d = np.sort(g.random((qn, kk)).astype(np.float32) * 40.0, axis=1)
        top_d[:, kk // 2:] = np.inf
        top_i = np.where(
            np.isinf(top_d), -1, g.integers(10_000, 20_000, (qn, kk))
        ).astype(np.int32)
    else:
        top_d = np.full((qn, kk), np.inf, np.float32)
        top_i = np.full((qn, kk), -1, np.int32)
    return q, bx, ids, bsel, act, top_d, top_i


def _scan_all(args, scale=None):
    """(port plain, JAX ref, Pallas interpret) results of one scan step."""
    q, bx, ids, bsel, act, top_d, top_i = args
    tp = ref.bucket_scan_topk_ref(
        _t(q), _t(bx), _t(ids), _t(bsel), _t(act), _t(top_d), _t(top_i),
        None if scale is None else _t(scale),
    )
    ja = [jnp.asarray(a) for a in args]
    js = None if scale is None else jnp.asarray(scale)
    jr = jref.bucket_scan_topk_ref(*ja, js)
    jp = bucket_scan_topk_pallas(*ja, js, interpret=True)
    port = (tp[0].numpy(), tp[1].numpy())
    return port, tuple(np.asarray(a) for a in jr), tuple(np.asarray(a) for a in jp)


def _ids_achieve_values(q, bx, ids, got_d, got_i, scale=None):
    """Returned ids must achieve the returned distances (tie-tolerant)."""
    flat_x = bx.reshape(-1, bx.shape[-1]).astype(np.float32)
    if scale is not None:
        flat_x = flat_x * scale.reshape(-1)[:, None]
    flat_ids = ids.reshape(-1)
    for qi in range(q.shape[0]):
        for j in range(got_d.shape[1]):
            gid = got_i[qi, j]
            if gid < 0 or gid >= 10_000 or not np.isfinite(got_d[qi, j]):
                continue  # seeded/pad entries carry no coordinates
            rows = flat_x[flat_ids == gid]
            d2 = ((rows - q[qi]) ** 2).sum(-1)
            assert np.any(np.abs(d2 - got_d[qi, j]) < 1e-3), (qi, j, gid)


# (Q, NB, C, D, beam, kk): the sweep of tests/test_bucket_scan.py
SCAN_SHAPES = [
    (4, 7, 5, 6, 3, 4),
    (2, 9, 8, 16, 4, 7),
    (1, 3, 2, 33, 2, 5),
    (5, 6, 4, 8, 6, 11),
]


@pytest.mark.parametrize("qn,nb,cap,dim,beam,kk", SCAN_SHAPES)
def test_bucket_scan_plain_matches_jax(qn, nb, cap, dim, beam, kk):
    g = np.random.default_rng(qn * 100 + nb * 10 + cap)
    args = _problem(g, qn, nb, cap, dim, beam, kk)
    (pd, pi), (rd, ri), (kd, ki) = _scan_all(args)
    np.testing.assert_allclose(pd, rd, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(pd, kd, rtol=TOL, atol=TOL)
    _ids_achieve_values(args[0], args[1], args[2], pd, pi)
    np.testing.assert_array_equal(np.isinf(pd), pi == -1)
    with np.errstate(invalid="ignore"):
        diffs = np.diff(pd, axis=1)
    assert np.all((diffs >= 0) | np.isnan(diffs))


def test_bucket_scan_fewer_than_k_reachable():
    """Heavily padded buckets + sparse activity: inf/-1 tail, ids exact."""
    g = np.random.default_rng(21)
    args = _problem(g, 3, 4, 3, 5, 2, 9, pad_frac=0.8, seeded_topk=False)
    (pd, pi), (rd, ri), (kd, ki) = _scan_all(args)
    np.testing.assert_allclose(pd, rd, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(pd, kd, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_array_equal(pi, ki)
    assert np.isinf(pd).any(), "the case must leave part of the top-k empty"
    np.testing.assert_array_equal(np.isinf(pd), pi == -1)


def test_bucket_scan_dry_pool_keeps_ids_unique():
    """A partly filled top-k and a step with no live candidate: the merge
    must not re-emit an extracted id once the pool runs dry."""
    g = np.random.default_rng(22)
    qn, nb, cap, dim, beam = 2, 3, 4, 5, 2
    q = g.normal(size=(qn, dim)).astype(np.float32)
    bx = g.normal(size=(nb, cap, dim)).astype(np.float32)
    ids = np.full((nb, cap), -1, np.int32)  # every member is padding
    bsel = g.integers(0, nb, size=(qn, beam)).astype(np.int32)
    act = np.zeros((qn, beam), bool)  # ...and nothing is active anyway
    top_d = np.array([[1.0, 2.5, np.inf, np.inf, np.inf]] * qn, np.float32)
    top_i = np.array([[42, 7, -1, -1, -1]] * qn, np.int32)
    (pd, pi), (rd, ri), (kd, ki) = _scan_all((q, bx, ids, bsel, act, top_d, top_i))
    np.testing.assert_array_equal(pd, top_d)
    np.testing.assert_array_equal(pi, top_i)
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_array_equal(pi, ki)


def test_bucket_scan_duplicate_distances_ids_exact():
    """Exactly tied candidates (one member row copied across buckets): each
    implementation computes the same d2 for every copy, and the lower
    position wins the tie, so the ids agree exactly."""
    g = np.random.default_rng(23)
    qn, nb, cap, dim, beam, kk = 3, 5, 4, 6, 3, 6
    q = g.normal(size=(qn, dim)).astype(np.float32)
    row = g.normal(size=(dim,)).astype(np.float32)
    bx = np.broadcast_to(row, (nb, cap, dim)).copy()
    bx[2:] = g.normal(size=(nb - 2, cap, dim))
    ids = np.arange(nb * cap, dtype=np.int32).reshape(nb, cap)
    bsel = np.array([[0, 1, 2], [1, 0, 3], [0, 0, 4]], np.int32)
    act = np.ones((qn, beam), bool)
    top_d = np.full((qn, kk), np.inf, np.float32)
    top_i = np.full((qn, kk), -1, np.int32)
    (pd, pi), (rd, ri), (kd, ki) = _scan_all((q, bx, ids, bsel, act, top_d, top_i))
    np.testing.assert_allclose(pd, rd, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(pd, kd, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_array_equal(pi, ki)
    assert (np.diff(pd, axis=1) == 0).any(), "the case must hold exact ties"


def test_bucket_scan_int8_matches_jax():
    g = np.random.default_rng(24)
    qn, nb, cap, dim, beam, kk = 4, 6, 5, 12, 3, 6
    q, bx, ids, bsel, act, top_d, top_i = _problem(g, qn, nb, cap, dim, beam, kk)
    xq, scale = ops.quantize_datastore(_t(bx.reshape(nb * cap, dim)))
    bxq = xq.numpy().reshape(nb, cap, dim)
    bscale = scale.numpy().reshape(nb, cap)
    (pd, pi), (rd, ri), (kd, ki) = _scan_all(
        (q, bxq, ids, bsel, act, top_d, top_i), bscale
    )
    np.testing.assert_allclose(pd, rd, rtol=TOL_INT8, atol=TOL_INT8)
    np.testing.assert_allclose(pd, kd, rtol=TOL_INT8, atol=TOL_INT8)
    _ids_achieve_values(q, bxq, ids, pd, pi, bscale)


@pytest.mark.parametrize("rows", ["normal", "grid"])
def test_pairwise_int8_width_900_matches_jax(rows):
    """K7's plain version at D = 900, not a multiple of the kernel's 16-byte
    copy or 32-feature stage, on rows that start one byte off alignment:
    quantized normal rows agree with the JAX reference and the interpret-mode
    Pallas kernel to ``TOL_INT8``; grid queries with power-of-two scales
    (an exact expansion) equal the JAX reference bit for bit."""
    g = np.random.default_rng(900 + len(rows))
    qn, n, d = 9, 37, 900
    if rows == "normal":
        q = g.normal(size=(qn, d)).astype(np.float32)
        jq, js = j_quantize(jnp.asarray(g.normal(size=(n, d)).astype(np.float32)))
        xq, s = np.array(jq), np.array(js)
    else:
        q = (g.integers(-16, 17, size=(qn, d)) / 8).astype(np.float32)
        xq = g.integers(-127, 128, size=(n, d)).astype(np.int8)
        s = (2.0 ** -g.integers(4, 8, size=n)).astype(np.float32)
    buf = torch.empty(n * d + 1, dtype=torch.int8)
    buf[1:] = _t(xq.reshape(-1))
    txq = buf[1:].view(n, d)  # a contiguous view one byte into its storage
    got = ops.pairwise_sq_l2_int8(_t(q), txq, _t(s)).numpy()
    want = np.asarray(jref.pairwise_sq_l2_int8_ref(jnp.asarray(q), jnp.asarray(xq),
                                                   jnp.asarray(s)))
    assert got.shape == (qn, n) and got.dtype == np.float32
    if rows == "grid":
        np.testing.assert_array_equal(got, want)
        return
    pallas = np.asarray(pairwise_sq_l2_int8_pallas(
        jnp.asarray(q), jnp.asarray(xq), jnp.asarray(s), bq=16, bn=32, bd=64, interpret=True))
    np.testing.assert_allclose(got, want, rtol=TOL_INT8, atol=TOL_INT8)
    np.testing.assert_allclose(got, pallas, rtol=TOL_INT8, atol=TOL_INT8)


@pytest.mark.parametrize("shape", [(40, 7), (130, 20), (9, 5)])
def test_quantize_datastore_bitwise(shape):
    """Same int8 rows and scales as the JAX package, bit for bit (both round
    half to even); the rows include exact halves and an all-zero row."""
    g = np.random.default_rng(shape[0])
    x = (g.normal(size=shape) * 3).astype(np.float32)
    x[0] = 0.0
    x[1, :] = np.arange(shape[1], dtype=np.float32) - 2.5
    tq, ts = ops.quantize_datastore(_t(x))
    jq, js = j_quantize(jnp.asarray(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.int32), np.asarray(js).view(np.int32))


def test_dispatch_on_cpu_runs_plain_and_counts_nothing():
    """A CPU tensor takes the plain version; no kernel launch is counted."""
    g = np.random.default_rng(5)
    q, x = _t(g.normal(size=(8, 5)).astype(np.float32)), _t(g.normal(size=(9, 5)).astype(np.float32))
    ops.reset_launch_counts()
    np.testing.assert_array_equal(
        ops.pairwise_sq_l2(q, x).numpy(), ref.pairwise_sq_l2_ref(q, x).numpy()
    )
    p = _phase_problem(g, 3, 4, 5, 5, 2, 3)
    got = ops.bucket_scan_phase(*_phase_args(p))
    want = ref.bucket_scan_phase_ref(*_phase_args(p))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert ops.launch_counts() == {
        "pairwise_sq_l2": 0, "bucket_scan_topk": 0,
        "eps_count": 0, "eps_min_label": 0, "eps_nearest_core": 0,
        "knn_topk": 0, "pairwise_sq_l2_int8": 0,
    }


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers launch or raise: a CPU tensor is refused, never run
    through a plain fallback."""
    q = torch.zeros((2, 3))
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        pairwise_sq_l2_cuda(q, q)
    with pytest.raises(ValueError, match="CUDA"):
        bucket_scan_phase_cuda(
            q, torch.zeros((1, 2, 3)), torch.zeros((1, 2), dtype=torch.int32),
            torch.ones((1,), dtype=torch.int32), torch.zeros((2, 1), dtype=torch.int32),
            torch.zeros((2, 1)), 1, torch.full((2, 1), float("inf")),
            torch.full((2, 1), -1, dtype=torch.int32),
        )
    assert ops.launch_counts() == before


# --- K1 as one phase: the kernel's control flow against the lockstep loop ----
#
# Rows on a 1/8 grid (int8 rows: integers with a power-of-two scale) keep
# every product and partial sum of the expansion exact in f32, so every
# formulation below must agree bit for bit.


def _phase_problem(g, qn, nb, cap, dim, beam, kk, *, pad_frac=0.3, inf_frac=0.2,
                   seeded=False, int8=False):
    """A scan phase: grid queries and buckets, per-bucket lower bounds with a
    share of ineligible (+inf) rows, sorted and padded to a beam multiple by
    the search's own ``_sorted_bounds``."""
    from repro_torch.core.knn import _sorted_bounds

    q = (g.integers(-16, 17, size=(qn, dim)) / 8).astype(np.float32)
    scale = None
    if int8:
        xq = g.integers(-127, 128, size=(nb, cap, dim)).astype(np.int8)
        scale = np.full((nb, cap), 0.125, np.float32)
        bx = xq
    else:
        bx = (g.integers(-16, 17, size=(nb, cap, dim)) / 8).astype(np.float32)
    ids = np.arange(nb * cap, dtype=np.int32).reshape(nb, cap)
    ids = np.where(g.random((nb, cap)) < pad_frac, -1, ids).astype(np.int32)
    count = (ids >= 0).sum(1).astype(np.int32)
    typical = 1.5 * np.sqrt(dim) * (8.0 if int8 else 1.0)
    lb = (g.random((qn, nb)) * typical).astype(np.float32)
    lb[g.random((qn, nb)) < inf_frac] = np.inf
    order, lb_sorted, _ = _sorted_bounds(_t(lb), beam)
    if seeded:
        top_d = np.sort((g.integers(0, 64, (qn, kk)) / 8).astype(np.float32) * 4, axis=1)
        top_d[:, kk // 2:] = np.inf
        top_i = np.where(np.isinf(top_d), -1, g.integers(10**6, 2 * 10**6, (qn, kk)))
    else:
        top_d = np.full((qn, kk), np.inf, np.float32)
        top_i = np.full((qn, kk), -1)
    return dict(q=q, bx=bx, ids=ids, count=count, order=order.numpy(),
                lb=lb_sorted.numpy(), beam=beam, top_d=top_d,
                top_i=top_i.astype(np.int32), scale=scale)


def _phase_args(p):
    """The problem as the arguments of ``ops.bucket_scan_phase``."""
    return (_t(p["q"]), _t(p["bx"]), _t(p["ids"]), _t(p["count"]), _t(p["order"]),
            _t(p["lb"]), p["beam"], _t(p["top_d"]), _t(p["top_i"]),
            None if p["scale"] is None else _t(p["scale"]))


def _extent(ids):
    """One past each bucket's last live row, 0 for an empty bucket."""
    live = ids >= 0
    return np.where(live.any(1), ids.shape[1] - np.argmax(live[:, ::-1], axis=1), 0).astype(np.int32)


def _walk_alone(p, rows):
    """Plain emulation of the phase kernel's control flow: each query walks
    its own steps until its first inactive one, deciding every slot of a
    step from the kth at the step's start, scoring each active bucket's rows
    [0, extent) in tiles of ``rows`` members (holes below the extent stay
    and score nothing), dropping candidates not below the kth at the tile's
    start, and inserting the survivors in member order, each after every
    equal value.  The fifth counter row is the rows staged: the extents of
    the active in-range slots."""
    q, ids, count, order, lb, beam = (p[k] for k in ("q", "ids", "count", "order", "lb", "beam"))
    ext = p["ext"] if p.get("ext") is not None else _extent(ids)
    bx = p["bx"].astype(np.float32)
    if p["scale"] is not None:
        bx = bx * p["scale"][..., None]
    tq, tx = _t(q), _t(bx)
    d2_all = torch.clamp_min(  # the plain version's arithmetic, every (query, bucket, member)
        torch.sum(tq * tq, dim=-1)[:, None, None] + torch.sum(tx * tx, dim=-1)[None]
        - 2.0 * torch.einsum("bcd,qd->qbc", tx, tq), 0.0).numpy()
    nb, cap = ids.shape
    qn, kk = p["top_d"].shape
    n_steps = order.shape[1] // beam
    out_d, out_i = p["top_d"].copy(), p["top_i"].copy()
    counters = np.zeros((5, qn), np.int32)  # visits, ndist, npad, qsteps, staged
    for qi in range(qn):
        tv, ti = list(out_d[qi]), list(out_i[qi])
        for t in range(n_steps):
            kth = np.sqrt(np.float32(tv[-1]))
            slots = range(t * beam, (t + 1) * beam)
            act = [s for s in slots if lb[qi, s] <= kth]
            if not act:
                break
            counters[0, qi] += len(act)
            counters[3, qi] += 1
            for s in act:
                b = order[qi, s]
                if not 0 <= b < nb:
                    continue
                counters[1, qi] += count[b]
                counters[4, qi] += ext[b]
                for c0 in range(0, ext[b], rows):
                    kth2 = tv[-1]
                    surv = [(d2_all[qi, b, m], ids[b, m]) for m in range(c0, min(ext[b], c0 + rows))
                            if ids[b, m] >= 0 and d2_all[qi, b, m] < kth2]
                    for v, i in surv:
                        if v < tv[-1]:
                            pos = sum(1 for w in tv if w <= v)
                            tv.insert(pos, v)
                            ti.insert(pos, i)
                            del tv[-1], ti[-1]
        out_d[qi], out_i[qi] = tv, ti
        counters[2, qi] = counters[0, qi] * cap
    return out_d, out_i, counters


def _assert_walk_equals_lockstep(p, rows):
    """The walk against the plain phase, and the plain phase given the
    extents (``extent=``, ``staged=``) against the one without: bit for bit
    in all six outputs.  The staged rows of the walk and of the plain phase
    both equal the extents summed over each query's visited slots (a prefix
    of its order, ``visits`` long)."""
    want = ref.bucket_scan_phase_ref(*_phase_args(p))
    got_d, got_i, counters = _walk_alone(p, rows)
    np.testing.assert_array_equal(got_d.view(np.int32), want[0].numpy().view(np.int32))
    np.testing.assert_array_equal(got_i, want[1].numpy())
    for j, name in enumerate(("visits", "ndist", "npad", "qsteps")):
        np.testing.assert_array_equal(counters[j], want[2 + j].numpy(), err_msg=name)
    ext = p["ext"] if p.get("ext") is not None else _extent(p["ids"])
    staged = torch.zeros(len(p["q"]), dtype=torch.int32)
    with_ext = ref.bucket_scan_phase_ref(*_phase_args(p), extent=_t(ext), staged=staged)
    for name, a, b in zip(("top_d", "top_i", "visits", "ndist", "npad", "qsteps"), with_ext, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    nb = len(ext)
    visited = [[b for b in p["order"][qi, :v] if 0 <= b < nb]
               for qi, v in enumerate(want[2].numpy())]
    np.testing.assert_array_equal(staged.numpy(), [int(ext[v].sum()) for v in visited])
    np.testing.assert_array_equal(counters[4], staged.numpy())
    return want


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("beam", [1, 3, 4])
def test_phase_walk_alone_equals_lockstep(beam, int8):
    """Random forests (13 buckets: a beam of 3 or 4 leaves pad slots), empty
    and seeded carries, buckets scored in tiles of 3 members."""
    for seed in range(4):
        g = np.random.default_rng(100 * beam + 10 * int8 + seed)
        p = _phase_problem(g, 6, 13, 7, 4, beam, 5, seeded=bool(seed % 2), int8=int8)
        want = _assert_walk_equals_lockstep(p, rows=3)
        steps = int(want[5].max())
        assert 0 < steps <= p["order"].shape[1] // beam


@pytest.mark.parametrize("over", [False, True], ids=["extent", "capacity"])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("beam", [1, 3])
def test_phase_walk_alone_packed_buckets(beam, int8, over):
    """Buckets whose live members are a prefix, as the forests keep them, of
    0, 1, rows, rows + 1 and C members, scored in tiles of ``rows``: a bucket
    of extent 0 is visited and counted but stages nothing.  An extent past
    the last live row (``capacity``: C for every bucket) changes nothing but
    the rows staged, which then equal ``npad``."""
    rows, cap = 3, 7
    for seed in range(3):
        g = np.random.default_rng(1000 + 100 * beam + 10 * int8 + seed)
        p = _phase_problem(g, 6, 10, cap, 4, beam, 5, pad_frac=0.0, seeded=bool(seed % 2),
                           int8=int8)
        live = np.array([0, 1, rows, rows + 1, cap] * 2, np.int32)
        p["ids"][np.arange(cap)[None, :] >= live[:, None]] = -1
        p["count"] = live.copy()
        p["ext"] = np.full_like(live, cap) if over else live
        want = _assert_walk_equals_lockstep(p, rows)
        assert int(want[5].max()) > 0
        if over:
            staged = torch.zeros(6, dtype=torch.int32)
            ref.bucket_scan_phase_ref(*_phase_args(p), extent=_t(p["ext"]), staged=staged)
            assert torch.equal(staged, want[4])


def test_k1_extent_is_derived_once_per_ids_tensor():
    """The kernel wrapper derives a datastore's extents once and keeps them
    while its ids are unchanged: an in-place write derives them anew."""
    from repro_torch.kernels.bucket_scan import _extent

    ids = torch.tensor([[0, -1, 2, -1], [-1, -1, -1, -1], [5, 6, 7, 8]], dtype=torch.int32)
    first = _extent(ids)
    assert first.tolist() == [3, 0, 4] and _extent(ids) is first
    assert torch.equal(first, ref.bucket_extent(ids))
    ids[1, 0] = 9
    assert _extent(ids).tolist() == [3, 1, 4]


def test_phase_walk_alone_unfilled_topk_pad_slots():
    """Fewer than kk members reachable: kth stays +inf, so every slot is
    active to the end, the +inf-bound rows and the pad slots included (a pad
    slot re-scans bucket 0, as in the reference)."""
    g = np.random.default_rng(7)
    p = _phase_problem(g, 4, 5, 3, 3, 4, 40, pad_frac=0.5)
    want = _assert_walk_equals_lockstep(p, rows=2)
    n_slots = p["order"].shape[1]
    assert (want[5].numpy() == n_slots // 4).all()
    assert (want[2].numpy() == n_slots).all()  # every slot visited, pads too
    assert np.isinf(want[0].numpy()).any()


def test_phase_walk_alone_ties_across_slots():
    """One member row copied into every bucket: exact ties across the slots
    of a step and across steps; the lower position wins each."""
    g = np.random.default_rng(8)
    p = _phase_problem(g, 5, 6, 4, 5, 3, 7, pad_frac=0.0, inf_frac=0.0)
    p["bx"][:] = p["bx"][0, 0]
    want = _assert_walk_equals_lockstep(p, rows=4)
    assert (np.diff(want[0].numpy(), axis=1) == 0).all()


def test_phase_all_slots_inactive_at_step_0():
    """A seeded carry whose kth is below every bound: no step runs, the
    carry comes back unchanged and every counter is 0."""
    g = np.random.default_rng(9)
    p = _phase_problem(g, 3, 6, 4, 4, 2, 5, inf_frac=0.0)
    p["lb"] = p["lb"] + 1.0
    p["top_d"] = np.full_like(p["top_d"], 0.25)
    p["top_i"] = np.arange(p["top_i"].size, dtype=np.int32).reshape(p["top_i"].shape)
    want = _assert_walk_equals_lockstep(p, rows=4)
    np.testing.assert_array_equal(want[0].numpy(), p["top_d"])
    np.testing.assert_array_equal(want[1].numpy(), p["top_i"])
    assert all(int(c.abs().sum()) == 0 for c in want[2:])
