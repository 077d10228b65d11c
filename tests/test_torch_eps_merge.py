"""K3-K5's chunked merge, emulated on the CPU with the plain versions.

On the card K3 (``eps_count``) splits all N columns into chunks of
``eps_graph.CHUNK`` over the grid and adds the chunks' counts; K4 (``eps_min_label``) and K5 (``eps_nearest_core``) compute only
the core columns, compacted in ascending index order
(``eps_graph.compact_core``), split them into chunks of ``eps_graph.CHUNK``
columns over the grid, and merge the chunks by an atomic min: K4 on the
label, K5 on the 64-bit key ``eps_graph.pack_nearest`` makes of (d2, compact
index), mapped back by ``eps_graph.unpack_nearest``.  Those helpers are plain
torch, so here each chunk runs through ``ref.eps_*_ref`` on the compacted
operands, the results are packed and min-merged chunk by chunk, and the
merged result must equal the plain version on the full operands, and the JAX
package's Pallas kernels in interpret mode, exactly.

Rows sit on a 1/8 grid: every sum of the expansion is exact in f32 in any
order, so d2 ties and pairs on the threshold really occur and equality is
exact, d2 included.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.pairwise_l2 import (
    eps_count_pallas,
    eps_min_label_pallas,
    eps_nearest_core_pallas,
)
from repro_torch.kernels import ref
from repro_torch.kernels.eps_graph import (
    CHUNK,
    NO_KEY,
    compact_core,
    pack_nearest,
    unpack_nearest,
)


def _grid(g, n, d):
    return torch.from_numpy((g.integers(-16, 17, size=(n, d)) / 8).astype(np.float32))


def chunked_count(q, x, eps_sq, chunk):
    """K3's merge: per chunk of columns the plain count, summed from 0."""
    out = torch.zeros((q.shape[0],), dtype=torch.int32)
    for lo in range(0, x.shape[0], chunk):
        out += ref.eps_count_ref(q, x[lo:lo + chunk], eps_sq)
    return out


def chunked_min_label(q, x, labels, core, eps_sq, chunk):
    """K4's merge: per chunk of compacted core columns the plain min label,
    then the min over chunks from the sentinel N.  The plain version's own
    sentinel is the chunk's length, so the labels go in shifted below 0 and a
    chunk with a hit is told apart from one without."""
    n = x.shape[0]
    x_core, lab_core = compact_core(x, labels, core)
    out = torch.full((q.shape[0],), n, dtype=torch.int32)
    for lo in range(0, x_core.shape[0], chunk):
        xc, lc = x_core[lo:lo + chunk], lab_core[lo:lo + chunk].long()
        part = ref.eps_min_label_ref(q, xc, lc - n - 1, torch.ones(len(xc), dtype=torch.bool),
                                     eps_sq).long()
        out = torch.minimum(out, torch.where(part < 0, part + n + 1, n).to(torch.int32))
    return out


def chunked_nearest_core(q, x, labels, core, chunk):
    """K5's merge: per chunk the plain nearest column, its compact index
    (passed as the label) packed with its d2, the min key over chunks, then
    the unpack to (d2, label)."""
    x_core, lab_core = compact_core(x, labels, core)
    keys = torch.full((q.shape[0],), NO_KEY, dtype=torch.int64)
    for lo in range(0, x_core.shape[0], chunk):
        xc = x_core[lo:lo + chunk]
        j = torch.arange(lo, lo + len(xc), dtype=torch.int32)
        d2, jj = ref.eps_nearest_core_ref(q, xc, j, torch.ones(len(xc), dtype=torch.bool))
        keys = torch.minimum(keys, pack_nearest(d2, jj))
    return unpack_nearest(keys, lab_core, x.shape[0])


def _assert_merge_exact(q, x, labels, core, eps_sq, chunk):
    got_l = chunked_min_label(q, x, labels, core, eps_sq, chunk)
    got_d, got_n = chunked_nearest_core(q, x, labels, core, chunk)
    want_l = ref.eps_min_label_ref(q, x, labels, core, eps_sq)
    want_d, want_n = ref.eps_nearest_core_ref(q, x, labels, core)
    assert got_l.dtype == want_l.dtype == torch.int32 and torch.equal(got_l, want_l)
    assert got_n.dtype == want_n.dtype == torch.int32 and torch.equal(got_n, want_n)
    assert got_d.dtype == torch.float32 and torch.equal(got_d, want_d)
    return got_l, got_d, got_n


@pytest.mark.parametrize("d", [1, 5, 20, 33])
@pytest.mark.parametrize("chunk", [5, 64, CHUNK])
@pytest.mark.parametrize("cores", ["some", "all", "none"])
def test_chunked_merge_matches_plain(d, chunk, cores):
    """Random grid rows, N = 3 chunks + 5 (not a multiple of the chunk), the
    threshold on a data value; some, all or no rows core."""
    g = np.random.default_rng(100 * d + chunk % 97)
    n = 3 * chunk + 5
    q, x = _grid(g, 16, d), _grid(g, n, d)
    labels = torch.from_numpy(g.integers(0, n, n).astype(np.int32))
    core = {"some": torch.from_numpy(g.random(n) < 0.5),
            "all": torch.ones(n, dtype=torch.bool),
            "none": torch.zeros(n, dtype=torch.bool)}[cores]
    eps_sq = float(ref.pairwise_sq_l2_ref(q, x).flatten().median())
    lab, dmin, near = _assert_merge_exact(q, x, labels, core, eps_sq, chunk)
    if cores == "none":
        assert (lab == n).all() and torch.isinf(dmin).all() and (near == n).all()
    else:
        assert torch.isfinite(dmin).all()


@pytest.mark.parametrize("chunk", [3, 64, CHUNK])
def test_chunked_merge_ties_across_chunks(chunk):
    """Rows at d2 = 1 from the queries at compact positions in three
    different chunks, and a non-core row tied ahead of all of them: K5 must
    return the first tied core row, K4 the min label over the tied rows; a
    query with no core row within eps gets the sentinel N."""
    d, n = 5, 3 * chunk + 2
    g = np.random.default_rng(chunk)
    x = 40.0 + _grid(g, n, d)
    unit = torch.eye(d)
    tied = [1, chunk + 1, 2 * chunk + 1]  # compact positions 0, chunk, 2 chunk
    x[0], x[tied[0]], x[tied[1]], x[tied[2]] = unit[2], unit[0], -unit[0], unit[1]
    core = torch.ones(n, dtype=torch.bool)
    core[0] = False  # the earliest tied row is not core
    labels = torch.arange(n, 0, -1, dtype=torch.int32)  # later rows smaller
    q = torch.zeros((3, d))
    q[2] = -3.0  # no core row within eps
    x_core, _ = compact_core(x, labels, core)
    pos = [t - 1 for t in tied]
    assert [p // chunk for p in pos] == [0, 1, 2] and torch.equal(x_core[pos[1]], -unit[0])
    lab, dmin, near = _assert_merge_exact(q, x, labels, core, 1.0, chunk)
    assert near[:2].tolist() == [int(labels[tied[0]])] * 2 and dmin[:2].tolist() == [1.0, 1.0]
    assert lab.tolist() == [int(labels[tied[2]])] * 2 + [n]


@pytest.mark.parametrize("d", [1, 5, 20, 33])
def test_chunked_merge_matches_jax_pallas(d):
    """Small grid inputs through the emulated merge (chunks of 7) and the JAX
    package's Pallas kernels in interpret mode: labels and d2 exactly equal."""
    g = np.random.default_rng(d)
    n = 45
    q, x = _grid(g, 20, d), _grid(g, n, d)
    labels = torch.from_numpy(g.permutation(n).astype(np.int32))
    core = torch.from_numpy(g.random(n) < 0.5)
    x[n - 1] = x[3]  # an exact tie in another chunk
    core[3] = core[n - 1] = True
    eps_sq = float(ref.pairwise_sq_l2_ref(q, x).flatten().median())
    got_l = chunked_min_label(q, x, labels, core, eps_sq, 7)
    got_d, got_n = chunked_nearest_core(q, x, labels, core, 7)
    jq, jx, jl, jc = (jnp.asarray(t.numpy()) for t in (q, x, labels, core))
    kw = dict(bq=32, bn=32, interpret=True)
    want_l = eps_min_label_pallas(jq, jx, jl, jc, jnp.float32(eps_sq), **kw)
    want_d, want_n = eps_nearest_core_pallas(jq, jx, jl, jc, **kw)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))


def test_pack_nearest_orders_as_d2_then_index():
    """The key's order is (d2, index) lexicographic over +0, subnormal, exact
    ties and large finite d2, +inf packs to NO_KEY, and the unpack returns
    each d2 bit for bit with its column's label."""
    d2 = torch.tensor([3.5, 0.0, 1e-45, 3.5, 3.4e38, float("inf"), 0.0, 1.0])
    j = torch.tensor([9, 4, 2, 1, 0, 5, 7, 2**31 - 1])
    keys = pack_nearest(d2, j)
    assert keys[5] == NO_KEY and bool((keys[torch.arange(8) != 5] < NO_KEY).all())
    order = sorted(range(8), key=lambda i: (float(d2[i]), int(j[i])))
    assert torch.argsort(keys, stable=True).tolist() == order
    lab_core = torch.arange(100, 108, dtype=torch.int32)
    keys = pack_nearest(d2, torch.arange(8))
    back_d, back_l = unpack_nearest(keys, lab_core, 77)
    assert torch.equal(back_d.view(torch.int32), d2.view(torch.int32))
    assert back_l.tolist() == [100, 101, 102, 103, 104, 77, 106, 107]


def test_compact_core_keeps_row_order():
    """The compacted columns are the core rows in ascending index order, with
    their labels; no core row gives empty operands."""
    x = torch.arange(24, dtype=torch.float32).reshape(8, 3)
    labels = torch.arange(80, 88, dtype=torch.int32)
    core = torch.tensor([0, 1, 1, 0, 0, 1, 0, 1], dtype=torch.uint8)
    xc, lc = compact_core(x, labels, core)
    assert torch.equal(xc, x[[1, 2, 5, 7]]) and lc.tolist() == [81, 82, 85, 87]
    xc, lc = compact_core(x, labels, torch.zeros(8, dtype=torch.bool))
    assert xc.shape == (0, 3) and lc.shape == (0,)


@pytest.mark.parametrize("d", [5, 20])
def test_chunked_count_matches_plain_and_jax(d):
    """K3's merge over chunks of ``CHUNK`` columns, N = 2 CHUNK + 5: rows
    exactly on the threshold on both sides of each chunk edge, and exact d2
    ties (a query's duplicate rows in different chunks); the summed counts
    equal the plain version on the full operands and the JAX package's
    Pallas kernel in interpret mode exactly."""
    g = np.random.default_rng(d + 40)
    n = 2 * CHUNK + 5
    q, x = _grid(g, 12, d), _grid(g, n, d)
    unit = torch.eye(d)
    edges = [CHUNK - 1, CHUNK, 2 * CHUNK - 1, 2 * CHUNK, n - 1]
    for k, row in enumerate(edges):
        x[row] = q[0] + unit[k % d]  # d2 = 1 from query 0, exactly
    x[CHUNK + 7] = x[CHUNK - 1]  # a tie on the threshold across the first edge
    eps_sq = 1.0
    d2 = ref.pairwise_sq_l2_ref(q, x)
    assert bool((d2[0, edges + [CHUNK + 7]] == eps_sq).all())
    got = chunked_count(q, x, eps_sq, CHUNK)
    want = ref.eps_count_ref(q, x, eps_sq)
    assert got.dtype == want.dtype == torch.int32 and torch.equal(got, want)
    assert int(got[0]) >= len(edges) + 1
    jax_counts = eps_count_pallas(jnp.asarray(q.numpy()), jnp.asarray(x.numpy()),
                                  jnp.float32(eps_sq), bq=16, bn=1024, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_counts))
