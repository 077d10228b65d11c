"""The port's plain K6 (``knn_topk_ref``) and K7 (``pairwise_sq_l2_int8_ref``)
against the JAX package.

Each case feeds the same numpy-seeded inputs to the port's plain version, to
``repro.kernels.ref`` and to the Pallas kernel in interpret mode at the
small blocks ``tests/test_kernels_pairwise.py`` uses.  On a CPU tensor the
port's dispatch layer runs the plain version, so these tests hold the
arithmetic the CUDA kernels are held to on the card (``test_torch_cuda.py``,
``chip_smoke.py``).

Tolerances: squared distances agree to ``rtol = atol = 1e-5`` on unit-scale
f32 data (the implementations sum ||q||^2, ||x||^2 and q.x in different
orders; at these magnitudes the rounding is ~1e-6) and ``1e-4`` against
int8 rows (dequantized magnitudes up to 127 * scale carry larger sums).
Ids are compared exactly where ties are pinned (duplicated rows, rows on a
1/8 grid where the expansion is exact), and by the distance they achieve
elsewhere.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ops import quantize_datastore as j_quantize
from repro.kernels.pairwise_l2 import pairwise_sq_l2_int8_pallas
from repro.kernels.topk import knn_topk_pallas
from repro_torch.kernels import ops, ref

TOL = 1e-5
TOL_INT8 = 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _grid(g, n, d):
    """Rows on a 1/8 grid in [-2, 2]: every product and partial sum of the
    expansion is exact in f32, so exact ties are real ties everywhere."""
    return (g.integers(-16, 17, size=(n, d)) / 8).astype(np.float32)


@pytest.mark.parametrize("q_n,x_n,d", [(16, 100, 24), (33, 257, 48), (5, 70, 13),
                                       (40, 300, 20)])  # Q = 40: the card's tiled shape
@pytest.mark.parametrize("k", [1, 5, 16])
def test_knn_topk_plain_matches_jax(q_n, x_n, d, k):
    g = np.random.default_rng(q_n * 31 + x_n + k)
    q = g.normal(size=(q_n, d)).astype(np.float32)
    x = g.normal(size=(x_n, d)).astype(np.float32)
    tv, ti = ref.knn_topk_ref(_t(q), _t(x), k)
    assert tv.dtype == torch.float32 and ti.dtype == torch.int32
    pv, pi = knn_topk_pallas(jnp.asarray(q), jnp.asarray(x), k=k, bq=16, bn=64, interpret=True)
    rv, ri = jref.knn_topk_ref(jnp.asarray(q), jnp.asarray(x), k)
    for v in (pv, rv):
        np.testing.assert_allclose(tv.numpy(), np.asarray(v), rtol=TOL, atol=TOL)
    # the port's ids achieve its distances (ties allowed at this scale)
    d2 = np.asarray(jref.pairwise_sq_l2_ref(jnp.asarray(q), jnp.asarray(x)))
    np.testing.assert_allclose(d2[np.arange(q_n)[:, None], ti.numpy()], tv.numpy(),
                               rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))


@pytest.mark.parametrize("k", [1, 5, 16])
def test_knn_topk_ties_go_to_the_lower_row(k):
    """Duplicated rows on a 1/8 grid (exact distances): the lower row comes
    first, in the port, the interpret-mode kernel and ``lax.top_k``."""
    g = np.random.default_rng(k)
    x = _grid(g, 90, 12)
    x[60:80] = x[3:23]  # every row of 3..22 has a twin 57 rows later
    q = np.concatenate([x[3:9], _grid(g, 4, 12)])
    tv, ti = ref.knn_topk_ref(_t(q), _t(x), k)
    pv, pi = knn_topk_pallas(jnp.asarray(q), jnp.asarray(x), k=k, bq=16, bn=32, interpret=True)
    rv, ri = jref.knn_topk_ref(jnp.asarray(q), jnp.asarray(x), k)
    for v, i in ((pv, pi), (rv, ri)):
        np.testing.assert_array_equal(tv.numpy(), np.asarray(v))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(i))
    assert (ti.numpy()[:6, 0] == np.arange(3, 9)).all()  # the twin (row + 57) loses
    if k > 1:
        assert (ti.numpy()[:6, 1] == np.arange(60, 66)).all()


def test_knn_topk_fewer_rows_than_k():
    """N < k: the tail is +inf with id -1, as the Pallas kernel returns."""
    g = np.random.default_rng(0)
    q = g.normal(size=(4, 8)).astype(np.float32)
    x = g.normal(size=(3, 8)).astype(np.float32)
    tv, ti = ref.knn_topk_ref(_t(q), _t(x), 8)
    pv, pi = knn_topk_pallas(jnp.asarray(q), jnp.asarray(x), k=8, bq=16, bn=16, interpret=True)
    np.testing.assert_allclose(tv.numpy(), np.asarray(pv), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(pi))
    assert np.isinf(tv.numpy()[:, 3:]).all() and (ti.numpy()[:, 3:] == -1).all()


@pytest.mark.parametrize("q_n,x_n,d", [(16, 64, 32), (40, 130, 20), (7, 65, 13), (9, 33, 100)])
def test_pairwise_int8_plain_matches_jax(q_n, x_n, d):
    g = np.random.default_rng(q_n + x_n + d)
    q = g.normal(size=(q_n, d)).astype(np.float32)
    x = g.normal(size=(x_n, d)).astype(np.float32)
    xq, s = ops.quantize_datastore(_t(x))
    jq, js = j_quantize(jnp.asarray(x))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jq))
    got = ref.pairwise_sq_l2_int8_ref(_t(q), xq, s)
    for want in (
        pairwise_sq_l2_int8_pallas(jnp.asarray(q), jq, js, bq=32, bn=32, bd=32, interpret=True),
        jref.pairwise_sq_l2_int8_ref(jnp.asarray(q), jq, js),
    ):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL_INT8, atol=TOL_INT8)


def test_pairwise_int8_exact_on_power_of_two_scales():
    """Grid queries, int8 rows and power-of-two scales: the dequantized rows
    and the whole expansion are exact, so the port equals the JAX reference
    bit for bit, and so does the stable selection after it (exact ties from
    duplicated rows go to the lower row)."""
    g = np.random.default_rng(3)
    q = _grid(g, 6, 20)
    xq = g.integers(-127, 128, size=(50, 20)).astype(np.int8)
    xq[30:40] = xq[5:15]
    s = (2.0 ** -g.integers(4, 8, size=50)).astype(np.float32)
    s[30:40] = s[5:15]
    got = ref.pairwise_sq_l2_int8_ref(_t(q), _t(xq), _t(s))
    want = np.asarray(jref.pairwise_sq_l2_int8_ref(jnp.asarray(q), jnp.asarray(xq), jnp.asarray(s)))
    np.testing.assert_array_equal(got.numpy(), want)
    vals, idx = ref.topk_smallest(got, 16)
    neg, jidx = jax.lax.top_k(-jnp.asarray(want), 16)
    np.testing.assert_array_equal(vals.numpy(), -np.asarray(neg))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


def test_dispatch_on_cpu_runs_the_plain_versions():
    g = np.random.default_rng(9)
    q, x = _t(g.normal(size=(3, 6)).astype(np.float32)), _t(g.normal(size=(11, 6)).astype(np.float32))
    before = ops.launch_counts()
    kv, ki = ops.knn_topk(q, x, k=4)
    rv, ri = ref.knn_topk_ref(q, x, 4)
    assert torch.equal(kv, rv) and torch.equal(ki, ri)
    xq, s = ops.quantize_datastore(x)
    assert torch.equal(ops.pairwise_sq_l2_int8(q, xq, s), ref.pairwise_sq_l2_int8_ref(q, xq, s))
    assert ops.launch_counts() == before
