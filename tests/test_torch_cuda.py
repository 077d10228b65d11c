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
from repro_torch.kernels.bucket_scan import bucket_scan_topk_cuda
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


def _problem(g, qn, nb, cap, dim, beam, kk, pad_frac=0.3):
    q = g.normal(size=(qn, dim)).astype(np.float32)
    bx = g.normal(size=(nb, cap, dim)).astype(np.float32)
    ids = np.arange(nb * cap, dtype=np.int32).reshape(nb, cap)
    ids = np.where(g.random((nb, cap)) < pad_frac, -1, ids).astype(np.int32)
    bsel = g.integers(0, nb, size=(qn, beam)).astype(np.int32)
    act = g.random((qn, beam)) < 0.75
    top_d = np.sort(g.random((qn, kk)).astype(np.float32) * 40.0, axis=1)
    top_d[:, kk // 2:] = np.inf
    top_i = np.where(np.isinf(top_d), -1, g.integers(10_000, 20_000, (qn, kk))).astype(np.int32)
    return q, bx, ids, bsel, act, top_d, top_i


@pytest.mark.parametrize("qn,nb,cap,dim,beam,kk", [
    (4, 7, 5, 6, 3, 4), (2, 9, 8, 16, 4, 7), (1, 3, 2, 33, 2, 5),
    (5, 6, 4, 8, 6, 11), (64, 40, 1000, 5, 1, 10), (64, 40, 2500, 20, 4, 10),
    (16, 10, 300, 20, 2, 200),
])
@pytest.mark.parametrize("int8", [False, True])
def test_bucket_scan_kernel_matches_plain(dev, qn, nb, cap, dim, beam, kk, int8):
    g = np.random.default_rng(qn * 7 + cap)
    args = [torch.from_numpy(a).to(dev) for a in _problem(g, qn, nb, cap, dim, beam, kk)]
    scale = None
    if int8:
        xq, s = ops.quantize_datastore(args[1].reshape(nb * cap, dim))
        args[1] = xq.reshape(nb, cap, dim).contiguous()
        scale = s.reshape(nb, cap).contiguous()
    n0 = bucket_scan_topk_cuda.launches
    kd, ki = ops.bucket_scan_topk(*args, scale)
    torch.cuda.synchronize()
    assert bucket_scan_topk_cuda.launches == n0 + 1
    rd, ri = ref.bucket_scan_topk_ref(*args, scale)
    tol = 1e-4 if int8 else 1e-5
    torch.testing.assert_close(kd, rd, rtol=tol, atol=tol)
    torch.testing.assert_close(torch.isinf(kd), ki == -1)
    # ids: equal wherever the plain result has no near tie at that rank
    gap = torch.diff(rd, dim=1).abs()
    near = torch.zeros_like(ki, dtype=torch.bool)
    near[:, 1:] |= gap <= tol * (1 + rd[:, 1:].abs().nan_to_num(0, 0, 0))
    near[:, :-1] |= near[:, 1:].clone()
    assert torch.equal(ki[~near], ri[~near])


def test_bucket_scan_kernel_ties_and_dry_pool(dev):
    g = np.random.default_rng(9)
    qn, nb, cap, dim, beam, kk = 3, 5, 4, 6, 3, 6
    row = g.normal(size=(dim,)).astype(np.float32)
    bx = np.broadcast_to(row, (nb, cap, dim)).copy()
    bx[2:] = g.normal(size=(nb - 2, cap, dim))
    ids = np.arange(nb * cap, dtype=np.int32).reshape(nb, cap)
    ids[4] = -1  # an all-padding bucket: a dry pool for query 2
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    q = t(g.normal(size=(qn, dim)).astype(np.float32))
    bsel = t(np.array([[0, 1, 2], [1, 0, 3], [4, 4, 4]], np.int32))
    act = t(np.ones((qn, beam), bool))
    top_d = t(np.array([[np.inf] * kk, [np.inf] * kk, [1.0, 2.5] + [np.inf] * (kk - 2)], np.float32))
    top_i = t(np.array([[-1] * kk, [-1] * kk, [42, 7] + [-1] * (kk - 2)], np.int32))
    kd, ki = ops.bucket_scan_topk(q, t(bx), t(ids), bsel, act, top_d, top_i)
    rd, ri = ref.bucket_scan_topk_ref(q, t(bx), t(ids), bsel, act, top_d, top_i)
    torch.testing.assert_close(kd, rd, rtol=1e-5, atol=1e-5)
    assert torch.equal(ki, ri)
    assert torch.equal(ki[2], top_i[2])
