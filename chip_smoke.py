#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the run exits non-zero:

1. the card (``nvidia-smi`` name and power limit) and the kernel build
   (``nvcc`` on ``src/repro_torch/csrc``, one process per source);
2. K2 (``pairwise_sq_l2``) against its plain version on the card;
3. K1 (``bucket_scan_topk``) against its plain version on the card, f32 and
   int8, including exact ties, fewer than k reachable and a dry pool;
4. the slice: ``OverlapIndex.baseline`` over WARD-like 1,000,000 x 5 (c_max
   1000) and Tracking-like 62,702 x 20, then ``search`` of 1,024 queries at
   k=10, beam 1 and 4, f32 and int8 buckets, held against a brute force on
   the card (f32: exact up to ties; int8: against the dequantized rows the
   index stores, at least 0.99, with the recall against the f32 rows
   printed); the kernels' launch counters must rise during this phase;
5. kernel times (CUDA events) beside the plain versions', the library
   yardstick and the bound (bytes over 3.35 TB/s, f32 flops over
   67 TFLOP/s, whichever is larger), then one ``torch.profiler`` pass per
   search for the device's busy share.

The last lines are one JSON object of per-kernel numbers, then
``{"ok": true, "device": {...}}``; ``--json PATH`` also writes the full
per-shape detail there.  Imports nothing of JAX or of ``repro``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
K = 10
NQ = 1024
SEED = 0


def log(*args) -> None:
    print(*args, flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


# --------------------------------------------------------------------------
# timing and bounds
# --------------------------------------------------------------------------

def device_ms(fn, *, reps: int = 7, launches_hint: int = 1) -> float:
    """Median device time of ``fn`` in ms, by CUDA events.  A sleep kernel
    queued ahead of each timed run keeps the device busy while the host
    enqueues, so the interval measures device execution, not Python."""
    import torch

    fn()
    torch.cuda.synchronize()
    cycles = int(2e5) * max(1, launches_hint)  # ~0.1 ms of sleep per launch
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------
# phase 2: K2 against its plain version
# --------------------------------------------------------------------------

def k2_tol(q, x):
    """|kernel - plain| allowed per element: both compute the expansion in
    f32, the kernel with FMA contraction in its own summation order, so the
    difference is a few ulp of ||q||^2 + ||x||^2 (plus 1e-5 absolute)."""
    qq = (q.double() ** 2).sum(1)[:, None]
    xx = (x.double() ** 2).sum(1)[None, :]
    return 1e-5 + 1e-5 * (qq + xx).abs()


def check_k2(dev, gen) -> float:
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.pairwise_l2 import pairwise_sq_l2_cuda

    shapes = [(NQ, n, d) for d in (5, 20) for n in (1, 841, 1498)]
    shapes += [(1, 1, 1), (65, 130, 33), (7, 9, 13), (9, 17, 128), (70, 3, 200),
               (129, 4097, 5)]
    worst = 0.0
    for qn, n, d in shapes:
        q = torch.randn((qn, d), generator=gen, device=dev) * 25
        x = torch.randn((n, d), generator=gen, device=dev) * 25
        got = pairwise_sq_l2_cuda(q, x)
        want = ref.pairwise_sq_l2_ref(q, x)
        torch.cuda.synchronize()
        err = (got.double() - want.double()).abs()
        require(bool((err <= k2_tol(q, x)).all()), f"K2 disagrees at {(qn, n, d)}")
        require(bool((got >= 0).all()), "K2 emitted a negative distance")
        worst = max(worst, float(err.max()))
    log(f"[K2] {len(shapes)} shapes match the plain version on the card; "
        f"max |kernel - plain| = {worst:.3e} (data ~N(0, 25^2); tolerance "
        "1e-5 * (1 + ||q||^2 + ||x||^2): FMA contraction against the plain order)")
    return worst


# --------------------------------------------------------------------------
# phase 3: K1 against its plain version
# --------------------------------------------------------------------------

def scan_problem(gen, dev, qn, nb, cap, dim, beam, kk, *, pad=0.3, seeded=True, int8=False):
    import torch

    from repro_torch.kernels import ops

    q = torch.randn((qn, dim), generator=gen, device=dev)
    bx = torch.randn((nb, cap, dim), generator=gen, device=dev)
    ids = torch.arange(nb * cap, device=dev, dtype=torch.int32).reshape(nb, cap)
    ids = torch.where(torch.rand((nb, cap), generator=gen, device=dev) < pad, -1, ids)
    bsel = torch.randint(0, nb, (qn, beam), generator=gen, device=dev, dtype=torch.int32)
    act = torch.rand((qn, beam), generator=gen, device=dev) < 0.75
    if seeded:
        top_d = torch.sort(torch.rand((qn, kk), generator=gen, device=dev) * 40, dim=1).values
        top_d[:, kk // 2:] = float("inf")
        top_i = torch.randint(10_000_000, 20_000_000, (qn, kk), generator=gen,
                              device=dev, dtype=torch.int32)
        top_i = torch.where(torch.isinf(top_d), -1, top_i)
    else:
        top_d = torch.full((qn, kk), float("inf"), device=dev)
        top_i = torch.full((qn, kk), -1, device=dev, dtype=torch.int32)
    scale = None
    if int8:
        xq, s = ops.quantize_datastore(bx.reshape(nb * cap, dim))
        bx, scale = xq.reshape(nb, cap, dim).contiguous(), s.reshape(nb, cap).contiguous()
    return [q, bx, ids, bsel, act, top_d, top_i, scale]


def compare_k1(args, *, tol: float, exact_ids: bool, what: str) -> float:
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.bucket_scan import bucket_scan_topk_cuda

    kd, ki = bucket_scan_topk_cuda(*args)
    rd, ri = ref.bucket_scan_topk_ref(*args)
    torch.cuda.synchronize()
    fin = torch.isfinite(rd)
    require(torch.equal(fin, torch.isfinite(kd)), f"K1 {what}: different fill")
    err = (kd[fin] - rd[fin]).abs()
    require(bool((err <= tol * (1 + rd[fin].abs())).all()), f"K1 {what}: values disagree")
    require(torch.equal(~fin, ki == -1), f"K1 {what}: inf without id -1")
    if exact_ids:
        require(torch.equal(ki, ri), f"K1 {what}: ids differ")
    else:
        # ids agree wherever the plain top-k has no near tie around the rank
        close = (torch.diff(rd, dim=1).abs() <= tol * (1 + rd[:, 1:].abs())) & fin[:, 1:]
        tied = torch.zeros_like(fin)
        tied[:, 1:] |= close
        tied[:, :-1] |= close
        require(torch.equal(ki[~tied], ri[~tied]), f"K1 {what}: ids differ off ties")
    return float(err.max()) if err.numel() else 0.0


def check_k1(dev, gen) -> float:
    import torch

    worst = 0.0
    n = 0
    sweep = [(4, 7, 5, 6, 3, 4), (2, 9, 8, 16, 4, 7), (1, 3, 2, 33, 2, 5),
             (5, 6, 4, 8, 6, 11), (4, 6, 5, 12, 3, 6),
             # main-path shapes: WARD (C=1000, D=5) and Tracking (C=250, D=20)
             (NQ, 1498, 1000, 5, 1, K), (NQ, 1498, 1000, 5, 4, K),
             (NQ, 841, 250, 20, 1, K), (NQ, 841, 250, 20, 4, K),
             # a bucket wider than one shared-memory chunk, and a large k
             (64, 12, 2500, 20, 2, K), (32, 20, 300, 8, 3, 300)]
    for shape in sweep:
        for int8 in (False, True):
            args = scan_problem(gen, dev, *shape, int8=int8)
            tol = 1e-4 if int8 else 1e-5
            worst = max(worst, compare_k1(args, tol=tol, exact_ids=False,
                                          what=f"{shape} int8={int8}"))
            n += 1
    # fewer than k reachable: heavy padding, empty running top-k
    for int8 in (False, True):
        args = scan_problem(gen, dev, 3, 4, 3, 5, 2, 9, pad=0.8, seeded=False, int8=int8)
        worst = max(worst, compare_k1(args, tol=1e-4, exact_ids=True, what="fewer-than-k"))
        n += 1
    # exact ties: one member row copied into every slot of two buckets
    q, bx, ids, bsel, act, top_d, top_i, _ = scan_problem(
        gen, dev, 3, 5, 4, 6, 3, 6, pad=0.0, seeded=False)
    bx[:2] = bx[0, 0]
    bsel = torch.tensor([[0, 1, 2], [1, 0, 3], [0, 0, 4]], device=dev, dtype=torch.int32)
    act = torch.ones_like(act)
    worst = max(worst, compare_k1([q, bx, ids, bsel, act, top_d, top_i, None],
                                  tol=1e-5, exact_ids=True, what="exact ties"))
    # dry pool: a partly filled top-k, nothing live in the step
    q, bx, ids, bsel, act, _, _, _ = scan_problem(gen, dev, 2, 3, 4, 5, 2, 5)
    ids = torch.full_like(ids, -1)
    top_d = torch.tensor([[1.0, 2.5] + [float("inf")] * 3] * 2, device=dev)
    top_i = torch.tensor([[42, 7, -1, -1, -1]] * 2, device=dev, dtype=torch.int32)
    worst = max(worst, compare_k1([q, bx, ids, bsel, act, top_d, top_i, None],
                                  tol=1e-5, exact_ids=True, what="dry pool"))
    log(f"[K1] {n + 2} cases match the plain version on the card (f32 and int8; "
        f"main-path shapes; exact ties, fewer than k, dry pool); max |kernel - "
        f"plain| = {worst:.3e} (tolerance 1e-5 relative f32, 1e-4 int8: FMA "
        "contraction against the plain order)")
    return worst


# --------------------------------------------------------------------------
# phase 4: the slice
# --------------------------------------------------------------------------

class BruteForce:
    """Exact kNN on the card, independent of the port's search: chunked
    plain distances, then ``torch.topk``; returns f64 exact squared
    distances for the checks."""

    def __init__(self, x, q):
        import torch

        from repro_torch.kernels import ref

        self.x, self.q = x, q
        best_d = torch.full((q.shape[0], 0), float("inf"), device=q.device)
        best_i = torch.zeros((q.shape[0], 0), dtype=torch.int64, device=q.device)
        chunk = 1 << 16
        for lo in range(0, x.shape[0], chunk):
            d2 = ref.pairwise_sq_l2_ref(q, x[lo:lo + chunk])
            vd, vi = torch.topk(d2, min(K, d2.shape[1]), dim=1, largest=False)
            best_d = torch.cat([best_d, vd], 1)
            best_i = torch.cat([best_i, vi + lo], 1)
            best_d, pos = torch.topk(best_d, min(K, best_d.shape[1]), dim=1, largest=False)
            best_i = torch.gather(best_i, 1, pos)
        self.ids = best_i
        self.d2 = self.exact_d2(best_i)
        self.kth = self.d2.max(dim=1).values
        self.kth_tol = self.tol(best_i).max(dim=1).values

    def exact_d2(self, ids):
        """f64 squared distances of the rows ``ids`` to their queries."""
        import torch

        xs = self.x[ids.clamp_min(0).long()].double()
        d2 = ((xs - self.q.double()[:, None, :]) ** 2).sum(-1)
        return torch.where(ids >= 0, d2, torch.full_like(d2, float("inf")))

    def tol(self, ids):
        """Rounding allowed in an f32 squared distance computed by the
        expansion: 1e-6 * (||q||^2 + ||x||^2), about 8 ulp of the norms."""
        xs = self.x[ids.clamp_min(0).long()].double()
        return 1e-6 * ((xs ** 2).sum(-1) + (self.q.double() ** 2).sum(1)[:, None])


def check_result(bf: BruteForce, dists, ids, *, truth: BruteForce | None = None) -> dict:
    """Hold a search result against the brute force over the rows the index
    stores (``bf``).  ``recall_ties`` counts a returned id as a hit when its
    exact d^2 <= the exact k-th d^2 + the f32 rounding of the expansion the
    search ranks by (``BruteForce.tol``); every distance must match the
    exact one to that rounding.

    f32 buckets: the bounded scan is exact, so ``recall_ties`` must be 1.
    int8 buckets: ``bf`` runs over the dequantized rows.  The scan's lower
    bounds come from the f32 pivots and radii, and a dequantized member can
    sit up to half a quantization step outside its bucket's f32 radius, so
    the pruning is not exact for int8 rows: ``recall_ties`` must reach
    0.99.  ``truth`` (the f32 rows) gives the recall the int8 storage costs,
    printed, not required."""
    import torch

    dev = bf.q.device
    ids_t = torch.as_tensor(ids, device=dev).long()
    d_t = torch.as_tensor(dists, device=dev).double()
    exact = bf.exact_d2(ids_t)
    tol = bf.tol(ids_t)
    tie_recall = float((exact <= (bf.kth + bf.kth_tol)[:, None] + tol).float().mean())
    ref_ids = (truth or bf).ids
    recall = float((ids_t[:, :, None] == ref_ids[:, None, :]).any(-1).float().mean())
    floor = 1.0 if truth is None else 0.99
    require(tie_recall >= floor, f"recall {tie_recall} < {floor} up to ties")
    derr = (d_t ** 2 - exact).abs()
    require(bool((derr <= tol).all()), "distances off the exact ones")
    uniq = all(len(set(r)) == len(r) for r in ids_t.tolist())
    require(uniq and bool((ids_t >= 0).all()), "duplicate or missing ids")
    return dict(recall=recall, recall_ties=tie_recall, max_d2_err=float(derr.max()))


def make_queries(x, seed: int):
    import numpy as np

    g = np.random.default_rng(seed)
    base = x[g.choice(len(x), NQ, replace=False)]
    noise = g.normal(size=base.shape) * 0.05 * x.std(axis=0)
    return (base + noise).astype(np.float32)


DATASETS = [("WARD", "ward_like", 1_000_000, 1000), ("Tracking", "tracking_like", 62_702, None)]


def run_slice(dev, datasets=DATASETS) -> dict:
    """Build both datasets' baselines and search them; returns what phase 5
    and the summary need.  The launch counters are reset just before the
    searches and read just after them."""
    import torch

    from repro_torch.api import Config, IndexConfig, OverlapIndex, SearchConfig
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops

    built = {}
    for name, gen, n, c_max in datasets:
        t0 = time.perf_counter()
        x = getattr(synthetic, gen)(n)
        t_data = time.perf_counter() - t0
        idx = {}
        for quantize in (False, True):
            cfg = Config(index=IndexConfig(pivot_method="kmeans", c_max=c_max),
                         search=SearchConfig(quantize=quantize))
            t0 = time.perf_counter()
            idx[quantize] = OverlapIndex.baseline(x, cfg, device=dev)
            t_build = time.perf_counter() - t0
        f = idx[False].forest
        log(f"[slice] {name}: x {x.shape} made in {t_data:.1f} s; baseline build "
            f"{t_build:.1f} s (host numpy, 2-means); bucket_x {f.bucket_x.shape}, "
            f"{f.bucket_x.nbytes / 1e6:.1f} MB f32")
        q = make_queries(x, SEED + len(built))
        qt = torch.from_numpy(q).to(dev)
        xt = torch.from_numpy(x).to(dev)
        xq, scale = ops.quantize_datastore(xt)  # the rows the int8 index stores
        built[name] = dict(x=x, q=q, idx=idx, bf=BruteForce(xt, qt),
                           bf_int8=BruteForce(xq.float() * scale[:, None], qt))

    # warm-up: first upload of each forest and one search per plan, uncounted
    for b in built.values():
        for quantize in (False, True):
            for beam in (1, 4):
                b["idx"][quantize].search(b["q"], k=K, beam=beam)
    torch.cuda.synchronize()

    ops.reset_launch_counts()
    results = []
    for name, b in built.items():
        for quantize in (False, True):
            for beam in (1, 4):
                t0 = time.perf_counter()
                res = b["idx"][quantize].search(b["q"], k=K, beam=beam)
                wall = time.perf_counter() - t0
                results.append((name, quantize, beam, res, wall))
    launches = ops.launch_counts()
    log(f"[slice] launch counts over the {len(results)} searches: {launches}")
    require(all(v > 0 for v in launches.values()), "a kernel of the path never launched")

    for name, quantize, beam, res, wall in results:
        b = built[name]
        if quantize:
            chk = check_result(b["bf_int8"], res.dists, res.ids, truth=b["bf"])
            what = (f"recall vs the stored int8 rows up to ties={chk['recall_ties']:.4f}, "
                    f"recall vs the f32 rows={chk['recall']:.4f}")
        else:
            chk = check_result(b["bf"], res.dists, res.ids)
            what = (f"recall={chk['recall']:.4f}, recall up to ties="
                    f"{chk['recall_ties']:.4f}")
        st = res.stats
        log(f"[slice] {name} {'int8' if quantize else 'f32 '} beam={beam}: "
            f"{wall / NQ * 1e6:.1f} us/query ({wall * 1e3:.1f} ms for {NQ}), "
            f"steps={st['steps']}, mean buckets_visited="
            f"{st['buckets_visited'].mean():.2f}, mean distances="
            f"{st['distances'].mean():.1f}, host syncs={st['steps'] + 1}, {what}")
    return dict(built=built, launches=launches, results=results)


def check_kernel_vs_plain_search(built) -> None:
    """The kernel path and the plain path (``kernel=False``) of the same
    search on the card.  Both must be exact against the brute force (ids up
    to ties), with the same distances rank by rank to the f32 rounding of
    the expansion (twice ``BruteForce.tol``: each side rounds).  The cost
    counters agree per query except where a bucket's lower bound lies
    within that rounding of the k-th best distance: the two paths round
    differently, so such a bucket is visited by one and pruned by the other.
    At most 1% of queries may differ, each by at most ``beam`` visits."""
    import numpy as np
    import torch

    beam = 4
    for name, b in built.items():
        ix = b["idx"][False]
        rk = ix.search(b["q"], k=K, beam=beam)
        t0 = time.perf_counter()
        rp = ix.search(b["q"], k=K, beam=beam, kernel=False)
        wall = time.perf_counter() - t0
        differ = np.zeros(NQ, bool)
        for key in ("buckets_visited", "distances", "bound_distances",
                    "padded_distances", "comparisons"):
            differ |= rk.stats[key] != rp.stats[key]
        dv = np.abs(rk.stats["buckets_visited"] - rp.stats["buckets_visited"])
        require(differ.mean() <= 0.01 and dv.max() <= beam,
                f"{name}: cost counters differ on {differ.sum()} queries (max {dv.max()} visits)")
        # both exact against the brute force up to ties, and the same
        # distances rank by rank to the expansion's rounding
        check_result(b["bf"], rp.dists, rp.ids)
        check_result(b["bf"], rk.dists, rk.ids)
        tol = b["bf"].tol(torch.as_tensor(rp.ids, device=b["bf"].q.device).long()).cpu().numpy()
        d2k, d2p = rk.dists.astype(np.float64) ** 2, rp.dists.astype(np.float64) ** 2
        require(bool((np.abs(d2k - d2p) <= 2 * tol).all()), f"{name}: distances differ")
        log(f"[slice] {name} f32 beam={beam}: kernel path vs plain path: ids equal "
            f"{(rk.ids == rp.ids).mean():.4f} (the rest near ties), cost counters "
            f"equal on {1 - differ.mean():.4f} of queries (max {dv.max()} visits apart), "
            f"steps {rk.stats['steps']} vs {rp.stats['steps']}; plain path "
            f"{wall / NQ * 1e6:.1f} us/query")


# --------------------------------------------------------------------------
# phase 5: times
# --------------------------------------------------------------------------

def time_k2(built) -> list[dict]:
    """K2 at the shapes the main path gives it: queries against the bucket
    pivots (bucket_bounds) of each dataset."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.pairwise_l2 import pairwise_sq_l2_cuda

    rows = []
    for name, b in built.items():
        dev_forest = b["idx"][False].device
        q = torch.from_numpy(b["q"]).to(dev_forest.bucket_pivot.device)
        x = dev_forest.bucket_pivot
        got, want = pairwise_sq_l2_cuda(q, x), ref.pairwise_sq_l2_ref(q, x)
        err = (got.double() - want.double()).abs()
        require(bool((err <= k2_tol(q, x)).all()), f"K2 disagrees on {name} pivots")
        qn, d = q.shape
        n = x.shape[0]
        ms = device_ms(lambda: pairwise_sq_l2_cuda(q, x))
        plain = device_ms(lambda: ref.pairwise_sq_l2_ref(q, x))
        lib = device_ms(lambda: torch.cdist(q, x).square_())
        nbytes = 4 * (qn * d + n * d + qn * n)
        b_ms, by = bound(nbytes, 2.0 * qn * n * d)
        rows.append(dict(shape=f"{name} Q={qn} N={n} D={d}", ms=ms, plain_ms=plain,
                         library_ms=lib, bound_ms=b_ms, bound_by=by, bytes=nbytes,
                         max_abs_err=float(err.max())))
        log(f"[time] K2 {name} ({qn} x {n} x {d}): kernel {ms * 1e3:.1f} us, plain "
            f"{plain * 1e3:.1f} us, torch.cdist {lib * 1e3:.1f} us, bound "
            f"{b_ms * 1e3:.2f} us by {by} ({nbytes} B: q, pivots read once, "
            f"(Q, N) f32 written once)")
    return rows


class _Recorder:
    """Wraps the dispatch layer's scan step to keep each step's operands."""

    def __init__(self, fn):
        self.fn = fn
        self.steps = []

    def __call__(self, q, bx, ids, bsel, act, top_d, top_i, scale=None):
        self.steps.append((bsel.clone(), act.clone(), top_d.clone(), top_i.clone()))
        return self.fn(q, bx, ids, bsel, act, top_d, top_i, scale)


def time_k1(built) -> list[dict]:
    """K1 replayed over the exact steps of one real search (recorded
    operands), per launch.  The bound counts what each launch must move: the
    queries, selections (4-byte bucket, 1-byte flag) and top-k in and out
    once per query, and the ids and live members' rows (and scales) of each
    distinct active bucket once, since the queries of a launch share
    buckets.  ``gathered`` counts member bytes once per (query, bucket) pair
    instead: what the kernel loads, most of it from L2."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.bucket_scan import bucket_scan_topk_cuda

    rows = []
    for name, b in built.items():
        for quantize, beam in ((False, 1), (False, 4), (True, 1)):
            ix = b["idx"][quantize]
            rec = _Recorder(ops.bucket_scan_topk)
            ops.bucket_scan_topk = rec
            try:
                ix.search(b["q"], k=K, beam=beam)
            finally:
                ops.bucket_scan_topk = rec.fn
            steps = rec.steps
            require(len(steps) > 0, f"K1 replay {name}: no scan step was recorded")
            df = ix.device
            q = torch.from_numpy(b["q"]).to(df.bucket_x.device)
            nb, cap, d = df.bucket_x.shape
            count = df.bucket_mask.sum(1)
            row_bytes = d * (1 if quantize else 4) + (4 if quantize else 0)
            nbytes = 0
            gathered = 0
            flops = 0
            for bsel, act, _, _ in steps:
                picked = bsel[act].long()
                picked = picked[(picked >= 0) & (picked < nb)]
                uniq = torch.unique(picked)
                live = int(count[picked].sum())
                nbytes += uniq.numel() * cap * 4 + int(count[uniq].sum()) * row_bytes
                nbytes += q.shape[0] * (d * 4 + beam * 5 + 4 * K * 4)
                gathered += picked.numel() * cap * 4 + live * row_bytes
                flops += live * 4 * d
            args = lambda s: (q, df.bucket_x, df.bucket_ids, s[0], s[1], s[2], s[3],  # noqa: E731
                              df.bucket_scale)
            # the replayed steps are held to the plain version too, at the
            # data's own scale: 1e-5 * (1 + ||q||^2 + max ||x||^2)
            tol = 1e-5 * (1 + (q.double() ** 2).sum(1) + float((b["x"].astype("float64") ** 2).sum(1).max()))
            worst = 0.0
            for s in steps:
                kd, ki = bucket_scan_topk_cuda(*args(s))
                rd, ri = ref.bucket_scan_topk_ref(*args(s))
                fin = torch.isfinite(rd)
                require(torch.equal(fin, torch.isfinite(kd)), f"K1 replay {name}: fill")
                err = torch.where(fin, (kd - rd).abs(), 0.0).double()
                require(bool((err <= tol[:, None]).all()), f"K1 replay {name}: values disagree")
                worst = max(worst, float(err.max()))
            n = len(steps)
            ms = device_ms(lambda: [bucket_scan_topk_cuda(*args(s)) for s in steps],
                           launches_hint=n) / n
            plain = device_ms(lambda: [ref.bucket_scan_topk_ref(*args(s)) for s in steps],
                              launches_hint=4 * n) / n
            b_ms, by = bound(nbytes / n, flops / n)
            kind = "int8" if quantize else "f32"
            rows.append(dict(shape=f"{name} {kind} beam={beam} C={cap} D={d}",
                             dataset=name, quantize=quantize, beam=beam, ms=ms,
                             plain_ms=plain, library_ms=None, bound_ms=b_ms, bound_by=by,
                             steps=n, bytes_per_launch=nbytes / n,
                             gathered_per_launch=gathered / n, max_abs_err=worst))
            log(f"[time] K1 {name} {kind} beam={beam} (Q={q.shape[0]}, C={cap}, D={d}), "
                f"{n} recorded steps: kernel {ms * 1e3:.1f} us/launch, plain "
                f"{plain * 1e3:.1f} us/launch, bound {b_ms * 1e3:.2f} us by {by} "
                f"({nbytes / n:.0f} B/launch with each distinct bucket once; "
                f"{gathered / n:.0f} B/launch gathered per (query, bucket) pair), "
                f"max |kernel - plain| {worst:.2e}")
    return rows


def profile_searches(built, results) -> list[dict]:
    """One profiled search per dataset and beam (f32): device time summed
    over the kernels the profiler saw, K1's and K2's share of it, and the
    device busy share against the same search's unprofiled wall time from
    the slice phase (the profiler's own host overhead inflates its wall)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    walls = {(n, qz, bm): w for n, qz, bm, _, w in results}
    rows = []
    for name, b in built.items():
        ix = b["idx"][False]
        for beam in (1, 4):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                ix.search(b["q"], k=K, beam=beam)
            kernels = [e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
            k1 = sum(e.self_device_time_total for e in kernels if "bucket_scan" in e.key) / 1e3
            k2 = sum(e.self_device_time_total for e in kernels if "pairwise_sq_l2" in e.key) / 1e3
            wall_ms = walls[(name, False, beam)] * 1e3
            rows.append(dict(dataset=name, beam=beam, device_ms=dev_ms, k1_ms=k1, k2_ms=k2,
                             wall_ms=wall_ms, kernel_launches=sum(e.count for e in kernels)))
            log(f"[profile] {name} f32 beam={beam}: device busy {dev_ms:.2f} ms of the "
                f"search's {wall_ms:.2f} ms wall ({dev_ms / wall_ms:.1%}); K1 {k1:.2f} ms, "
                f"K2 {k2:.3f} ms, other kernels {dev_ms - k1 - k2:.2f} ms over "
                f"{sum(e.count for e in kernels)} device launches")
    return rows


# --------------------------------------------------------------------------

def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Smoke run of repro_torch on one NVIDIA GPU")
    ap.add_argument("--json", help="also write the per-kernel detail to this JSON file")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} is missing; run from a checkout "
              "of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _build
    from repro_torch.kernels.ref import no_tf32

    t_start = time.perf_counter()
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    log(f"[card] {smi}")
    log(f"[card] torch {torch.__version__} CUDA {torch.version.cuda}, {name}")
    no_tf32()
    t_build = _build.build_all()
    log(f"[build] nvcc sm_90a, {len(_build.BUILD_LOG)} sources in parallel: {t_build:.1f} s")
    for src_name, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {src_name}: {line.strip()}")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    k2_err = check_k2(dev, gen)
    k1_err = check_k1(dev, gen)

    sl = run_slice(dev)
    check_kernel_vs_plain_search(sl["built"])
    k2_rows = time_k2(sl["built"])
    k1_rows = time_k1(sl["built"])
    prof_rows = profile_searches(sl["built"], sl["results"])

    # how much of each search's wall time the K1 launches account for
    walls = {(n, qz, bm): w for n, qz, bm, _, w in sl["results"]}
    for r in k1_rows:
        wall_ms = walls[(r["dataset"], r["quantize"], r["beam"])] * 1e3
        log(f"[time] {r['shape']}: K1 device time {r['ms'] * r['steps']:.2f} ms of "
            f"the search's {wall_ms:.2f} ms wall ({r['ms'] * r['steps'] / wall_ms:.1%})")

    def entry(kname, src_file, replaces, row, err):
        return dict(
            name=kname, route="cuda", source=src_file, replaces=replaces,
            launches=sl["launches"][kname], max_abs_err=err, ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"], shape=row["shape"],
        )

    kernels = [
        entry("bucket_scan_topk", "src/repro_torch/csrc/bucket_scan.cu",
              "src/repro/kernels/bucket_scan.py:197", k1_rows[0],
              max([k1_err] + [r["max_abs_err"] for r in k1_rows])),
        entry("pairwise_sq_l2", "src/repro_torch/csrc/pairwise_l2.cu",
              "src/repro/kernels/pairwise_l2.py:102", k2_rows[0],
              max([k2_err] + [r["max_abs_err"] for r in k2_rows])),
    ]
    if args.json:
        detail = dict(card=smi, kernels=kernels, k1=k1_rows, k2=k2_rows, profile=prof_rows,
                      seconds=time.perf_counter() - t_start)
        out = Path(args.json)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(detail, indent=1))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
