#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the run exits non-zero:

1. the card (``nvidia-smi`` name and power limit) and the kernel build
   (``nvcc`` on ``src/repro_torch/csrc``, one process per source);
2. K2 (``pairwise_sq_l2``) against its plain version on the card;
3. K1 (``bucket_scan_topk``, one launch per scan phase) against the plain
   lockstep phase on the card, bit for bit on grid rows: f32 and int8, beam
   1/3/4, main-path widths, several tiles a bucket, kk = 300, exact ties,
   fewer than k reachable and a delta phase seeded with the main carry;
4. K3, K4, K5 (the DBSCAN ``eps_*`` passes) against their plain versions:
   exact on unit-scale rows and on hand-made cases (ties, no core point, all
   core, ragged tiles, K3-K5 ties across column chunks), and on 2,048 rows
   of each full dataset against the whole dataset under the in-band rule
   (``check_eps_data``);
5. the baseline slice: ``OverlapIndex.baseline`` over WARD-like
   1,000,000 x 5 (c_max 1000) and Tracking-like 62,702 x 20, then ``search``
   of 1,024 queries at k=10, beam 1 and 4, f32 and int8 buckets, held
   against a brute force on the card (f32: exact up to ties; int8: against
   the dequantized rows the index stores, at least 0.99, with the recall
   against the f32 rows printed); K1 must launch exactly once per search
   and K2 must launch; each search's host-device synchronisations are
   counted (torch's sync debug mode) and may be at most 2;
6. the overlap build: ``OverlapIndex.build`` at the repo's full-size
   configurations (Tracking with VBM, DBM and OBM, WARD with VBM, and the
   tests' blob set with VBM, whose forest has overlap-neighbour links), each
   build's report and per-phase seconds printed, Tracking's structure held
   to the JAX package's and WARD's to an earlier card run's, K4 launched
   once per DBSCAN sweep and K3/K5 once per build; Tracking's DBSCAN also
   run through the plain path
   on the card, and both runs held to the whole-DBSCAN rule
   (``check_dbscan``);
7. ``search`` on every overlap forest as in phase 5, beside the baseline's
   cost counters; K1-K5 must all launch across phases 6-7;
8. kernel times (CUDA events) beside the plain versions', the library
   yardstick and the bound (bytes over 3.35 TB/s, f32 flops over
   67 TFLOP/s, whichever is larger): K2 at the bounds and routing shapes
   and its launch floor, K1 one phase a search with its steps; K3-K5 also
   with their launch grid, the earlier run's time and K6 at Q = 8 as this
   run's control; then one ``torch.profiler`` pass per baseline search for
   the device's busy share and launches;
9. K6 (``knn_topk``) and K7 (``pairwise_sq_l2_int8``) against their plain
   versions, bit-equal on grid rows (N < k, ragged N, D 5/64/896, k 1/8/16,
   exact ties across pass-1 chunks);
10. K6 and K7 at data scale: a 2^20 x 896 datastore drawn on the card from
    ``embedding_datastore``'s recipe, Q = 8 and 1,024, under the in-band
    rule against the plain versions and recall 1.0 up to ties against an
    f64 brute force;
11. kNN-LM serving: qwen2-0.5b at full width (seeded weights) in
    ``ServeEngine(num_slots=8, max_len=256)``, 16 requests of 8-64 prompt
    tokens and 32 new tokens, with retrieval off, on the f32 datastore (K6)
    and on its int8 twin (K7): every request completes, the books balance,
    K6/K7 launch once per decode step, three captured steps' top-k held to
    the plain version; then the 2-slot vs 1-slot agreement (printed), a
    profiled window of decode steps and K6/K7 times beside the plain
    versions, ``cdist`` + ``topk`` and the bound, at Q = 8 and 1,024;
12. streaming, the JAX package's own workload (``benchmarks/bench_stream.py``
    at full size): 20,000 + 40,000 drifting points at D = 12, batches of
    1,024, delta capacity 2,048, VBM build, DBM monitor, ``maintain()``
    after every batch; ``mode="all"`` exact over every object ingested and
    ``mode="forest"`` exact over its routed rows, at the start, mid-stream,
    after every rebuild swap and at the end; K1 twice a search;
13. WARD 1M streaming: 16 x 1,024 new points into phase 6's WARD VBM
    forest at the default capacity, ``maintain()`` after each, with
    capacity-forced and fill-triggered host rebuilds of the 1M forest; a
    CPU twin's delta state, accepts and triggers equal to the card's; the
    searches exact over main + delta rows, 2 host syncs and 2 K1 launches
    a search;
14. the blob forest with an OBM monitor: ``object_assignment`` and the
    object-based rates on the card, held to the CPU twin's where no object
    lies in band of a ball's boundary;
15. kNN-LM serving on a streaming forest datastore: ``build_forest_datastore``
    over 65,536 x 896 keys (DBSCAN on K3-K5 at D = 896), then 16 requests
    interleaved with 16 inserts of 64 keys on ``ServeEngine(num_slots=8)``:
    inserts accepted or reported, the delta holding exactly the accepted
    pairs, each streamed key retrieving its token, ``forest_knn`` exact over
    its routed rows, K1 twice a decode step; K1 timed at D = 896.

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

def device_ms(fn, *, reps: int = 7, launches_hint: int = 1, warm: bool = True) -> float:
    """Median device time of ``fn`` in ms, by CUDA events.  A sleep kernel
    queued ahead of each timed run keeps the device busy while the host
    enqueues, so the interval measures device execution, not Python.
    ``warm=False`` skips the untimed first run (for calls of many seconds)."""
    import torch

    if warm:
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

def phase_problem(gen, dev, qn, nb, cap, dim, beam, kk, *, pad=0.3, inf_frac=0.2,
                  int8=False):
    """A K1 scan phase on 1/8-grid rows (int8: integers with scale 1/8), so
    the expansion is exact and the kernel must equal the plain phase bit for
    bit; bounds per bucket with a share of +inf rows, sorted and padded to a
    beam multiple by the search's own ``_sorted_bounds``."""
    import torch

    from repro_torch.core.knn import _sorted_bounds

    def grid(*shape):
        return torch.randint(-16, 17, shape, generator=gen, device=dev).float() / 8

    q = grid(qn, dim)
    scale = None
    if int8:
        bx = torch.randint(-127, 128, (nb, cap, dim), generator=gen, device=dev).to(torch.int8)
        scale = torch.full((nb, cap), 0.125, device=dev)
    else:
        bx = grid(nb, cap, dim)
    ids = torch.arange(nb * cap, device=dev, dtype=torch.int32).reshape(nb, cap)
    ids = torch.where(torch.rand((nb, cap), generator=gen, device=dev) < pad, -1, ids)
    count = (ids >= 0).sum(1, dtype=torch.int32)
    lb = torch.rand((qn, nb), generator=gen, device=dev) * 1.5 * dim ** 0.5 * (8 if int8 else 1)
    lb = torch.where(torch.rand((qn, nb), generator=gen, device=dev) < inf_frac, float("inf"), lb)
    order, lb_sorted, _ = _sorted_bounds(lb, beam)
    top_d = torch.full((qn, kk), float("inf"), device=dev)
    top_i = torch.full((qn, kk), -1, device=dev, dtype=torch.int32)
    return [q, bx, ids, count, order, lb_sorted, beam, top_d, top_i, scale]


def compare_phase(args, what: str):
    """The K1 phase kernel against the plain phase on the same operands:
    bit for bit in top_d, top_i, visits, ndist, npad and qsteps."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.bucket_scan import bucket_scan_phase_cuda

    got = bucket_scan_phase_cuda(*args)
    want = ref.bucket_scan_phase_ref(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(("top_d", "top_i", "visits", "ndist", "npad", "qsteps"), got, want):
        require(a.dtype == b.dtype and torch.equal(a, b), f"K1 {what}: {name} differs")
    return got


def check_k1(dev, gen) -> float:
    import torch

    n = 0
    sweep = [(4, 7, 5, 6, 3, 4), (2, 9, 8, 16, 4, 7), (1, 3, 2, 33, 1, 5),
             (5, 13, 4, 8, 4, 11),
             # main-path widths: WARD (C=1000, D=5) and Tracking (C=250, D=20)
             (NQ, 1498, 1000, 5, 1, K), (NQ, 1498, 1000, 5, 4, K),
             (NQ, 841, 250, 20, 1, K), (NQ, 841, 250, 20, 4, K),
             # a bucket of several shared-memory tiles, and a large k
             (64, 12, 2500, 20, 3, K), (32, 20, 300, 8, 3, 300)]
    steps = []
    for shape in sweep:
        for int8 in (False, True):
            got = compare_phase(phase_problem(gen, dev, *shape, int8=int8),
                                f"{shape} int8={int8}")
            steps.append(int(got[5].max()))
            n += 1
    # exact ties across the slots of a step: one row in every bucket
    args = phase_problem(gen, dev, 5, 6, 4, 5, 3, 7, pad=0.0, inf_frac=0.0)
    args[1][:] = args[1][0, 0]
    compare_phase(args, "exact ties")
    # fewer than k reachable: kth stays +inf, pad slots re-scan bucket 0
    for int8 in (False, True):
        args = phase_problem(gen, dev, 4, 5, 3, 3, 4, 40, pad=0.5, int8=int8)
        got = compare_phase(args, "fewer-than-k")
        require(bool(torch.isinf(got[0]).any()), "K1 fewer-than-k: the top-k filled")
    # a delta phase seeded with the main phase's carry
    main = phase_problem(gen, dev, 256, 40, 64, 5, 2, K)
    carry = compare_phase(main, "main phase")
    delta = phase_problem(gen, dev, 256, 8, 50, 5, 2, K, pad=0.5)
    delta[0], delta[7], delta[8] = main[0], carry[0], carry[1]
    compare_phase(delta, "delta phase seeded with the main carry")
    n += 5
    log(f"[K1] {n} phases equal the plain phase bit for bit on the card (grid rows; "
        f"f32 and int8, beam 1/3/4, main-path widths, C = 2500, kk = 300, exact ties, "
        f"fewer than k, a delta-seeded carry); steps per phase {min(steps)}-{max(steps)}")
    return 0.0


# --------------------------------------------------------------------------
# phase 4: K3, K4, K5 against their plain versions
# --------------------------------------------------------------------------

def grid_rows(gen, dev, n, d):
    """Unit-scale rows on a 1/8 grid in [-2, 2].  Every product and partial
    sum of the expansion is then exact in f32, whatever the order, so the
    kernels and the plain versions must agree bit for bit, and d2 == eps_sq
    and exact d2 ties really occur."""
    import torch

    return torch.randint(-16, 17, (n, d), generator=gen, device=dev).float() / 8


def compare_eps(q, x, labels, core, eps_sq, what: str) -> float:
    """K3 counts, K4 labels and K5 labels exactly equal to the plain
    versions'; K5's d2 within the K2 tolerance.  Returns max |d2 error|."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.eps_graph import (
        eps_count_cuda,
        eps_min_label_cuda,
        eps_nearest_core_cuda,
    )

    kc = eps_count_cuda(q, x, eps_sq)
    kl = eps_min_label_cuda(q, x, labels, core, eps_sq)
    kd, kn = eps_nearest_core_cuda(q, x, labels, core)
    pc = ref.eps_count_ref(q, x, eps_sq)
    pl = ref.eps_min_label_ref(q, x, labels, core, eps_sq)
    pd, pn = ref.eps_nearest_core_ref(q, x, labels, core)
    torch.cuda.synchronize()
    require(torch.equal(kc, pc), f"K3 {what}: counts differ")
    require(torch.equal(kl, pl), f"K4 {what}: labels differ")
    require(torch.equal(kn, pn), f"K5 {what}: labels differ")
    fin = torch.isfinite(pd)
    require(torch.equal(fin, torch.isfinite(kd)), f"K5 {what}: +inf differs")
    if not bool(fin.any()):
        return 0.0
    xx = float((x.double() ** 2).sum(1).max()) if x.shape[0] else 0.0
    tol = 1e-5 + 1e-5 * ((q.double() ** 2).sum(1) + xx)
    err = (kd.double() - pd.double()).abs()
    require(bool((err[fin] <= tol[fin]).all()), f"K5 {what}: d2 off the plain version's")
    return float(err[fin].max())


def check_eps_unit(dev, gen) -> float:
    """Phase 4a: random unit-scale cases and hand-made ones, all exact."""
    import torch

    from repro_torch.kernels import ref

    worst, n_cases = 0.0, 0
    sizes = (1, 63, 64, 65, 1000, 4097)
    shapes = [(qn, n, d) for qn in sizes for n in sizes for d in (1, 5, 20, 33)]
    shapes += [(65, 4097, 200), (1000, 63, 70)]  # widths above 64: the generic path
    for qn, n, d in shapes:
        q, x = grid_rows(gen, dev, qn, d), grid_rows(gen, dev, n, d)
        # the threshold on a data value: many pairs sit exactly on it
        eps_sq = float(ref.pairwise_sq_l2_ref(q, x).flatten().median())
        labels = torch.randint(0, n, (n,), generator=gen, device=dev, dtype=torch.int32)
        core = torch.rand((n,), generator=gen, device=dev) < 0.5
        worst = max(worst, compare_eps(q, x, labels, core, eps_sq, f"{(qn, n, d)}"))
        n_cases += 1

    from repro_torch.kernels.eps_graph import eps_min_label_cuda, eps_nearest_core_cuda

    d, n = 5, 300  # 300 rows: two full tiles of 128 and a ragged one
    x = 40.0 + grid_rows(gen, dev, n, d)
    unit = torch.eye(d, device=dev)
    x[2], x[5], x[140], x[290] = unit[2], unit[0], -unit[0], unit[1]  # all at d2 = 1
    core = torch.ones(n, dtype=torch.bool, device=dev)
    core[2] = False  # the earliest tied row is not core
    labels = torch.arange(n, 0, -1, dtype=torch.int32, device=dev)  # later rows smaller
    q = torch.zeros((3, d), device=dev)
    q[2] = -3.0  # no core row within eps of this query
    worst = max(worst, compare_eps(q, x, labels, core, 1.0, "exact ties"))
    _, kn = eps_nearest_core_cuda(q, x, labels, core)
    require(kn[:2].tolist() == [labels[5].item()] * 2, "K5: the first tied core index must win")
    kl = eps_min_label_cuda(q, x, labels, core, 1.0)
    require(kl[:2].tolist() == [labels[290].item()] * 2 and kl[2].item() == n,
            "K4: min label over the tied rows, sentinel N without a core neighbour")
    for what, mask in (("all core", torch.ones(n, dtype=torch.bool, device=dev)),
                       ("no core", torch.zeros(n, dtype=torch.bool, device=dev))):
        worst = max(worst, compare_eps(q, x, labels, mask, 1.0, what))
    kd, kn = eps_nearest_core_cuda(q, x, labels, torch.zeros(n, dtype=torch.bool, device=dev))
    require(bool(torch.isinf(kd).all()) and bool((kn == n).all()), "K5: (+inf, N) without core")
    n_cases += 4

    from repro_torch.kernels.eps_graph import CHUNK, eps_count_cuda

    # K3-K5 merge column chunks of CHUNK columns: core rows tied at d2 = 1
    # at compact positions 0, CHUNK and 2 CHUNK + 5 (K4/K5) and rows 0, 1,
    # CHUNK + 1 and 2 CHUNK + 6 (K3), a non-core row tied ahead of them
    for d in (5, 20):
        n = 3 * CHUNK + 77
        x = 40.0 + grid_rows(gen, dev, n, d)
        unit = torch.eye(d, device=dev)
        tied = [1, CHUNK + 1, 2 * CHUNK + 6]
        x[0], x[tied[0]], x[tied[1]], x[tied[2]] = unit[2], unit[0], -unit[0], unit[1]
        core = torch.ones(n, dtype=torch.bool, device=dev)
        core[0] = False
        labels = torch.arange(n, 0, -1, dtype=torch.int32, device=dev)
        q = torch.zeros((3, d), device=dev)
        q[2] = -3.0
        worst = max(worst, compare_eps(q, x, labels, core, 1.0, f"ties across chunks D={d}"))
        _, kn = eps_nearest_core_cuda(q, x, labels, core)
        kl = eps_min_label_cuda(q, x, labels, core, 1.0)
        require(kn[:2].tolist() == [labels[tied[0]].item()] * 2,
                "K5: the first tied core index must win across column chunks")
        require(kl.tolist() == [labels[tied[2]].item()] * 2 + [n],
                "K4: min label over tied rows in three column chunks")
        kc = eps_count_cuda(q, x, 1.0)
        require(kc.tolist() == [4, 4, 0] and eps_count_cuda.grid == (1, 4),
                "K3: the four rows on the threshold in three column chunks, grid (1, 4)")
        n_cases += 1
    log(f"[K3-K5] {n_cases} cases match the plain versions exactly on the card "
        f"(unit-scale rows on a 1/8 grid, Q and N in {sizes}, D in (1, 5, 20, 33, 70, "
        "200), eps_sq on a data value; exact d2 ties for K5's first-index rule; a "
        "query with no core neighbour; all core and no core; N = 300, not a multiple "
        f"of the 128-row tile; K3-K5 ties in three column chunks of {CHUNK} "
        f"columns at D = 5 and 20); max K5 |d2 kernel - plain| = {worst:.3e}")
    return worst


def band(qq, xx):
    """Per pair, 8 ulp of ||q||^2 + ||x||^2 (f64, (Q, N)): how far two
    correct f32 expansions of the same d2 may lie apart."""
    return 8.0 * 2.0 ** -23 * (qq[:, None] + xx[None, :])


def check_eps_data(name, x, eps, min_pts, *, rows: int = 2048, seed: int = SEED) -> dict:
    """Phase 4b: ``rows`` rows of a full dataset against the whole dataset.

    Where the exact d2 of a pair lies within ``band`` of eps_sq, the kernel
    and the plain version may decide it differently.  So, per query:

    * K3's count lies in [plain count at eps_sq - band, at eps_sq + band];
    * K4's label lies in [plain min label over the core neighbours within
      eps_sq + band, within eps_sq - band] (K4's edge set up to in-band
      pairs);
    * K5's d2 is the plain minimum within the K2 tolerance, and the plain d2
      of the row whose label K5 returns is within that tolerance of it
      (labels are the row indices here, so a label names one row).

    The core mask and labels fed to K4/K5 are a real first sweep's: core
    from a full K3 pass, labels0 = the row index of each core row."""
    import numpy as np
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.eps_graph import (
        eps_count_cuda,
        eps_min_label_cuda,
        eps_nearest_core_cuda,
    )

    dev = x.device
    n = x.shape[0]
    eps_sq = float(np.float32(eps) ** 2)
    core = eps_count_cuda(x, x, eps_sq) >= min_pts
    labels = torch.where(core, torch.arange(n, dtype=torch.int32, device=dev), n).to(torch.int32)
    pick = np.random.default_rng(seed).choice(n, rows, replace=False)
    q = x[torch.from_numpy(pick).to(dev)]
    kc = eps_count_cuda(q, x, eps_sq).long()
    kl = eps_min_label_cuda(q, x, labels, core, eps_sq).long()
    kd, kn = eps_nearest_core_cuda(q, x, labels, core)
    kn = kn.long()

    qq = (q.double() ** 2).sum(1)
    big = n  # the sentinel
    cnt = torch.zeros(rows, dtype=torch.long, device=dev)
    cnt_lo, cnt_hi = cnt.clone(), cnt.clone()
    lab = torch.full((rows,), big, dtype=torch.long, device=dev)
    lab_lo, lab_hi = lab.clone(), lab.clone()  # over edges within -band, +band
    near_d = torch.full((rows,), float("inf"), device=dev)
    near_j = torch.full((rows,), big, dtype=torch.long, device=dev)
    d_at_k = torch.full((rows,), float("inf"), dtype=torch.float64, device=dev)
    chunk = 1 << 16
    for c0 in range(0, n, chunk):
        xc = x[c0:c0 + chunk]
        d2 = ref.pairwise_sq_l2_ref(q, xc)
        d2d = d2.double()
        bd = band(qq, (xc.double() ** 2).sum(1))
        lo, hi = d2d <= eps_sq - bd, d2d <= eps_sq + bd
        cnt += (d2 <= eps_sq).sum(1)
        cnt_lo += lo.sum(1)
        cnt_hi += hi.sum(1)
        cc = core[c0:c0 + chunk][None, :]
        lc = labels[c0:c0 + chunk].long()[None, :]
        lab = torch.minimum(lab, torch.where((d2 <= eps_sq) & cc, lc, big).min(1).values)
        lab_lo = torch.minimum(lab_lo, torch.where(lo & cc, lc, big).min(1).values)
        lab_hi = torch.minimum(lab_hi, torch.where(hi & cc, lc, big).min(1).values)
        dm = torch.where(cc, d2, float("inf"))
        j = torch.argmin(dm, 1)
        v = torch.gather(dm, 1, j[:, None])[:, 0]
        better = v < near_d  # strict: the earlier chunk keeps a tie
        near_d = torch.where(better, v, near_d)
        near_j = torch.where(better, j + c0, near_j)
        inside = (kn >= c0) & (kn < c0 + xc.shape[0])
        if bool(inside.any()):
            r = torch.nonzero(inside)[:, 0]
            d_at_k[r] = d2d[r, kn[r] - c0]
    pn = torch.where(torch.isinf(near_d), big, labels.long()[near_j.clamp_max(n - 1)])
    torch.cuda.synchronize()
    require(bool(((kc >= cnt_lo) & (kc <= cnt_hi)).all()),
            f"K3 {name}: a count outside the in-band interval")
    require(bool(((kl >= lab_hi) & (kl <= lab_lo)).all()),
            f"K4 {name}: a label outside the in-band interval")
    xx = float((x.double() ** 2).sum(1).max())
    tol = 1e-5 + 1e-5 * (qq + xx)
    fin = torch.isfinite(near_d)
    require(torch.equal(fin, torch.isfinite(kd)), f"K5 {name}: +inf differs")
    err = torch.where(fin, (kd.double() - near_d.double()).abs(), 0.0)
    require(bool((err <= tol).all()), f"K5 {name}: d2 off the plain minimum")
    require(bool((torch.where(fin, d_at_k - near_d.double(), 0.0) <= tol).all()),
            f"K5 {name}: the returned row is not a nearest core row up to rounding")
    out = dict(
        core_share=float(core.float().mean()), in_band_queries=int((cnt_lo < cnt_hi).sum()),
        k3_differ=int((kc != cnt).sum()), k3_max=int((kc - cnt).abs().max()),
        k4_differ=int((kl != lab).sum()), k4_max=int((kl - lab).abs().max()),
        k5_label_differ=int((kn != pn).sum()),
        k5_max_d2_err=float(err.max()),
    )
    log(f"[K3-K5] {name}: {rows} rows x {n} x {x.shape[1]} against the plain versions "
        f"under the in-band rule (band = 8 ulp of ||q||^2 + ||x||^2 per pair): "
        f"{out['in_band_queries']} queries have an in-band pair; K3 counts differ on "
        f"{out['k3_differ']} (max {out['k3_max']}), K4 labels on {out['k4_differ']}, "
        f"K5 labels on {out['k5_label_differ']} (each explained), max K5 |d2 kernel - "
        f"plain| = {out['k5_max_d2_err']:.3e}; core share {out['core_share']:.4f}")
    return out


# --------------------------------------------------------------------------
# phase 5: the baseline slice
# --------------------------------------------------------------------------

class BruteForce:
    """Exact kNN on the card, independent of the port's search: chunked
    plain distances, then ``torch.topk``; returns f64 exact squared
    distances for the checks.  With a ``route`` (``Route``), each query
    sees only the rows the route allows it: the brute force of a
    forest-mode search."""

    def __init__(self, x, q, *, route=None, k: int = K, rel: float = 1e-6):
        import torch

        from repro_torch.kernels import ref

        self.x, self.q, self.route, self.rel = x, q, route, rel
        best_d = torch.full((q.shape[0], 0), float("inf"), device=q.device)
        best_i = torch.zeros((q.shape[0], 0), dtype=torch.int64, device=q.device)
        chunk = 1 << 16
        for lo in range(0, x.shape[0], chunk):
            d2 = ref.pairwise_sq_l2_ref(q, x[lo:lo + chunk])
            if route is not None:
                cols = torch.arange(lo, lo + d2.shape[1], device=q.device)
                d2 = torch.where(route.allows(cols[None, :].expand(q.shape[0], -1)), d2,
                                 float("inf"))
            vd, vi = torch.topk(d2, min(k, d2.shape[1]), dim=1, largest=False)
            best_d = torch.cat([best_d, vd], 1)
            best_i = torch.cat([best_i, vi + lo], 1)
            best_d, pos = torch.topk(best_d, min(k, best_d.shape[1]), dim=1, largest=False)
            best_i = torch.gather(best_i, 1, pos)
        # a query routed to fewer than k rows gets id -1 past them
        require(route is not None or bool(torch.isfinite(best_d).all()), "fewer than k rows")
        self.ids = torch.where(torch.isfinite(best_d), best_i, -1)
        self.d2 = self.exact_d2(self.ids)
        self.kth = self.d2.max(dim=1).values
        self.kth_tol = self.tol(self.ids).max(dim=1).values

    def exact_d2(self, ids):
        """f64 squared distances of the rows ``ids`` to their queries."""
        import torch

        xs = self.x[ids.clamp_min(0).long()].double()
        d2 = ((xs - self.q.double()[:, None, :]) ** 2).sum(-1)
        return torch.where(ids >= 0, d2, torch.full_like(d2, float("inf")))

    def tol(self, ids):
        """Rounding allowed in an f32 squared distance computed by the
        expansion: ``rel`` * (||q||^2 + ||x||^2), by default 1e-6, about 8
        ulp of the norms (the standing rule at D <= 20)."""
        xs = self.x[ids.clamp_min(0).long()].double()
        return self.rel * ((xs ** 2).sum(-1) + (self.q.double() ** 2).sum(1)[:, None])


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
    require(bool((ids_t >= 0).all()), "missing ids (every dataset here holds more than k rows)")
    exact = bf.exact_d2(ids_t)
    tol = bf.tol(ids_t)
    tie_recall = share(exact <= (bf.kth + bf.kth_tol)[:, None] + tol)
    ref_ids = (truth or bf).ids
    recall = float((ids_t[:, :, None] == ref_ids[:, None, :]).any(-1).double().mean())
    floor = 1.0 if truth is None else 0.99
    require(tie_recall >= floor, f"recall {tie_recall} < {floor} up to ties")
    derr = (d_t ** 2 - exact).abs()
    require(bool((derr <= tol).all()), "distances off the exact ones")
    uniq = all(len(set(r)) == len(r) for r in ids_t.tolist())
    require(uniq, "duplicate ids")
    return dict(recall=recall, recall_ties=tie_recall, max_d2_err=float(derr.max()))


def share(mask) -> float:
    """The share of True in a bool tensor, exactly 1.0 when all are (a
    device mean may round n * (1/n) below 1)."""
    return int(mask.sum()) / mask.numel()


def make_queries(x, seed: int):
    import numpy as np

    g = np.random.default_rng(seed)
    base = x[g.choice(len(x), NQ, replace=False)]
    noise = g.normal(size=base.shape) * 0.05 * x.std(axis=0)
    return (base + noise).astype(np.float32)


DATASETS = [("WARD", "ward_like", 1_000_000, 1000), ("Tracking", "tracking_like", 62_702, None)]


def make_data() -> dict:
    """The paper's two datasets at full size (synthetic, from their seeds)."""
    from repro_torch.data import synthetic

    data = {}
    for name, gen, n, _ in DATASETS:
        t0 = time.perf_counter()
        data[name] = getattr(synthetic, gen)(n)
        log(f"[data] {name}: x {data[name].shape} made in {time.perf_counter() - t0:.1f} s")
    return data


def run_slice(dev, data) -> dict:
    """Build both datasets' baselines and search them; returns what the later
    phases and the summary need.  The launch counters are reset just before
    the searches and read just after them."""
    import torch

    from repro_torch.api import Config, IndexConfig, OverlapIndex, SearchConfig
    from repro_torch.kernels import ops

    built = {}
    for name, _, _, c_max in DATASETS:
        x = data[name]
        idx = {}
        for quantize in (False, True):
            cfg = Config(index=IndexConfig(pivot_method="kmeans", c_max=c_max),
                         search=SearchConfig(quantize=quantize))
            t0 = time.perf_counter()
            idx[quantize] = OverlapIndex.baseline(x, cfg, device=dev)
            t_build = time.perf_counter() - t0
        f = idx[False].forest
        log(f"[slice] {name}: baseline build "
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
    require(launches["bucket_scan_topk"] == len(results),
            "K1 must launch once per scan phase: once per search without a delta")
    require(launches["pairwise_sq_l2"] > 0, "K2 never launched in the searches")
    syncs = {(name, quantize, beam): count_syncs(
        lambda: built[name]["idx"][quantize].search(built[name]["q"], k=K, beam=beam))
        for name, quantize, beam, _, _ in results}

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
            f"{st['distances'].mean():.1f}, host syncs per search="
            f"{syncs[(name, quantize, beam)]}, {what}")
        require(syncs[(name, quantize, beam)] <= 2,
                "a search synchronises more than to copy its queries in and results out")
    return dict(built=built, launches=launches, results=results, syncs=syncs)


def count_syncs(fn) -> int:
    """Host-device synchronisations of one call of ``fn``: the operations
    that torch's sync debug mode reports (copies to and from pageable host
    memory, ``.item()``, ``nonzero``, ...)."""
    import warnings

    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchronizing" in str(w.message) for w in caught)


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
# phases 6-7: the overlap build and its searches
# --------------------------------------------------------------------------

# The repo's full-size configurations (benchmarks/common.py, load_datasets
# with full=True), and the tests' blob set with the thresholds of
# tests/test_torch_search.py's OVERLAP_CFG, whose forest has overlap indexes
# and neighbour links.
BUILD_CFG = {
    "Tracking": dict(eps=6.0, min_pts=16, xi_min=0.4, xi_max=0.8, c_max=250),
    "WARD": dict(eps=2.0, min_pts=23, xi_min=0.4, xi_max=0.8, c_max=1000),
    "Blob": dict(eps=1.5, min_pts=8, xi_min=0.1, xi_max=0.7),
}
BUILDS = [("Tracking", "vbm"), ("Tracking", "dbm"), ("Tracking", "obm"),
          ("WARD", "vbm"), ("Blob", "vbm")]
# The JAX package's structure on the same arrays, (n_clusters, DBSCAN
# iterations, n_indexes, n_overlap_indexes), from a CPU run of
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -c "
#   from repro.api import OverlapIndex, Config, IndexConfig
#   from repro.data.synthetic import tracking_like
#   x = tracking_like(62702)
#   for m in ('vbm', 'dbm', 'obm'):
#       r = OverlapIndex.build(x, Config(index=IndexConfig(method=m, eps=6.0,
#           min_pts=16, xi_min=0.4, xi_max=0.8, c_max=250))).build_report
#       print(m, r.n_clusters, r.detail['dbscan_iterations'], r.n_indexes,
#             r.n_overlap_indexes)"
# and the same for ("Blob", "vbm") on blob_rows() with BUILD_CFG["Blob"].
JAX_STRUCTURE = {
    ("Tracking", "vbm"): (24, 3, 24, 0),
    ("Tracking", "dbm"): (24, 3, 1, 0),
    ("Tracking", "obm"): (24, 3, 1, 0),
    ("Blob", "vbm"): (5, 4, 7, 3),
}
# WARD VBM's structure on the card, from an earlier chip_smoke.py run
# recorded in PERF.md (the JAX package does not build WARD at this size on
# the CPU): a change of the DBSCAN kernels must not move it.
CARD_STRUCTURE = {("WARD", "vbm"): (13, 6, 12, 0)}


def blob_rows():
    """tests/conftest.py's blob_data: five Gaussian clusters and uniform
    noise, 2,100 x 8."""
    import numpy as np

    g = np.random.default_rng(7)
    centers = g.normal(size=(5, 8)) * 10.0
    parts = [c + g.normal(size=(400, 8)) for c in centers]
    parts.append(g.uniform(-15, 15, size=(100, 8)))
    return np.concatenate(parts).astype(np.float32)


def run_overlap(dev, built, base_results) -> dict:
    """Build every configuration of ``BUILDS`` twice (f32 and int8 bucket
    storage; the two forests must be equal), then search each as phase 5
    searches the baselines.  The launch counters are reset just before the
    first build and read just after the last search."""
    import numpy as np
    import torch

    from repro_torch.api import Config, IndexConfig, OverlapIndex, SearchConfig
    from repro_torch.core.forest import FOREST_FIELDS
    from repro_torch.kernels import ops

    blob = blob_rows()
    qb = torch.from_numpy(make_queries(blob, SEED + 7)).to(dev)
    xb = torch.from_numpy(blob).to(dev)
    xq, scale = ops.quantize_datastore(xb)
    sets = dict(built)
    sets["Blob"] = dict(x=blob, q=qb.cpu().numpy(), bf=BruteForce(xb, qb),
                        bf_int8=BruteForce(xq.float() * scale[:, None], qb))

    ops.reset_launch_counts()
    builds = {}
    for name, method in BUILDS:
        x = sets[name]["x"]
        idx, rows = {}, {}
        for quantize in (False, True):
            cfg = Config(index=IndexConfig(method=method, **BUILD_CFG[name]),
                         search=SearchConfig(quantize=quantize))
            before = ops.launch_counts()
            t0 = time.perf_counter()
            ix = OverlapIndex.build(x, cfg, device=dev)
            t_build = time.perf_counter() - t0
            launched = {k: v - before[k] for k, v in ops.launch_counts().items()}
            t0 = time.perf_counter()
            ix.device  # the upload
            torch.cuda.synchronize()
            t_upload = time.perf_counter() - t0
            idx[quantize] = ix
            rows[quantize] = dict(build_s=t_build, upload_s=t_upload, launched=launched,
                                  phase_s=dict(ix.build_report.phase_s))
        f0, f1 = idx[False].forest, idx[True].forest
        require(all(np.array_equal(getattr(f0, k), getattr(f1, k)) for k in FOREST_FIELDS),
                f"{name} {method}: two builds of the same input differ")
        rep = idx[False].build_report
        r0 = rows[False]
        structure = (rep.n_clusters, rep.detail["dbscan_iterations"], rep.n_indexes,
                     rep.n_overlap_indexes)
        links = int((f0.neighbors >= 0).sum())
        log(f"[build] {name} {x.shape[0]} x {x.shape[1]} {method}: n_clusters="
            f"{rep.n_clusters}, DBSCAN iterations={rep.detail['dbscan_iterations']}, "
            f"n_indexes={rep.n_indexes}, n_overlap_indexes={rep.n_overlap_indexes}, "
            f"neighbour links={links}, buckets={f0.n_buckets} (C={f0.c_max}); decision "
            f"{rep.detail['decision']}; seconds: DBSCAN {r0['phase_s']['dbscan']:.2f}, "
            f"overlap+decide {r0['phase_s']['decide']:.2f}, forest "
            f"{r0['phase_s']['forest']:.2f}, upload {r0['upload_s']:.2f} (build "
            f"{r0['build_s']:.2f}; the int8 twin {rows[True]['build_s']:.2f}); kernel "
            f"launches in the build {r0['launched']}")
        want = JAX_STRUCTURE.get((name, method))
        if want is not None:
            require(structure == want,
                    f"{name} {method}: structure {structure} differs from the JAX package's {want}")
            log(f"[build] {name} {method}: structure equals the JAX package's {want}")
        want = CARD_STRUCTURE.get((name, method))
        if want is not None:
            require(structure == want,
                    f"{name} {method}: structure {structure} differs from the earlier card run's {want}")
            log(f"[build] {name} {method}: structure equals the earlier card run's {want}")
        launched = r0["launched"]
        require(launched["eps_count"] == 1 and launched["eps_nearest_core"] == 1
                and launched["eps_min_label"] == rep.detail["dbscan_iterations"],
                f"{name} {method}: K3/K4/K5 launches {launched} per build, want 1 / "
                f"{rep.detail['dbscan_iterations']} (one per sweep) / 1")
        builds[(name, method)] = dict(idx=idx, rows=rows, structure=structure, links=links,
                                      decision=dict(rep.detail["decision"]))

    base = {(n, qz, bm): res for n, qz, bm, res, _ in base_results}
    searches = []
    for (name, method), bd in builds.items():
        b = sets[name]
        route = Route(bd["idx"][False], b["bf"].q)
        routed = dict(bf=BruteForce(b["bf"].x, b["bf"].q, route=route),
                      bf_int8=BruteForce(b["bf_int8"].x, b["bf"].q, route=route))
        log(f"[search] {name} {method}: {route.ambiguous} of {NQ} routings are near ties "
            "of two centers")
        for beam in (1, 4):  # warm-up: each plan's first search, untimed
            for mode in ("forest", "all"):
                for quantize in (False, True):
                    bd["idx"][quantize].search(b["q"], k=K, beam=beam, mode=mode)
        torch.cuda.synchronize()
        for beam in (1, 4):
            for mode in ("forest", "all"):
                for quantize in (False, True):
                    t0 = time.perf_counter()
                    res = bd["idx"][quantize].search(b["q"], k=K, beam=beam, mode=mode)
                    wall = time.perf_counter() - t0
                    if mode == "forest":
                        bf = routed["bf_int8" if quantize else "bf"]
                        chk = check_forest(bf, res.dists, res.ids,
                                           truth=routed["bf"] if quantize else None)
                        what = (f"routed rows nearer than the k-th found: {chk['routed_found']:.4f}"
                                f" ({'int8 rows' if quantize else 'f32'}); {chk['short']} queries "
                                f"routed to fewer than {K} rows; {chk['outside']:.4f} of the "
                                f"results from unrouted buckets; routed-row recall "
                                f"{chk['recall']:.4f}")
                    elif quantize:
                        chk = check_result(b["bf_int8"], res.dists, res.ids, truth=b["bf"])
                        what = (f"recall vs the stored int8 rows up to ties="
                                f"{chk['recall_ties']:.4f}, vs the f32 rows={chk['recall']:.4f}")
                    else:
                        chk = check_result(b["bf"], res.dists, res.ids)
                        what = f"recall={chk['recall']:.4f}, up to ties={chk['recall_ties']:.4f}"
                    ids_t = torch.as_tensor(res.ids, device=dev).long()
                    full = b["bf"].ids
                    chk["recall_all"] = float(
                        (full[:, :, None] == ids_t[:, None, :]).any(-1).double().mean())
                    what += f"; recall against all rows={chk['recall_all']:.4f}"
                    st = res.stats
                    row = dict(dataset=name, method=method, mode=mode, quantize=quantize,
                               beam=beam, us_per_query=wall / NQ * 1e6, steps=int(st["steps"]),
                               buckets_visited=float(st["buckets_visited"].mean()),
                               distances=float(st["distances"].mean()), **chk)
                    bl = base.get((name, quantize, beam))
                    if bl is not None:
                        row.update(base_buckets_visited=float(bl.stats["buckets_visited"].mean()),
                                   base_distances=float(bl.stats["distances"].mean()),
                                   base_steps=int(bl.stats["steps"]))
                        what += (f"; baseline on the same queries: buckets_visited "
                                 f"{row['base_buckets_visited']:.2f}, distances "
                                 f"{row['base_distances']:.1f}, steps {row['base_steps']}")
                    searches.append(row)
                    log(f"[search] {name} {method} {mode} {'int8' if quantize else 'f32 '} "
                        f"beam={beam}: {row['us_per_query']:.1f} us/query, steps={row['steps']}, "
                        f"mean buckets_visited={row['buckets_visited']:.2f}, mean distances="
                        f"{row['distances']:.1f}, {what}")
    launches = ops.launch_counts()
    log(f"[overlap] launch counts over the {len(BUILDS) * 2} builds and "
        f"{len(searches)} searches: {launches}")
    overlap_path = ("pairwise_sq_l2", "bucket_scan_topk", "eps_count", "eps_min_label",
                    "eps_nearest_core")
    require(all(launches[k] > 0 for k in overlap_path),
            "a kernel of the overlap path never launched")
    return dict(builds=builds, searches=searches, launches=launches)


class Route:
    """The routed rows of a forest-mode search (Alg. 2), per query: the rows
    of its closest index and of that index's overlap neighbours, in their
    buckets and in their delta buffers (``ix.delta``, where it has one).
    The closest index is the argmin of the K2 distances to the index
    centers, as the search takes it; where the plain distances pick another
    index, the two centers must be tied up to the K2 tolerance."""

    def __init__(self, ix, q):
        import numpy as np
        import torch

        from repro_torch.kernels import ops, ref

        f = ix.forest
        dev = q.device
        centers = torch.from_numpy(f.index_centers).to(dev)
        dk = ops.pairwise_sq_l2(q, centers)
        dp = ref.pairwise_sq_l2_ref(q, centers)
        closest = torch.argmin(dk, 1)
        alt = torch.argmin(dp, 1)
        gap = (torch.gather(dp, 1, closest[:, None]) - torch.gather(dp, 1, alt[:, None]))[:, 0]
        tol = torch.gather(k2_tol(q, centers), 1, closest[:, None])[:, 0]
        self.ambiguous = int((closest != alt).sum())
        require(bool((gap <= 2 * tol).all()), "routing: the K2 argmin is no nearest center")
        qn = q.shape[0]
        eligible = np.zeros((qn, f.n_indexes), bool)
        cl = closest.cpu().numpy()
        eligible[np.arange(qn), cl] = True
        nbrs = f.neighbors[cl]
        r, c = np.nonzero(nbrs >= 0)
        eligible[r, nbrs[r, c]] = True
        owner = np.full(len(ix.x_all), -1, np.int64)
        live = f.bucket_ids >= 0
        owner[f.bucket_ids[live]] = np.broadcast_to(f.bucket_index[:, None], live.shape)[live]
        if getattr(ix, "delta", None) is not None:
            d_ids = ix.delta.ids.cpu().numpy()
            d_live = np.arange(d_ids.shape[1])[None, :] < ix.delta.count.cpu().numpy()[:, None]
            owner[d_ids[d_live]] = np.broadcast_to(
                np.arange(len(d_ids))[:, None], d_live.shape)[d_live]
        require(bool((owner >= 0).all()), "a row lies in no bucket or delta buffer")
        self.eligible = torch.from_numpy(eligible).to(dev)
        self.owner = torch.from_numpy(owner).to(dev)

    def allows(self, ids):
        """(Q, m) bool for (Q, m) row ids."""
        import torch

        return torch.gather(self.eligible, 1, self.owner[ids])


def check_forest(bf: BruteForce, dists, ids, *, truth: BruteForce | None = None) -> dict:
    """Hold a forest-mode result against the brute force over its routed
    rows (``bf`` with a ``Route``).

    The bounded scan visits every routed bucket whose lower bound is <= the
    running k-th best, so every routed row nearer than the returned k-th
    distance is returned (``routed_found`` must be 1 for f32 rows, 0.99 for
    int8 rows, whose bounds are not exact: see ``check_result``).  Rows of
    other indexes may come back too: their buckets' bound is +inf, which is
    <= the k-th best while fewer than k rows are found, so a step that
    starts short of k (the first, or any of a query whose routed rows are
    fewer than k) scans them in row order.  Every returned distance must be
    the exact one to the f32 rounding, and no id may repeat."""
    import torch

    dev = bf.q.device
    ids_t = torch.as_tensor(ids, device=dev).long()
    d_t = torch.as_tensor(dists, device=dev).double()
    require(bool((ids_t >= 0).all()), "missing ids (every dataset here holds more than k rows)")
    exact = bf.exact_d2(ids_t)
    tol = bf.tol(ids_t)
    over = float(((d_t ** 2 - exact).abs() / tol).max())
    require(over <= 1.0, f"distances off the exact ones: up to {over:.2f} x the tolerance")
    require(all(len(set(r)) == len(r) for r in ids_t.tolist()), "duplicate ids")
    kth = exact.max(1).values
    live = bf.ids >= 0
    nearer = live & (bf.d2 < (kth[:, None] - bf.tol(bf.ids)))
    got = (bf.ids[:, :, None] == ids_t[:, None, :]).any(-1)
    found = share(got[nearer]) if bool(nearer.any()) else 1.0
    floor = 1.0 if truth is None else 0.99
    require(found >= floor, f"routed rows nearer than the k-th missing: {found} < {floor}")
    outside = ~bf.route.allows(ids_t)
    ref_ids = (truth or bf).ids
    ref_live = ref_ids >= 0
    recall = float((ref_ids[:, :, None] == ids_t[:, None, :]).any(-1)[ref_live].double().mean())
    return dict(routed_found=found, recall=recall, outside=float(outside.double().mean()),
                short=int((~live).any(1).sum()),
                max_d2_err=float((d_t ** 2 - exact).abs().max()))


def check_dbscan(x, eps: float, min_pts: int) -> dict:
    """Tracking's DBSCAN through the kernel path and the plain path on the
    card, held to the whole-DBSCAN rule.

    A pair whose exact d2 lies within ``band`` of eps_sq may be decided
    either way by two correct f32 implementations.  So each run must be a
    valid DBSCAN of the data for SOME decision of its in-band pairs, checked
    against plain distances with the band (``lo``: d2 <= eps_sq - band, a
    certain edge; ``hi``: d2 <= eps_sq + band, a possible one):

    1. every core point has >= min_pts possible neighbours, every other
       point < min_pts certain ones;
    2. core points joined by a certain edge share a label;
    3. each cluster's core points lie in one connected component of the
       possible edges among the run's core points;
    4. a labelled border point has a core point of its label within the
       possible radius that is its nearest core point up to the band; a noise
       point has no core point within the certain radius.

    Any point where the two runs differ (label up to renaming, or core flag)
    is then explained by in-band pairs.  The run fails on any violation."""
    import numpy as np
    import torch

    from repro_torch.core.dbscan import dbscan
    from repro_torch.kernels import ref

    dev = x.device
    n = x.shape[0]
    eps_sq = float(np.float32(eps) ** 2)
    t0 = time.perf_counter()
    rk = dbscan(x, eps, min_pts)
    t_k = time.perf_counter() - t0
    t0 = time.perf_counter()
    rp = dbscan(x, eps, min_pts, kernel=False)
    t_p = time.perf_counter() - t0

    xx = (x.double() ** 2).sum(1)
    block = 2048

    def blocks():
        for lo in range(0, n, block):
            d2 = ref.pairwise_sq_l2_ref(x[lo:lo + block], x).double()
            bd = band(xx[lo:lo + block], xx)
            yield lo, d2 - bd, d2 + bd  # the exact d2 lies between

    cnt_lo = torch.zeros(n, dtype=torch.long, device=dev)
    cnt_hi = torch.zeros(n, dtype=torch.long, device=dev)
    for lo, dlo, dhi in blocks():
        cnt_lo[lo:lo + block] = (dhi <= eps_sq).sum(1)  # certainly within eps
        cnt_hi[lo:lo + block] = (dlo <= eps_sq).sum(1)  # possibly within eps

    def validate(res, what):
        lab = torch.from_numpy(res.labels).to(dev).long()
        core = torch.from_numpy(res.core_mask).to(dev)
        require(bool((cnt_hi[core] >= min_pts).all()) and bool((cnt_lo[~core] < min_pts).all()),
                f"{what}: a core flag no decision of the in-band pairs explains")
        big = torch.iinfo(torch.long).max
        # 2: certain edges between core points join equal labels
        # 3: components of the possible edges among core points
        comp = torch.where(core, torch.arange(n, device=dev), big)
        sweeps = 0
        while True:
            new = comp.clone()
            for lo, dlo, dhi in blocks():
                cc = core[None, :] & core[lo:lo + block, None]
                certain = (dhi <= eps_sq) & cc
                lab_b = lab[None, :].expand(certain.shape[0], -1)
                if sweeps == 0:
                    mn = torch.where(certain, lab_b, big).min(1).values
                    mx = torch.where(certain, lab_b, -1).max(1).values
                    own = lab[lo:lo + block]
                    has = certain.any(1)
                    require(bool(((mn == own) & (mx == own))[has].all()),
                            f"{what}: a certain core-core edge joins two labels")
                possible = (dlo <= eps_sq) & cc
                m = torch.where(possible, comp[None, :], big).min(1).values
                new[lo:lo + block] = torch.minimum(new[lo:lo + block], m)
            for _ in range(3):  # pointer jumping: a core entry names a core row
                new = torch.where(core, torch.minimum(new, new[torch.where(core, new, 0)]), new)
            sweeps += 1
            if torch.equal(new, comp):
                break
            comp = new
        cl = lab[core]
        cm = comp[core]
        k = int(cl.max()) + 1 if cl.numel() else 0
        lo_c = torch.full((k,), big, device=dev).scatter_reduce(0, cl, cm, "amin")
        hi_c = torch.full((k,), -1, device=dev).scatter_reduce(0, cl, cm, "amax")
        require(bool((lo_c == hi_c).all()),
                f"{what}: a cluster spans two components of the possible edges")
        # 4: border and noise points
        for lo, dlo, dhi in blocks():
            rows = torch.arange(lo, min(lo + block, n), device=dev)
            nc = ~core[rows]
            if not bool(nc.any()):
                continue
            cc = core[None, :]
            inf = float("inf")
            near_hi = torch.where(cc, dhi, inf).min(1).values
            same = cc & (lab[None, :] == lab[rows][:, None])
            near_same_lo = torch.where(same, dlo, inf).min(1).values
            labelled = nc & (lab[rows] >= 0)
            noise = nc & (lab[rows] < 0)
            require(bool((near_same_lo[labelled] <= eps_sq).all())
                    and bool((near_same_lo[labelled] <= near_hi[labelled]).all()),
                    f"{what}: a border label no nearest core point within eps explains")
            require(bool((near_hi[noise] > eps_sq).all()),
                    f"{what}: a noise point with a core point certainly within eps")
        return sweeps

    sk = validate(rk, "kernel path")
    sp = validate(rp, "plain path")
    # the two runs side by side: labels up to renaming, core flags
    both = (rk.labels >= 0) & (rp.labels >= 0)
    pairs = np.unique(np.stack([rk.labels[both], rp.labels[both]]), axis=1)
    one_to_one = (len(np.unique(pairs[0])) == pairs.shape[1]
                  and len(np.unique(pairs[1])) == pairs.shape[1])
    mapping = dict(zip(pairs[0].tolist(), pairs[1].tolist())) if one_to_one else {}
    mapped = np.array([mapping.get(v, -2) if v >= 0 else -1 for v in rk.labels.tolist()])
    lab_diff = int((mapped != rp.labels).sum()) if one_to_one else -1
    core_diff = int((rk.core_mask != rp.core_mask).sum())
    in_band = (cnt_lo < cnt_hi).cpu().numpy()
    out = dict(kernel_s=t_k, plain_s=t_p, n_clusters=(rk.n_clusters, rp.n_clusters),
               iterations=(rk.n_iterations, rp.n_iterations), label_differ=lab_diff,
               core_differ=core_diff, in_band_points=int(in_band.sum()),
               clusters_one_to_one=one_to_one)
    log(f"[dbscan] Tracking kernel path {t_k:.2f} s vs plain path {t_p:.2f} s on the card: "
        f"n_clusters {rk.n_clusters} / {rp.n_clusters}, iterations {rk.n_iterations} / "
        f"{rp.n_iterations}; clusters one to one: {one_to_one}; labels differ (up to "
        f"renaming) on {lab_diff} points, core flags on {core_diff}; {out['in_band_points']} "
        f"points have an in-band pair; both runs pass the whole-DBSCAN rule ({sk} and {sp} "
        "sweeps of the possible-edge components)")
    return out


# --------------------------------------------------------------------------
# phase 8: times
# --------------------------------------------------------------------------

def time_k2(built) -> list[dict]:
    """K2 at the shapes the main path gives it: queries against the bucket
    pivots (bucket_bounds) and against the index centers (routing) of each
    dataset, and at Q = N = 1, whose time is the event-timed floor of a
    launch: the share of each time that the floor accounts for is printed."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.pairwise_l2 import pairwise_sq_l2_cuda

    cases = []
    for name, b in built.items():
        df = b["idx"][False].device
        q = torch.from_numpy(b["q"]).to(df.bucket_pivot.device)
        cases += [(f"{name} bounds", q, df.bucket_pivot), (f"{name} routing", q, df.index_centers)]
    one = cases[0][1][:1]
    cases.append(("floor", one, one))
    rows = []
    floor = None
    for what, q, x in reversed(cases):  # the floor first
        got, want = pairwise_sq_l2_cuda(q, x), ref.pairwise_sq_l2_ref(q, x)
        err = (got.double() - want.double()).abs()
        require(bool((err <= k2_tol(q, x)).all()), f"K2 disagrees at {what}")
        qn, d = q.shape
        n = x.shape[0]
        ms = device_ms(lambda: pairwise_sq_l2_cuda(q, x), reps=21)
        floor = ms if floor is None else floor
        plain = device_ms(lambda: ref.pairwise_sq_l2_ref(q, x), reps=21)
        lib = device_ms(lambda: torch.cdist(q, x).square_(), reps=21)
        nbytes = 4 * (qn * d + n * d + qn * n)
        b_ms, by = bound(nbytes, 2.0 * qn * n * d)
        rows.append(dict(shape=f"{what} Q={qn} N={n} D={d}", ms=ms, plain_ms=plain,
                         library_ms=lib, bound_ms=b_ms, bound_by=by, bytes=nbytes,
                         share=b_ms / ms, floor_ms=floor, max_abs_err=float(err.max())))
        log(f"[time] K2 {what} ({qn} x {n} x {d}): kernel {ms * 1e3:.2f} us ({b_ms / ms:.1%} "
            f"of the bound; the {floor * 1e3:.2f} us launch floor is {floor / ms:.0%} of it), "
            f"plain {plain * 1e3:.1f} us, torch.cdist {lib * 1e3:.1f} us, bound "
            f"{b_ms * 1e3:.2f} us by {by} ({nbytes} B: q, x read once, (Q, N) f32 "
            f"written once)")
    return rows[::-1]


# Per-launch times of K3-K5 at the shapes time_eps uses, and of K6/K7 at
# Q = 8 and 1,024, from an earlier chip_smoke.py run (PERF.md's kernel table;
# NVIDIA H100 80GB HBM3, 700.00 W), each with the design it had then: K3 and
# K7 were redesigned since.  K6's code has not changed, so its time in this
# run (the control) says whether this card runs as that one did.
EARLIER_EPS_MS = {
    ("eps_count", "WARD"): 586.7, ("eps_min_label", "WARD"): 382.6,
    ("eps_nearest_core", "WARD"): 460.5, ("eps_count", "Tracking"): 7.66,
    ("eps_min_label", "Tracking"): 4.09, ("eps_nearest_core", "Tracking"): 4.62,
}
EARLIER_SERVE_MS = {("knn_topk", 8): 1.564, ("knn_topk", 1024): 117.9,
                    ("pairwise_sq_l2_int8", 8): 1.041, ("pairwise_sq_l2_int8", 1024): 113.3}


def k6_control(keys) -> float:
    """K6 at Q = 8 on the serving datastore, ms: the same-run control."""
    from repro_torch.kernels.topk import knn_topk_cuda

    q = retrieval_problem(keys, 8, SEED + 8)
    return device_ms(lambda: knn_topk_cuda(q, keys, SERVE_K), reps=21)


def control_text(k6_ms: float) -> str:
    return (f"control K6 Q=8 {k6_ms:.3f} ms in this run against "
            f"{EARLIER_SERVE_MS[('knn_topk', 8)]:.3f} ms earlier")


def time_eps(built, overlap, smi: str, k6_ms: float) -> list[dict]:
    """K3, K4, K5 at the shapes DBSCAN gives them: all N rows against all N,
    on each full dataset, with the core mask and labels of a first sweep.
    The plain versions run over blocks of 1,024 query rows (a whole (N, N)
    matrix does not fit), which is the plain path's own plan.  The bound
    counts what the pass must do: each of q and x read once, labels and the
    core flag read once, the outputs written once; Q * N' * (2D + 3) f32
    operations (2D for q.x, three for ||q||^2 + ||x||^2 - 2 q.x), N' the
    rows whose distance the pass needs (all N for K3, the core rows for K4
    and K5, which compute only those).  Each row also carries the launch
    grid the kernel reports, its share of the bound, the earlier run's time
    and K6's time in this run (``k6_ms``) as the control."""
    import numpy as np
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.eps_graph import (
        eps_count_cuda,
        eps_min_label_cuda,
        eps_nearest_core_cuda,
    )

    rows = []
    for name in ("WARD", "Tracking"):
        x = torch.from_numpy(built[name]["x"]).to("cuda")
        n, d = x.shape
        cfg = BUILD_CFG[name]
        eps_sq = float(np.float32(cfg["eps"]) ** 2)
        core = eps_count_cuda(x, x, eps_sq) >= cfg["min_pts"]
        labels = torch.where(core, torch.arange(n, dtype=torch.int32, device=x.device), n)
        labels = labels.to(torch.int32)
        n_core = int(core.sum())
        per_build = overlap["builds"][(name, "vbm")]["rows"][False]["launched"]
        blk = 1024

        def plain(fn):
            return lambda: [fn(x[lo:lo + blk]) for lo in range(0, n, blk)]

        cases = [
            ("eps_count", lambda: eps_count_cuda(x, x, eps_sq),
             plain(lambda qb: ref.eps_count_ref(qb, x, eps_sq)), n, 4 * n, eps_count_cuda),
            ("eps_min_label", lambda: eps_min_label_cuda(x, x, labels, core, eps_sq),
             plain(lambda qb: ref.eps_min_label_ref(qb, x, labels, core, eps_sq)),
             n_core, 9 * n, eps_min_label_cuda),
            ("eps_nearest_core", lambda: eps_nearest_core_cuda(x, x, labels, core),
             plain(lambda qb: ref.eps_nearest_core_ref(qb, x, labels, core)),
             n_core, 13 * n, eps_nearest_core_cuda),
        ]
        for kname, kern, pl, cols, extra_bytes, wrapper in cases:
            ms = device_ms(kern, reps=3)
            grid = wrapper.grid
            plain_ms = device_ms(pl, reps=1, warm=False, launches_hint=n // blk)
            nbytes = 4 * 2 * n * d + extra_bytes  # q and x once; labels, flags, outputs
            b_ms, by = bound(nbytes, float(n) * cols * (2 * d + 3))
            earlier = EARLIER_EPS_MS[(kname, name)]
            rows.append(dict(name=kname, shape=f"{name} Q=N={n} D={d}", dataset=name, ms=ms,
                             plain_ms=plain_ms, library_ms=None, bound_ms=b_ms, bound_by=by,
                             share=b_ms / ms, cols=cols, grid=list(grid), earlier_ms=earlier,
                             launches_per_build=per_build[kname], k6_control_ms=k6_ms,
                             card=smi))
            log(f"[time] {kname} {name} ({n} x {n} x {d}, {cols} columns computed) on {smi}: "
                f"kernel {ms:.2f} ms, grid {tuple(grid)}, plain {plain_ms:.2f} ms (blocks "
                f"of {blk} rows), bound {b_ms:.2f} ms by {by} ({b_ms / ms:.1%} of it); "
                f"earlier run (PERF.md) {earlier:.2f} ms; {control_text(k6_ms)}; "
                f"{per_build[kname]} launches in the VBM build")
    return rows


def phase_operands(ix, q, beam: int, k: int = K):
    """The operands the search gives K1's main phase: its route, bounds
    and sorted visit order, computed by the search's own stages."""
    import torch

    from repro_torch.core.knn import bucket_bounds, route_select

    df = ix.device
    qt = torch.from_numpy(q).to(df.bucket_x.device)
    sel, _, _ = route_select(df, qt)
    bounds = bucket_bounds(df, qt, sel, beam=beam)
    count = torch.sum(df.bucket_mask, dim=1, dtype=torch.int32)
    kk = min(k, df.bucket_ids.numel())
    top_d = torch.full((qt.shape[0], kk), float("inf"), device=qt.device)
    top_i = torch.full((qt.shape[0], kk), -1, dtype=torch.int32, device=qt.device)
    return [qt, df.bucket_x, df.bucket_ids, count, bounds.order, bounds.lb_sorted, beam,
            top_d, top_i, df.bucket_scale]


def touched_buckets(args):
    """Buckets the lockstep plain phase makes active (each once), and the
    slots it reads: replays ``ref.bucket_scan_phase_ref`` step by step."""
    import torch

    from repro_torch.kernels import ref

    q, bx, ids, count, order, lb, beam, top_d, top_i, scale = args
    touched = torch.zeros(bx.shape[0], dtype=torch.bool, device=q.device)
    for t in range(order.shape[1] // beam):
        lo = t * beam
        act = lb[:, lo:lo + beam] <= torch.sqrt(top_d[:, -1])[:, None]
        if not bool(act.any()):
            break
        bsel = order[:, lo:lo + beam]
        touched[bsel[act].long()] = True
        top_d, top_i = ref.bucket_scan_topk_ref(q, bx, ids, bsel, act, top_d, top_i, scale)
    return touched


def time_k1(built) -> list[dict]:
    """K1, one launch per search's main phase, on the operands the search
    gives it (WARD and Tracking; f32 beam 1 and 4, int8 beam 1), against the
    plain lockstep phase on the same operands.  The bound counts what the
    phase must move: each distinct bucket it makes active read once (C ids,
    the live members' rows and int8 scales), each query's row, the order
    and bound slots it reads (its steps and the one that stops it), the
    carry in and the outputs; 4 D flops per scored (query, member) pair.
    ``touched_buckets`` replays the plain phase for that set, so the bytes
    are those of the plain phase's data, which the kernel's equals up to
    rounding at the k-th distance."""
    import numpy as np
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.bucket_scan import bucket_scan_phase_cuda

    rows = []
    for name, b in built.items():
        tol = 1e-5 * (1 + float((b["x"].astype(np.float64) ** 2).sum(1).max()))
        for quantize, beam in ((False, 1), (False, 4), (True, 1)):
            args = phase_operands(b["idx"][quantize], b["q"], beam)
            q, bx, ids, count, order, lb = args[:6]
            qn, kk = args[7].shape
            nb, cap, d = bx.shape
            got = bucket_scan_phase_cuda(*args)
            want = ref.bucket_scan_phase_ref(*args)
            fin = torch.isfinite(want[0])
            require(torch.equal(fin, torch.isfinite(got[0])), f"K1 {name}: different fill")
            err = float(torch.where(fin, (got[0] - want[0]).abs(), 0.0).max())
            qq = (q.double() ** 2).sum(1)
            require(bool(((got[0] - want[0]).abs().double()[fin]
                          <= (tol + 1e-5 * qq[:, None].expand_as(fin)[fin])).all()),
                    f"K1 {name}: distances disagree beyond the expansion's rounding")
            differ = torch.zeros(qn, dtype=torch.bool, device=q.device)
            for j in (2, 3, 4):
                differ |= got[j] != want[j]
            require(float(differ.float().mean()) <= 0.01,
                    f"K1 {name}: counters differ on {int(differ.sum())} queries")
            qsteps = got[5]
            touched = touched_buckets(args)
            row_bytes = d * (1 if quantize else 4) + (4 if quantize else 0)
            slots = torch.clamp((qsteps + 1) * beam, max=order.shape[1])
            nbytes = (int(touched.sum()) * cap * 4 + int(count[touched].sum()) * row_bytes
                      + qn * d * 4 + int(slots.sum()) * 8 + qn * kk * 16 + qn * 16)
            flops = 4.0 * d * float(got[3].sum())
            # what the kernel copies through L2: the whole bucket (ids, rows,
            # scales) for every (query, active in-range slot) visit
            gathered = float(got[2].sum()) * cap * (4 + row_bytes)
            ms = device_ms(lambda: bucket_scan_phase_cuda(*args), reps=21)
            plain = device_ms(lambda: ref.bucket_scan_phase_ref(*args), reps=3,
                              launches_hint=int(qsteps.max()) * 12)
            b_ms, by = bound(nbytes, flops)
            kind = "int8" if quantize else "f32"
            st = qsteps.float()
            rows.append(dict(shape=f"{name} {kind} beam={beam} C={cap} D={d}",
                             dataset=name, quantize=quantize, beam=beam, ms=ms,
                             plain_ms=plain, library_ms=None, bound_ms=b_ms, bound_by=by,
                             share=b_ms / ms, bytes=nbytes, touched=int(touched.sum()),
                             gathered=gathered,
                             qsteps_max=int(qsteps.max()), qsteps_mean=float(st.mean()),
                             max_abs_err=err, counters_differ=int(differ.sum())))
            log(f"[time] K1 {name} {kind} beam={beam} (Q={qn}, C={cap}, D={d}), one phase: "
                f"kernel {ms * 1e3:.1f} us/launch, plain {plain:.2f} ms, bound "
                f"{b_ms * 1e3:.2f} us by {by} ({b_ms / ms:.1%} of it; {nbytes} B: "
                f"{int(touched.sum())} distinct buckets once, queries, visited slots, "
                f"carry and outputs); {gathered / 1e9:.3f} GB copied through L2, "
                f"{gathered / ms / 1e9:.2f} TB/s; "
                f"qsteps max {int(qsteps.max())} mean {float(st.mean()):.2f}; "
                f"max |kernel - plain| {err:.2e}, counters differ on {int(differ.sum())} queries")
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
            k1 = sum(e.self_device_time_total for e in kernels if "scan_phase_kernel" in e.key) / 1e3
            k2 = sum(e.self_device_time_total for e in kernels
                     if "pairwise_small" in e.key or "pairwise_tiled" in e.key) / 1e3
            wall_ms = walls[(name, False, beam)] * 1e3
            rows.append(dict(dataset=name, beam=beam, device_ms=dev_ms, k1_ms=k1, k2_ms=k2,
                             wall_ms=wall_ms, kernel_launches=sum(e.count for e in kernels)))
            log(f"[profile] {name} f32 beam={beam}: device busy {dev_ms:.2f} ms of the "
                f"search's {wall_ms:.2f} ms wall ({dev_ms / wall_ms:.1%}); K1 {k1:.2f} ms, "
                f"K2 {k2:.3f} ms, other kernels {dev_ms - k1 - k2:.2f} ms over "
                f"{sum(e.count for e in kernels)} device launches")
    return rows


# --------------------------------------------------------------------------
# phases 9-11: kNN-LM serving (K6, K7, the model and the engine)
# --------------------------------------------------------------------------

SERVE_N = 1 << 20  # datastore rows: one chip's shard of a kNN-LM datastore
SERVE_D = 896  # qwen2-0.5b's d_model: the keys are its hidden states
SERVE_K = 8  # neighbours per query, as launch/serve.py uses
SERVE_ARCH = "qwen2-0.5b"


def check_k6_k7_unit(dev, gen) -> int:
    """Phase 9: K6 and K7 against their plain versions on rows of a 1/8
    grid (K7: int8 rows with power-of-two scales), where every product and
    partial sum of the expansion is exact, so results must be bit-equal:
    N < k, N not a multiple of any tile, D in {5, 64, 896}, k in {1, 8, 16},
    and exact ties from rows duplicated into another pass-1 chunk."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.pairwise_l2 import pairwise_sq_l2_int8_cuda
    from repro_torch.kernels.topk import chunking, knn_topk_cuda

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = 0
    for d in (5, 64, 896):
        for qn, n in ((3, 5), (8, 1000), (9, 3001), (1030, 2049), (8, 70_001)):
            for k in (1, 8, 16):
                q, x = grid_rows(gen, dev, qn, d), grid_rows(gen, dev, n, d)
                chunk_rows, n_chunks = chunking(qn, n, sms)
                if n_chunks > 1:  # a duplicate of row 1 in the last chunk
                    x[n - 1] = x[1]
                    q[0] = x[1]
                kv, ki = knn_topk_cuda(q, x, k)
                rv, ri = ref.knn_topk_ref(q, x, k)
                torch.cuda.synchronize()
                require(torch.equal(kv, rv) and torch.equal(ki, ri),
                        f"K6 differs from its plain version at {(qn, n, d, k)}")
                if n_chunks > 1 and k > 1:
                    require(int(ki[0, 0]) == 1 and int(ki[0, 1]) == n - 1,
                            f"K6 tie order across chunks at {(qn, n, d, k)}")
                cases += 1
            xq = torch.randint(-127, 128, (n, d), generator=gen, device=dev).to(torch.int8)
            s = 2.0 ** -torch.randint(4, 8, (n,), generator=gen, device=dev).float()
            got = pairwise_sq_l2_int8_cuda(q, xq, s)
            want = ref.pairwise_sq_l2_int8_ref(q, xq, s)
            torch.cuda.synchronize()
            require(torch.equal(got, want), f"K7 differs from its plain version at {(qn, n, d)}")
            cases += 1
    log(f"[K6/K7] {cases} grid cases bit-equal to the plain versions (N < k, ragged N, "
        "D 5/64/896, k 1/8/16, exact ties across pass-1 chunks)")
    return cases


def exact_topk(q, x, k: int, *, chunk: int = 1 << 16):
    """f64 brute force: the exact k nearest rows of each query, (Q, k) f64
    squared distances ascending and their ids (ties in any order)."""
    import torch

    qd = q.double()
    qq = (qd ** 2).sum(1)[:, None]
    best_d = torch.empty((q.shape[0], 0), dtype=torch.float64, device=q.device)
    best_i = torch.empty((q.shape[0], 0), dtype=torch.int64, device=q.device)
    for lo in range(0, x.shape[0], chunk):
        xd = x[lo:lo + chunk].double()
        d2 = (qq + (xd ** 2).sum(1)[None, :] - 2.0 * (qd @ xd.T)).clamp_min(0.0)
        vd, vi = torch.topk(d2, min(k, d2.shape[1]), dim=1, largest=False)
        best_d, pos = torch.topk(torch.cat([best_d, vd], 1), k, dim=1, largest=False)
        best_i = torch.gather(torch.cat([best_i, vi + lo], 1), 1, pos)
    return best_d, best_i


def max_sq_norm(x, *, chunk: int = 1 << 16) -> float:
    """max ||x_j||^2 over the rows (f32 sums, chunked): the scale of the band."""
    return max(float((x[lo:lo + chunk].float() ** 2).sum(1).max())
               for lo in range(0, x.shape[0], chunk))


def hold_topk(kv, ki, rv, ri, r_next, q, xf, xx_max: float, what: str) -> dict:
    """A kernel top-k (kv, ki) held to the exact values and to the plain
    top-k (rv, ri; r_next the plain (k+1)-th value), with band = 8 ulp of
    ||q||^2 + max ||x||^2 per query (the in-band rule):

    * each returned value lies within the band of its row's exact (f64) d2;
    * the returned rows are the exact k nearest up to ties: sorted, their
      exact d2 lie within the band of the f64 brute force's, rank by rank
      (recall 1.0 up to ties);
    * ids equal the plain version's except at ranks whose plain d2 lies
      within two bands of a neighbouring rank's: at D = 896 the plain
      version's cuBLAS product itself strays up to ~9 ulp, so two correct
      orders of near-equal rows may differ by both sides' rounding.

    ``xf`` is the f32 (or dequantized) rows."""
    import torch

    bd = (8.0 * 2.0 ** -23 * ((q.double() ** 2).sum(1) + xx_max))[:, None]
    got = ((xf[ki.long()].double() - q.double()[:, None, :]) ** 2).sum(-1)
    require(bool(((got - kv.double()).abs() <= bd).all()), f"{what}: values off the exact d2")
    td, _ = exact_topk(q, xf, kv.shape[1])
    require(bool(((torch.sort(got, dim=1).values - td).abs() <= bd).all()),
            f"{what}: not the exact k nearest up to ties")
    recall = float((got <= td[:, -1:] + bd).double().mean())
    ext = torch.cat([rv.double(), r_next.double()[:, None]], 1)
    tied = torch.diff(ext, dim=1).abs() <= 2 * bd  # rank j near rank j + 1
    tied[:, 1:] |= tied[:, :-1].clone()  # ... or rank j - 1
    differ = ki != ri
    require(bool((~differ | tied).all()), f"{what}: ids differ off the band")
    return dict(max_abs_err=float((kv.double() - rv.double()).abs().max()),
                max_exact_err=float((got - kv.double()).abs().max()),
                ids_differ=int(differ.sum()), in_band_ranks=int(tied.sum()), recall=recall)


def retrieval_problem(keys, nq: int, seed: int):
    """Queries as the engine's hidden states would sit: a random stored key
    plus N(0, 0.5^2) noise per feature, a fresh point of that key's cluster."""
    import torch

    g = torch.Generator(device=keys.device)
    g.manual_seed(seed)
    rows = torch.randint(0, keys.shape[0], (nq,), generator=g, device=keys.device)
    return keys[rows] + 0.5 * torch.randn((nq, keys.shape[1]), generator=g, device=keys.device)


def check_retrieval_scale(dev, keys, xq, scale) -> dict:
    """Phase 10: K6 and K7 (+ the stable selection after it) at the data
    scale of the serving path, 2^20 x 896, Q = 8 and 1024, against the plain
    versions (in-band rule) and an f64 brute force (recall 1.0 up to ties).

    K7's distances are held one by one to 8 ulp of ||q||^2 + ||x||^2 of the
    exact (f64) value.  The plain version's own cuBLAS f32 product over
    D = 896 strays up to ~9 ulp from it, so the kernel-vs-plain difference
    is printed (with its count beyond 8 ulp) rather than held to 8 ulp."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.pairwise_l2 import pairwise_sq_l2_int8_cuda
    from repro_torch.kernels.topk import knn_topk_cuda

    xhat = xq.float() * scale[:, None]
    xx_f32, xx_i8 = max_sq_norm(keys), max_sq_norm(xhat)
    out = {}
    for nq in (8, 1024):
        q = retrieval_problem(keys, nq, SEED + nq)
        kv, ki = knn_topk_cuda(q, keys, SERVE_K)
        rv, ri = ref.knn_topk_ref(q, keys, SERVE_K + 1)
        k6 = hold_topk(kv, ki, rv[:, :-1], ri[:, :-1], rv[:, -1], q, keys, xx_f32,
                       f"K6 Q={nq}")
        del rv, ri
        d_k = pairwise_sq_l2_int8_cuda(q, xq, scale)
        d_p = ref.pairwise_sq_l2_int8_ref(q, xq, scale)
        qd = q.double()
        qq = (qd ** 2).sum(1)[:, None]
        err = dict(kernel=0.0, plain=0.0, differ=0.0, beyond=0)  # in ulp of the norms
        for lo in range(0, SERVE_N, 1 << 16):  # f64 temporaries in row chunks
            xd = xhat[lo:lo + (1 << 16)].double()
            xxd = (xd ** 2).sum(1)[None, :]
            exact = qq + xxd - 2.0 * (qd @ xd.T)
            unit = 2.0 ** -23 * (qq + xxd)
            kc, pc = d_k[:, lo:lo + (1 << 16)].double(), d_p[:, lo:lo + (1 << 16)].double()
            ek = (kc - exact).abs() / unit
            require(bool((ek <= 8.0).all()),
                    f"K7 Q={nq}: a distance more than 8 ulp from the exact value")
            dk = (kc - pc).abs() / unit
            err["kernel"] = max(err["kernel"], float(ek.max()))
            err["plain"] = max(err["plain"], float(((pc - exact).abs() / unit).max()))
            err["differ"] = max(err["differ"], float(dk.max()))
            err["beyond"] += int((dk > 8.0).sum())
            del xd, exact, unit, kc, pc, ek, dk
        rv7, ri7 = ref.topk_smallest(d_p, SERVE_K + 1)
        worst = float((d_k - d_p).abs().max())
        del d_p
        kv7, ki7 = ref.topk_smallest(d_k, SERVE_K)
        del d_k
        k7 = hold_topk(kv7, ki7.to(torch.int32), rv7[:, :-1], ri7[:, :-1].to(torch.int32),
                       rv7[:, -1], q, xhat, xx_i8, f"K7+selection Q={nq}")
        k7.update(max_abs_err=worst, ulp=err)
        out[nq] = dict(k6=k6, k7=k7)
        torch.cuda.empty_cache()
        log(f"[K6/K7] Q={nq} x {SERVE_N} x {SERVE_D}, k={SERVE_K}: K6 max |kernel - plain| "
            f"{k6['max_abs_err']:.3e} (|kernel - exact| {k6['max_exact_err']:.3e}), ids differ "
            f"at {k6['ids_differ']} of {k6['in_band_ranks']} in-band ranks, recall up to ties "
            f"{k6['recall']:.4f}; K7 over all {nq * SERVE_N} "
            f"distances: kernel within {err['kernel']:.2f} ulp of the exact value (held to 8), "
            f"plain within {err['plain']:.2f}, |kernel - plain| up to {err['differ']:.2f} ulp "
            f"({err['beyond']} beyond 8; max {worst:.3e}); its top-k ids differ at "
            f"{k7['ids_differ']} of {k7['in_band_ranks']} in-band ranks, recall vs the "
            f"dequantized rows {k7['recall']:.4f}")
    return out


class _TopkRecorder:
    """Wraps ``serve.retrieval._local_topk`` to keep a few steps' queries."""

    def __init__(self, fn, keep: tuple[int, ...]):
        self.fn, self.keep, self.calls, self.kept = fn, keep, 0, []

    def __call__(self, q, ds, k):
        if self.calls in self.keep:
            self.kept.append(q.clone())
        self.calls += 1
        return self.fn(q, ds, k)


def serve_prompts(vocab: int, n: int, seed: int):
    import numpy as np

    g = np.random.default_rng(seed)
    return [g.integers(0, vocab, int(g.integers(8, 65))).astype(np.int32) for _ in range(n)]


def run_serving(dev, model, datastores) -> dict:
    """Phase 11: qwen2-0.5b at full width serves 16 requests (prompts of 8 to
    64 tokens, 32 new tokens each) on ServeEngine(num_slots=8, max_len=256),
    once with retrieval off, once on the f32 datastore (K6), once on its int8
    twin (K7).  The launch counters are reset just before each run and read
    just after it."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.serve import retrieval
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = model.cfg
    prompts = serve_prompts(cfg.vocab_size, 16, SEED)
    # warm-up, uncounted: cuBLAS handles, the kernels' first loads
    for ds in datastores.values():
        eng = ServeEngine(model, num_slots=8, max_len=256, datastore=ds)
        eng.submit(Request(rid=0, prompt=prompts[0][:8], max_new_tokens=3))
        eng.run()
    torch.cuda.synchronize()
    runs = {}
    for name, ds in datastores.items():
        eng = ServeEngine(model, num_slots=8, max_len=256, datastore=ds)
        rec = _TopkRecorder(retrieval._local_topk, keep=(2, 20, 40))
        retrieval._local_topk = rec
        reqs = [Request(rid=i, prompt=p, max_new_tokens=32) for i, p in enumerate(prompts)]
        try:
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            for r in reqs:
                eng.submit(r)
            done = eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = ops.launch_counts()
        finally:
            retrieval._local_topk = rec.fn
        reg = eng.obs
        require(len(done) == 16 and all(r.done and len(r.out_tokens) == 32 for r in reqs),
                f"serving {name}: a request did not complete")
        require(reg.value("serve.submitted") == reg.value("serve.completed") + sum(
            reg.value("serve.shed", reason=x) for x in
            ("rejected", "expired_queue", "expired_flight", "early")) + len(eng.queue)
            + sum(r is not None for r in eng.slot_req), f"serving {name}: books do not balance")
        toks = np.concatenate([r.out_tokens for r in reqs])
        require(bool(((toks >= 0) & (toks < cfg.padded_vocab)).all()), "a token off the vocab")
        kname = {"f32": "knn_topk", "int8": "pairwise_sq_l2_int8"}.get(name)
        for other in ("knn_topk", "pairwise_sq_l2_int8"):
            want = eng.steps if other == kname else 0
            require(launches[other] == want,
                    f"serving {name}: {other} launched {launches[other]} times, want {want}")
        checked = 0
        if ds is not None:
            xf = ds.keys if ds.scale is None else ds.keys.float() * ds.scale[:, None]
            xx_max = max_sq_norm(xf)
            for q in rec.kept:
                if ds.scale is None:
                    kv, ki = ops.knn_topk(q, ds.keys, k=cfg.retrieval.k)
                    rv, ri = ref.knn_topk_ref(q, ds.keys, cfg.retrieval.k + 1)
                else:
                    kv, ki = ref.topk_smallest(ops.pairwise_sq_l2_int8(q, ds.keys, ds.scale),
                                               cfg.retrieval.k)
                    rv, ri = ref.topk_smallest(
                        ref.pairwise_sq_l2_int8_ref(q, ds.keys, ds.scale), cfg.retrieval.k + 1)
                hold_topk(kv, ki.to(torch.int32), rv[:, :-1], ri[:, :-1].to(torch.int32),
                          rv[:, -1], q, xf, xx_max, f"serving {name} step")
                checked += 1
            require(checked == 3, f"serving {name}: {checked} steps captured, want 3")
        hist = reg.snapshot()["histograms"]
        lat = hist["serve.request_latency_s"]
        step_ms = float(np.median(eng._step_times)) * 1e3
        runs[name] = dict(steps=eng.steps, tokens=int(toks.size), wall_s=wall,
                          tok_per_s=toks.size / wall, p50_s=lat["p50"], p99_s=lat["p99"],
                          step_ms=step_ms, prefill_ms=hist["serve.prefill"]["p50"] * 1e3,
                          launches={k: v for k, v in launches.items() if v},
                          checked_steps=checked)
        log(f"[serve] {SERVE_ARCH} full width, retrieval {name}: 16 requests x 32 tokens in "
            f"{wall:.2f} s ({toks.size / wall:.1f} tok/s), {eng.steps} decode steps, median "
            f"step {step_ms:.2f} ms, p50 prefill {runs[name]['prefill_ms']:.1f} ms, request "
            f"latency p50 {lat['p50']:.3f} s p99 {lat['p99']:.3f} s; launches "
            f"{runs[name]['launches']}; top-k of {checked} captured steps held to the plain "
            "version")
    return runs


def slot_agreement(model, ds) -> float:
    """Share of tokens a 2-slot engine and a 1-slot engine agree on, over 4
    requests of 16 tokens (printed, not gated: cuBLAS may pick another bf16
    product for another batch size; the CPU tests gate this oracle)."""
    import numpy as np

    from repro_torch.serve.engine import Request, ServeEngine

    prompts = serve_prompts(model.cfg.vocab_size, 4, SEED + 1)
    out = {}
    for slots in (1, 2):
        eng = ServeEngine(model, num_slots=slots, max_len=128, datastore=ds)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=16) for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        out[slots] = np.concatenate([r.out_tokens for r in reqs])
    share = float((out[1] == out[2]).mean())
    log(f"[serve] 2-slot vs 1-slot engine (f32 datastore): {share:.3f} of {out[1].size} "
        "tokens agree (not gated on the card)")
    return share


def profile_serving(model, ds, step_ms: float, *, steps: int = 6,
                    kernel=("K6", ("knn_topk", "query_norms")), what="f32 datastore") -> dict:
    """Device time per decode step of a full engine (8 slots): kernel time
    summed by torch.profiler over ``steps`` steps, and the retrieval
    kernel's share of it (``kernel``: its name and the substrings of its
    device functions: K6 on the flat f32 datastore, K1 on the forest
    datastore); the busy share is taken against ``step_ms``, the median
    unprofiled step of the serving run (the profiler's own host overhead
    inflates the profiled wall)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import Request, ServeEngine

    eng = ServeEngine(model, num_slots=8, max_len=256, datastore=ds)
    for i, p in enumerate(serve_prompts(model.cfg.vocab_size, 8, SEED + 2)):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=64))
    eng.step()  # the refills (prefills) happen here, outside the window
    eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    name, subs = kernel
    kms = sum(e.self_device_time_total for e in kernels
              if any(s in e.key for s in subs)) / 1e3 / steps
    launches = sum(e.count for e in kernels) / steps
    out = dict(steps=steps, device_ms_per_step=dev_ms, step_ms=step_ms, kernel=name,
               kernel_ms_per_step=kms, launches_per_step=launches, busy=dev_ms / step_ms)
    log(f"[profile] serving, 8 slots ({what}), {steps} profiled decode steps: device "
        f"time {dev_ms:.2f} ms per step against the run's median step of {step_ms:.2f} ms "
        f"(busy {dev_ms / step_ms:.1%}); {name} {kms:.2f} ms per step; {launches:.0f} device "
        "launches per step")
    return out


def time_retrieval(dev, keys, xq, scale) -> list[dict]:
    """K6 and K7 at Q = 8 (the engine's decode batch) and Q = 1024 (a probe
    shape), beside the plain versions and, for K6, the library's two-pass
    plan (torch.cdist(q, x).square_() + torch.topk(largest=False)).  Bounds:
    K6 reads q and x once and writes (Q, k) values and ids; 2QND + 2(Q+N)D
    f32 operations.  K7 reads q, the int8 rows and the scales once and writes
    (Q, N) f32; the same operations plus N*D dequantizing multiplies.  At
    Q = 8 the stable selection that follows K7 on the int8 serving path
    (``ref.topk_smallest``, a torch sort) is also timed alone on K7's
    output and after K7, as the decode step runs them (printed, not held to
    anything).  K6 at Q = 8 is the same-run control of K3's and K7's times."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.pairwise_l2 import pairwise_sq_l2_int8_cuda
    from repro_torch.kernels.topk import knn_topk_cuda

    n, d, k = SERVE_N, SERVE_D, SERVE_K
    rows = []
    k6_ms = None
    for nq in (8, 1024):
        q = retrieval_problem(keys, nq, SEED + nq)
        reps = 21 if nq == 8 else 3  # Q = 8 times move a few % between reps
        flops = 2.0 * nq * n * d + 2.0 * (nq + n) * d
        ms = device_ms(lambda: knn_topk_cuda(q, keys, k), reps=reps)
        k6_ms = ms if nq == 8 else k6_ms
        plain = device_ms(lambda: ref.knn_topk_ref(q, keys, k), reps=reps)
        lib = device_ms(lambda: torch.topk(torch.cdist(q, keys).square_(), k, dim=1,
                                           largest=False), reps=reps)
        nbytes = 4 * (nq * d + n * d) + 8 * nq * k
        b_ms, by = bound(nbytes, flops)
        earlier = EARLIER_SERVE_MS[("knn_topk", nq)]
        rows.append(dict(name="knn_topk", shape=f"Q={nq} N={n} D={d} k={k}", nq=nq, ms=ms,
                         plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=by,
                         bytes=nbytes, flops=flops, earlier_ms=earlier))
        log(f"[time] K6 knn_topk Q={nq} N={n} D={d} k={k}: kernel {ms:.3f} ms, plain "
            f"{plain:.3f} ms, cdist+topk {lib:.3f} ms, bound {b_ms:.3f} ms by {by} "
            f"({b_ms / ms:.1%} of it); earlier run (PERF.md, same code) {earlier:.3f} ms")
        ms = device_ms(lambda: pairwise_sq_l2_int8_cuda(q, xq, scale), reps=reps)
        plain = device_ms(lambda: ref.pairwise_sq_l2_int8_ref(q, xq, scale), reps=reps)
        nbytes = 4 * nq * d + n * d + 4 * n + 4 * nq * n
        b_ms, by = bound(nbytes, flops + float(n) * d)
        earlier = EARLIER_SERVE_MS[("pairwise_sq_l2_int8", nq)]
        row = dict(name="pairwise_sq_l2_int8", shape=f"Q={nq} N={n} D={d}", nq=nq,
                   ms=ms, plain_ms=plain, library_ms=None, bound_ms=b_ms, bound_by=by,
                   bytes=nbytes, flops=flops + float(n) * d, earlier_ms=earlier,
                   k6_control_ms=k6_ms)
        sort_text = ""
        if nq == 8:
            d2 = pairwise_sq_l2_int8_cuda(q, xq, scale)
            row["sort_ms"] = device_ms(lambda: ref.topk_smallest(d2, k), reps=reps)
            row["k7_sort_ms"] = device_ms(
                lambda: ref.topk_smallest(pairwise_sq_l2_int8_cuda(q, xq, scale), k), reps=reps)
            del d2
            sort_text = (f"; the stable selection after it (ref.topk_smallest, k={k}) "
                         f"{row['sort_ms']:.3f} ms alone, K7 + selection "
                         f"{row['k7_sort_ms']:.3f} ms")
        rows.append(row)
        log(f"[time] K7 pairwise_sq_l2_int8 Q={nq} N={n} D={d}: kernel {ms:.3f} ms, plain "
            f"{plain:.3f} ms, bound {b_ms:.3f} ms by {by} ({b_ms / ms:.1%} of it); earlier "
            f"run (PERF.md, previous design) {earlier:.3f} ms; {control_text(k6_ms)}"
            f"{sort_text}; no single library call dequantizes and computes these distances")
        del q
        torch.cuda.empty_cache()
    return rows


def serving_datastore(dev):
    """The 2^20 x 896 kNN-LM datastore drawn on the card from
    ``embedding_datastore``'s recipe: keys, values and the int8 twin."""
    import torch

    from repro_torch.data.synthetic import embedding_datastore_on
    from repro_torch.kernels import ops

    keys, values = embedding_datastore_on(dev, SERVE_N, SERVE_D, seed=SEED)
    xq, scale = ops.quantize_datastore(keys)
    torch.cuda.synchronize()
    log(f"[serve] datastore {SERVE_N} x {SERVE_D} drawn on the card: f32 "
        f"{keys.numel() * 4 / 1e9:.2f} GB, int8 {xq.numel() / 1e9:.2f} GB + scales")
    return keys, values, xq, scale


def serve_phase(dev, gen, keys, values, xq, scale) -> dict:
    """Phases 9-11 together on the datastore ``serving_datastore`` drew: the
    unit checks, the data-scale checks, serving at full width, the 2-slot
    oracle (printed), the profile and the times."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import RetrievalConfig
    from repro_torch.models.model import Model, num_params
    from repro_torch.serve.retrieval import build_flat_datastore

    t0 = time.perf_counter()
    unit_cases = check_k6_k7_unit(dev, gen)
    scale_chk = check_retrieval_scale(dev, keys, xq, scale)

    cfg = get_config(SERVE_ARCH).replace(retrieval=RetrievalConfig(
        enabled=True, k=SERVE_K, lam=0.25, datastore_size=SERVE_N))
    t1 = time.perf_counter()
    model = Model(cfg, device=dev, seed=SEED)
    torch.cuda.synchronize()
    log(f"[serve] {SERVE_ARCH}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads} heads / {cfg.num_kv_heads} KV, d_ff {cfg.d_ff}, vocab "
        f"{cfg.padded_vocab}; {num_params(model) / 1e6:.1f} M f32 params, seeded init "
        f"{time.perf_counter() - t1:.1f} s; compute {cfg.compute_dtype}")
    vals = values % cfg.vocab_size
    datastores = {
        "off": None,
        "f32": build_flat_datastore(keys, vals, device=dev),
        "int8": build_flat_datastore(keys, vals, quantized=True, device=dev),
    }
    runs = run_serving(dev, model, datastores)
    share = slot_agreement(model, datastores["f32"])
    prof = profile_serving(model, datastores["f32"], runs["f32"]["step_ms"])
    times = time_retrieval(dev, keys, xq, scale)
    log(f"[serve] phases 9-11: {time.perf_counter() - t0:.1f} s")
    return model, dict(unit_cases=unit_cases, scale=scale_chk, runs=runs, slot_share=share,
                       profile=prof, times=times)


# --------------------------------------------------------------------------
# phases 12-15: streaming ingest -> drift monitor -> hot rebuild, and the
# streaming forest datastore in the serving engine
# --------------------------------------------------------------------------

class AcceptRecorder:
    """Wraps a facade backend's ingest body to keep every round's accept
    mask (host numpy), so two runs of the same batches can be compared."""

    def __init__(self, ix):
        body = ix.backend.ingest_body()
        self.masks = []

        def run(*args):
            delta, acc = body(*args)
            self.masks.append(acc.cpu().numpy())
            return delta, acc

        ix.backend.ingest_body = lambda: run


def stream_searches(ix, q, what: str, *, beams=(1,)) -> dict:
    """``mode="all"`` over forest + delta exact against a brute force over
    every object ingested so far; ``mode="forest"`` exact against the brute
    force over the routed indexes' rows (buckets and delta buffers)."""
    import torch

    dev = ix.backend.device
    qt = torch.from_numpy(q).to(dev)
    xt = torch.from_numpy(ix.x_all).to(dev)
    bf = BruteForce(xt, qt)
    routed = BruteForce(xt, qt, route=Route(ix, qt))
    out = {}
    for beam in beams:
        res = ix.search(q, k=K, beam=beam, mode="all")
        chk = check_result(bf, res.dists, res.ids)
        resf = ix.search(q, k=K, beam=beam, mode="forest")
        chf = check_forest(routed, resf.dists, resf.ids)
        out[beam] = dict(all_recall_ties=chk["recall_ties"], all_max_d2_err=chk["max_d2_err"],
                         forest_routed_found=chf["routed_found"], forest_short=chf["short"])
    log(f"[stream] {what}: {len(ix.x_all)} rows ({sum(ix.structure()['delta_fill'])} in the "
        f"delta): mode='all' exact against the brute force, mode='forest' exact over its "
        f"routed rows, beam {', '.join(str(b) for b in beams)}")
    return out


def one_search_launches(ix, q) -> dict:
    """Kernel launches of one search (after an uncounted warm-up)."""
    import torch

    from repro_torch.kernels import ops

    ix.search(q, k=K)
    torch.cuda.synchronize()
    before = ops.launch_counts()
    ix.search(q, k=K)
    return {k: v - before[k] for k, v in ops.launch_counts().items()}


def search_ms_per_query(ix, q) -> float:
    """Host wall time of one synchronised search, per query (warm)."""
    import torch

    ix.search(q, k=K)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ix.search(q, k=K)
    return (time.perf_counter() - t0) * 1e3 / len(q)


def bench_stream_phase(dev, smi: str) -> dict:
    """Phase 12: the JAX package's own streaming workload
    (``benchmarks/bench_stream.py`` at full size): 20,000 seed points and a
    drifting stream of 40,000 at D = 12 in batches of 1,024, delta capacity
    2,048, a VBM build (eps 2.5, min_pts 8), a DBM monitor (xi_rebuild 0.6,
    fill_rebuild 0.7) and ``maintain()`` after every batch.  Exactness is
    held at the start, mid-stream, right after every rebuild swap and at the
    end.  The launch counters are reset just before the build and read just
    after the last search."""
    from collections import Counter

    import numpy as np
    import torch

    from repro_torch.api import Config, IndexConfig, OverlapIndex, StreamConfig
    from repro_torch.data.synthetic import drifting_batches
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    batches = drifting_batches(40_000, 1_024, 12, seed=11)
    x0 = np.concatenate(drifting_batches(20_000, 20_000, 12, seed=3))
    q = make_queries(x0, SEED + 12)
    cfg = Config(index=IndexConfig(method="vbm", eps=2.5, min_pts=8),
                 stream=StreamConfig(capacity=2_048, monitor_method="dbm", xi_rebuild=0.6,
                                     fill_rebuild=0.7))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    ix = OverlapIndex.build(x0, cfg, device=dev)
    t_build = time.perf_counter() - t0
    ix.check()  # the (empty) delta, so the first search scans it too
    checks = {"start": stream_searches(ix, q, "bench_stream start")}
    empty_ms = search_ms_per_query(ix, q)
    k1_per_search = one_search_launches(ix, q)["bucket_scan_topk"]
    require(k1_per_search == 2, f"K1 launched {k1_per_search} times in a search with a delta")
    n_stream = sum(len(b) for b in batches)
    ingest_s = maint_s = 0.0
    mid_ms = mid_fill = None
    reasons = Counter()
    n_swaps = 0
    for bi, xb in enumerate(batches):
        t0 = time.perf_counter()
        ix.ingest(xb)
        torch.cuda.synchronize()
        ingest_s += time.perf_counter() - t0
        n_log = len(ix.rebuild_log)
        t0 = time.perf_counter()
        report = ix.maintain()
        maint_s += time.perf_counter() - t0
        if report.triggers:
            reasons.update(r for v in report.reasons.values() for r in v)
        if len(ix.rebuild_log) > n_log:
            n_swaps += 1
            checks[f"swap {n_swaps} (batch {bi})"] = stream_searches(
                ix, q, f"bench_stream after rebuild swap {n_swaps} (batch {bi}, "
                f"indexes {ix.rebuild_log[-1]['triggers']})")
        if bi == len(batches) // 2:
            mid_fill = sum(ix.structure()["delta_fill"]) / (ix.capacity * ix.n_indexes)
            mid_ms = search_ms_per_query(ix, q)
            checks["mid-stream"] = stream_searches(ix, q, "bench_stream mid-stream")
    checks["end"] = stream_searches(ix, q, "bench_stream end", beams=(1, 4))
    launches = ops.launch_counts()
    require(n_swaps >= 1, "no rebuild swap in the streaming workload")
    require(all(launches[kn] > 0 for kn in ("pairwise_sq_l2", "bucket_scan_topk", "eps_count",
                                             "eps_min_label", "eps_nearest_core")),
            f"a kernel of the streaming path never launched: {launches}")
    walls = [r["wall_time_s"] for r in ix.rebuild_log]
    out = dict(build_s=t_build, indexes=ix.n_indexes, ingest_points_per_s=n_stream / ingest_s,
               ingest_s=ingest_s, maintain_s=maint_s, rebuild_events=len(ix.rebuild_log),
               indexes_rebuilt=int(ix.forest.build_stats["rebuilds"]),
               reasons=dict(reasons), rebuild_wall_s=walls, search_ms_empty=empty_ms,
               search_ms_mid=mid_ms, mid_fill=mid_fill, k1_per_search=k1_per_search,
               launches=launches, checks=checks, seconds=time.perf_counter() - t_phase)
    log(f"[stream] bench_stream 20,000 + 40,000 x 12 (capacity 2,048, VBM eps 2.5, DBM "
        f"monitor xi 0.6 fill 0.7): build {t_build:.2f} s, {ix.n_indexes} indexes; ingest "
        f"{out['ingest_points_per_s']:.0f} points/s ({ingest_s:.2f} s for {len(batches)} "
        f"batches); "
        f"maintain {maint_s:.2f} s in all; {len(ix.rebuild_log)} rebuild swaps of "
        f"{out['indexes_rebuilt']} indexes (reasons {dict(reasons)}), rebuild wall "
        f"{min(walls):.3f}-{max(walls):.3f} s; search {empty_ms:.4f} ms/query at an empty "
        f"delta, {mid_ms:.4f} ms/query at {mid_fill:.1%} fill mid-stream; K1 launches per "
        f"search {k1_per_search}; launches over the phase {launches}; phase "
        f"{out['seconds']:.1f} s ({smi})")
    return out


DELTA_FIELDS = ("x", "ids", "count", "pivot", "radius", "sum_x", "main_count", "main_sum",
                "main_radius", "dropped")


def hold_delta(card, host, what: str) -> dict:
    """The card's delta buffers against the CPU twin's: rows, ids, counts,
    drops equal; radius within 1e-6 of itself (a distance summed over D in
    another order); each coordinate sum within n eps sum|x| of the CPU's
    (two f32 orders of n terms)."""
    import numpy as np

    dc = {n: getattr(card.delta, n).cpu().numpy() for n in DELTA_FIELDS}
    dh = {n: getattr(host.delta, n).cpu().numpy() for n in DELTA_FIELDS}
    for n in ("x", "ids", "count", "dropped", "pivot", "main_count", "main_sum", "main_radius"):
        require(np.array_equal(dc[n], dh[n]), f"{what}: delta {n} differs from the CPU run")
    rad_err = float(np.abs(dc["radius"] - dh["radius"]).max())
    require(bool((np.abs(dc["radius"] - dh["radius"]) <= 1e-6 * np.abs(dh["radius"])).all()),
            f"{what}: delta radius off the CPU run's")
    live = np.arange(dh["x"].shape[1])[None, :] < dh["count"][:, None]
    abs_sum = (np.abs(dh["x"].astype(np.float64)) * live[..., None]).sum(1)
    bound = dh["count"][:, None] * 2.0 ** -23 * abs_sum
    sum_err = np.abs(dc["sum_x"].astype(np.float64) - dh["sum_x"])
    require(bool((sum_err <= bound).all()), f"{what}: delta sum_x off the CPU run's")
    return dict(radius_err=rad_err, sum_x_err=float(sum_err.max()),
                sum_x_bound=float(bound.max()))


def ward_stream_phase(dev, ward_ix, smi: str) -> dict:
    """Phase 13: 16 batches of 1,024 ``ward_like`` points (seed 2; the build
    used seed 1) into the WARD VBM forest of phase 6 at the default delta
    capacity (sqrt(n) = 1,000 slots an index), ``maintain()`` after each:
    capacity-forced and fill-triggered rebuilds of the 1M forest on the
    host.  A CPU twin (the same forest, ``device="cpu"``) takes the same
    batches: its delta buffers, every round's accepts and its rebuild
    triggers must equal the card's.  Then 1,024 queries (forest and all,
    f32, beam 1 and 4) against a brute force over main + delta rows, the
    host syncs and K1 launches of one search."""
    import numpy as np
    import torch

    from repro_torch.api import Config, OverlapIndex
    from repro_torch.data.synthetic import ward_like
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    base = ward_ix
    cfg = Config(index=base.cfg.index)  # the default StreamConfig
    card = OverlapIndex._wire(base.x_all, base.forest, cfg, base.build_report, dev)
    host = OverlapIndex._wire(base.x_all, base.forest, cfg, base.build_report,
                              torch.device("cpu"))
    rec_card, rec_host = AcceptRecorder(card), AcceptRecorder(host)
    stream = ward_like(16 * 1_024, seed=2)
    ops.reset_launch_counts()
    ingest_s = maint_s = host_s = 0.0
    held = []
    for bi in range(16):
        xb = stream[bi * 1_024:(bi + 1) * 1_024]
        t0 = time.perf_counter()
        card.ingest(xb)
        torch.cuda.synchronize()
        ingest_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        rc = card.maintain()
        maint_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        host.ingest(xb)
        rh = host.maintain()
        host_s += time.perf_counter() - t0
        require(rc.triggers == rh.triggers and rc.reasons == rh.reasons,
                f"WARD batch {bi}: triggers {rc.reasons} on the card, {rh.reasons} on the CPU")
        require(len(rec_card.masks) == len(rec_host.masks) and all(
            np.array_equal(a, b) for a, b in zip(rec_card.masks, rec_host.masks)),
            f"WARD batch {bi}: accepts differ from the CPU run")
        require([r["triggers"] for r in card.rebuild_log]
                == [r["triggers"] for r in host.rebuild_log],
                f"WARD batch {bi}: rebuilds differ from the CPU run")
        held.append(hold_delta(card, host, f"WARD batch {bi}"))
    launches = ops.launch_counts()
    require(launches["pairwise_sq_l2"] > 0, "K2 never routed a WARD batch")
    log_r = card.rebuild_log
    forced = [r for r in log_r if not r["reasons"]]
    filled = [r for r in log_r if any("fill" in v for v in r["reasons"].values())]
    q = make_queries(card.x_all, SEED + 13)
    checks = stream_searches(card, q, "WARD 1M + 16,384 streamed", beams=(1, 4))
    per = one_search_launches(card, q)
    require(per["bucket_scan_topk"] == 2, f"K1 launched {per['bucket_scan_topk']} times a search")
    syncs = count_syncs(lambda: card.search(q, k=K))
    require(syncs <= 2, f"a WARD search with a delta synchronises {syncs} times")
    wall_ms = search_ms_per_query(card, q) * len(q)
    fill = card.structure()["delta_fill"]
    out = dict(ingest_points_per_s=16 * 1_024 / ingest_s, ingest_s=ingest_s, maintain_s=maint_s,
               cpu_twin_s=host_s, rebuild_events=len(log_r), forced_events=len(forced),
               fill_events=len(filled), indexes_rebuilt=int(card.forest.build_stats["rebuilds"]),
               rebuild_wall_s=[r["wall_time_s"] for r in log_r], rounds=len(rec_card.masks),
               delta_fill=fill, syncs=syncs, k1_per_search=per["bucket_scan_topk"],
               search_wall_ms=wall_ms, checks=checks, launches=launches,
               max_radius_err=max(h["radius_err"] for h in held),
               max_sum_x_err=max(h["sum_x_err"] for h in held),
               seconds=time.perf_counter() - t_phase)
    require(len(log_r) > 0, "16,384 points into 12,000 delta slots rebuilt nothing")
    walls = out["rebuild_wall_s"]
    log(f"[stream] WARD 1,000,000 x 5 VBM + 16 x 1,024 streamed (capacity {card.capacity}): "
        f"ingest {out['ingest_points_per_s']:.0f} points/s ({ingest_s:.2f} s, "
        f"{out['rounds']} ingest rounds), maintain {maint_s:.2f} s; {len(log_r)} rebuild "
        f"swaps ({len(forced)} capacity-forced, {len(filled)} with a fill trigger) of "
        f"{out['indexes_rebuilt']} indexes, host rebuild wall {min(walls):.2f}-"
        f"{max(walls):.2f} s each ({sum(walls):.2f} s in all); the CPU twin's delta, accepts "
        f"and triggers equal the card's after every batch (radius within "
        f"{out['max_radius_err']:.2e}, sum_x within {out['max_sum_x_err']:.2e}); search of "
        f"{NQ} queries {wall_ms:.2f} ms wall, K1 launches {per['bucket_scan_topk']}, host "
        f"syncs {syncs}; delta fill {fill}; launches over the ingest {launches}; phase "
        f"{out['seconds']:.1f} s (CPU twin {host_s:.1f} s) ({smi})")
    return out


def in_band_objects(x, centers, radii) -> int:
    """(object, ball) pairs whose membership rounding decides: the exact
    squared distance within 8 ulp of ||x||^2 + ||p||^2 of the squared
    radius."""
    import numpy as np

    xd, cd = x.astype(np.float64), centers.astype(np.float64)
    d2 = ((xd[:, None, :] - cd[None]) ** 2).sum(-1)
    band = 8 * 2.0 ** -23 * ((xd ** 2).sum(1)[:, None] + (cd ** 2).sum(1)[None])
    return int((np.abs(d2 - radii.astype(np.float64)[None] ** 2) <= band).sum())


def blob_obm_phase(dev, smi: str) -> dict:
    """Phase 14: the blob 2,100 x 8 VBM forest (overlap indexes and links)
    with an OBM drift monitor: four ingest + maintain rounds drive
    ``object_assignment`` and the object-based rates on the card, searches
    stay exact.  A CPU twin takes the same batches.  OBM counts objects
    inside balls, and an index's farthest member lies at exactly its radius,
    in or out by rounding; so the card's and the CPU's monitors are held
    equal (rates within 1e-6 + 1e-5 x rate, triggers equal) on radii raised
    by 1e-4 of themselves, where no object lies within 8 ulp of a boundary,
    and the facade's own triggers are printed side by side."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.api import Config, IndexConfig, OverlapIndex, StreamConfig
    from repro_torch.stream.maintenance import OverlapMonitor

    blob = blob_rows()
    cfg = Config(index=IndexConfig(method="vbm", **BUILD_CFG["Blob"]),
                 stream=StreamConfig(capacity=96, monitor_method="obm", xi_rebuild=0.8,
                                     fill_rebuild=0.5))
    card = OverlapIndex.build(blob, cfg, device=dev)
    host = OverlapIndex._wire(card.x_all, card.forest, cfg, card.build_report,
                              torch.device("cpu"))
    g = np.random.default_rng(SEED + 14)
    rows = []
    for r in range(4):
        xb = (blob[g.choice(len(blob), 150)] + 0.3 * g.normal(size=(150, 8))).astype(np.float32)
        card.ingest(xb)
        host.ingest(xb)
        rc, rh = card.check(), host.check()
        radii = card.forest.index_radii * np.float32(1 + 1e-4)
        mons = []
        for ix in (card, host):
            f = dataclasses.replace(ix.forest, index_radii=radii)
            d = ix.delta._replace(main_radius=torch.from_numpy(radii).to(ix.backend.device))
            mons.append(OverlapMonitor(f, ix._maint_cfg(), x=ix.x_all, device=ix.backend.device)
                        .check(d, x=ix.x_all))
        nc, nh = mons
        require(in_band_objects(card.x_all, card.forest.index_centers, radii) == 0
                and in_band_objects(card.x_all, nc.centers, nc.radii) == 0,
                f"blob OBM round {r}: an object within 8 ulp of a nudged boundary")
        for a, b in ((nc.rates_baseline, nh.rates_baseline), (nc.rates, nh.rates)):
            require(bool((np.abs(a - b) <= 1e-6 + 1e-5 * np.abs(b)).all()),
                    f"blob OBM round {r}: card rates off the CPU's")
        require(nc.triggers == nh.triggers and nc.reasons == nh.reasons,
                f"blob OBM round {r}: nudged triggers differ")
        rows.append(dict(card=rc.reasons, cpu=rh.reasons, nudged=nc.reasons,
                         max_rate_err=float(np.abs(nc.rates - nh.rates).max())))
        for ix in (card, host):  # the card's triggers on both: the twins stay equal
            ix._rebuild(rc.triggers, rc)
        stream_searches(card, make_queries(card.x_all, SEED + 20 + r)[:256],
                        f"blob OBM round {r}")
    log(f"[stream] blob 2,100 x 8 VBM, OBM monitor (xi 0.8, fill 0.5), 4 x 150 streamed: "
        f"triggers card / CPU per round {[(x['card'], x['cpu']) for x in rows]}; on the "
        f"nudged radii equal, rates within {max(x['max_rate_err'] for x in rows):.2e} "
        f"({smi})")
    return dict(rounds=rows, rebuilds=len(card.rebuild_log))


def time_k1_datastore(ds, q, smi: str) -> dict:
    """K1 at the forest datastore's shape (D = 896, k = 8): one main phase
    of the decode batch's queries, kernel against the plain phase and the
    bound (as ``time_k1`` counts it)."""
    import types

    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.bucket_scan import bucket_scan_phase_cuda

    args = phase_operands(types.SimpleNamespace(device=ds.forest), q, 1, k=SERVE_K)
    got = bucket_scan_phase_cuda(*args)
    want = ref.bucket_scan_phase_ref(*args)
    fin = torch.isfinite(want[0])
    require(torch.equal(fin, torch.isfinite(got[0])), "K1 D=896: different fill")
    err = float(torch.where(fin, (got[0] - want[0]).abs(), 0.0).max())
    qn, kk = args[7].shape
    bx, count, order = args[1], args[3], args[4]
    nb, cap, d = bx.shape
    touched = touched_buckets(args)
    slots = torch.clamp(got[5] + 1, max=order.shape[1])
    nbytes = (int(touched.sum()) * cap * 4 + int(count[touched].sum()) * d * 4
              + qn * d * 4 + int(slots.sum()) * 8 + qn * kk * 16 + qn * 16)
    flops = 4.0 * d * float(got[3].sum())
    ms = device_ms(lambda: bucket_scan_phase_cuda(*args), reps=21)
    plain = device_ms(lambda: ref.bucket_scan_phase_ref(*args), reps=3,
                      launches_hint=int(got[5].max()) * 12)
    b_ms, by = bound(nbytes, flops)
    row = dict(name="bucket_scan_topk", shape=f"datastore Q={qn} C={cap} D={d} k={kk}", ms=ms,
               plain_ms=plain, library_ms=None, bound_ms=b_ms, bound_by=by, max_abs_err=err,
               qsteps_max=int(got[5].max()), qsteps_mean=float(got[5].float().mean()),
               touched=int(touched.sum()))
    log(f"[time] K1 forest datastore Q={qn} C={cap} D={d} k={kk}, one phase: kernel "
        f"{ms * 1e3:.1f} us, plain {plain:.2f} ms, bound {b_ms * 1e3:.2f} us by {by} "
        f"({b_ms / ms:.1%} of it; {int(touched.sum())} distinct buckets), qsteps max "
        f"{row['qsteps_max']} mean {row['qsteps_mean']:.2f}, max |kernel - plain| {err:.2e} "
        f"({smi})")
    return row


STREAM_KEYS = 65_536  # RetrievalConfig.datastore_size's default
STREAM_CAPACITY = 4_096


def forest_serve_phase(dev, model, smi: str) -> dict:
    """Phase 15: kNN-LM serving on a streaming forest datastore.
    ``build_forest_datastore`` over 65,536 x 896 keys drawn on the card from
    ``embedding_datastore``'s recipe (values modulo the vocabulary,
    ``stream_capacity`` 4,096; DBSCAN on K3-K5 at D = 896), then
    ``ServeEngine(num_slots=8, max_len=256)`` serves 16 requests (8-64
    prompt tokens x 32 new tokens) interleaved with 16 ``IngestRequest``s of
    64 keys each.  Held: every insert is accepted or reported, the delta
    holds exactly the accepted count, streamed keys retrieve their own
    token, and ``forest_knn`` is exact within Alg. 2 against a brute force
    over the routed indexes' rows (buckets and delta).  The launch counters
    are reset just before the build and before the serving run, and read
    just after each."""
    import types

    import numpy as np
    import torch

    from repro_torch.api import OverlapIndex
    from repro_torch.core.knn import knn_search_impl
    from repro_torch.data.synthetic import embedding_datastore_on
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import IngestRequest, Request, ServeEngine
    from repro_torch.serve.retrieval import build_forest_datastore, forest_knn, knn_logits
    from repro_torch.stream.ingest import delta_view

    cfg = model.cfg
    keys, values = embedding_datastore_on(dev, STREAM_KEYS, SERVE_D, seed=SEED + 15)
    built = {}
    build_fn = OverlapIndex.build.__func__

    def spy(cls, *a, **kw):  # keep the index build_forest_datastore makes, for its report
        built["ix"] = build_fn(cls, *a, **kw)
        return built["ix"]

    ops.reset_launch_counts()
    OverlapIndex.build = classmethod(spy)
    try:
        t0 = time.perf_counter()
        ds = build_forest_datastore(keys, values % cfg.vocab_size,
                                    stream_capacity=STREAM_CAPACITY, device=dev)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
    finally:
        OverlapIndex.build = classmethod(build_fn)
    build_launches = ops.launch_counts()
    rep = built["ix"].build_report
    require(all(build_launches[k] > 0 for k in ("eps_count", "eps_min_label",
                                                 "eps_nearest_core")),
            f"the datastore's DBSCAN did not run on K3-K5: {build_launches}")
    f = built["ix"].forest
    log(f"[serve-stream] build_forest_datastore {STREAM_KEYS} x {SERVE_D}: {t_build:.2f} s "
        f"(eps heuristic + build; eps {built['ix'].cfg.index.eps:.3f}), phases "
        f"{ {k: round(v, 3) for k, v in rep.phase_s.items()} }; n_clusters {rep.n_clusters}, "
        f"DBSCAN iterations {rep.detail['dbscan_iterations']}, {f.n_indexes} indexes "
        f"({int(f.is_overlap_index.sum())} overlap), {f.n_buckets} buckets of C={f.c_max}; "
        f"delta {tuple(ds.delta.x.shape)}; launches {build_launches} ({smi})")

    g = np.random.default_rng(SEED + 15)
    prompts = serve_prompts(cfg.vocab_size, 16, SEED + 15)
    rows = torch.from_numpy(g.integers(0, STREAM_KEYS, 16 * 64)).to(dev)
    streamed = (keys[rows] + 0.5 * torch.randn(keys[rows].shape, device=dev,
                                               generator=torch.Generator(dev).manual_seed(15)))
    stream_np = streamed.cpu().numpy()
    tokens = (50_000 + np.arange(16 * 64)).astype(np.int32) % cfg.vocab_size
    eng = ServeEngine(model, num_slots=8, max_len=256, datastore=ds)
    eng.submit(Request(rid=-1, prompt=prompts[0][:8], max_new_tokens=2))
    eng.run()  # warm-up, uncounted
    torch.cuda.synchronize()
    eng = ServeEngine(model, num_slots=8, max_len=256, datastore=ds)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=32) for i, p in enumerate(prompts)]
    ings = [IngestRequest(rid=100 + i, keys=stream_np[i * 64:(i + 1) * 64],
                          values=tokens[i * 64:(i + 1) * 64]) for i in range(16)]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for r, ing in zip(reqs, ings):
        eng.submit(r)
        eng.submit(ing)
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    require(len(done) == 32 and all(r.done and len(r.out_tokens) == 32 for r in reqs),
            "forest serving: a request did not complete")
    require(all(i.done and not i.error and 0 <= i.accepted <= 64 for i in ings),
            "forest serving: an insert was neither accepted nor reported")
    accepted = sum(i.accepted for i in ings)
    dsn = eng.datastore
    require(int(dsn.delta.count.sum()) == accepted == dsn.next_id - dsn.n_main,
            "forest serving: the delta does not hold exactly the accepted inserts")
    require(eng.obs.value("serve.ingested_keys") == accepted, "ingested_keys off")
    require(launches["bucket_scan_topk"] == 2 * eng.steps,
            f"K1 launched {launches['bucket_scan_topk']} times in {eng.steps} decode steps")
    # the stored pairs, read back from the delta buffers in id order
    d_ids = dsn.delta.ids.cpu().numpy()
    got_ids = np.sort(d_ids[d_ids >= 0]).astype(np.int64) - dsn.n_main
    vals = dsn.values.cpu().numpy()
    dx = dsn.delta.x.reshape(-1, SERVE_D)
    flat_ids = dsn.delta.ids.reshape(-1)
    pos = torch.argsort(flat_ids)
    first = int((flat_ids[pos] < 0).sum())
    stored_keys = dx[pos[first:]]
    p = knn_logits(stored_keys, dsn, cfg)
    top = torch.argmax(p, -1).cpu().numpy()
    require(np.array_equal(top, vals[dsn.n_main + got_ids]),
            "a streamed key does not retrieve its own token")
    # forest_knn within Alg. 2: the routed rows' brute force
    q = retrieval_problem(keys, 1_024, SEED + 16)
    delta = delta_view(dsn.delta)
    d, ids, _ = knn_search_impl(dsn.forest, q, k=SERVE_K, mode="forest", delta=delta)
    d2f, vf = forest_knn(q, dsn, SERVE_K)
    require(bool((ids >= 0).all()), "forest_knn: fewer than k rows reachable")
    require(torch.equal(d2f, d * d) and torch.equal(vf, dsn.values[ids.long()]),
            "forest_knn disagrees with its own search")
    x_rows = torch.cat([keys, torch.zeros((dsn.next_id - dsn.n_main, SERVE_D), device=dev)])
    x_rows[dsn.n_main + torch.from_numpy(got_ids).to(dev)] = stored_keys
    fnp = types.SimpleNamespace(
        index_centers=dsn.forest.index_centers.cpu().numpy(),
        n_indexes=int(dsn.forest.index_centers.shape[0]),
        neighbors=dsn.forest.neighbors.cpu().numpy(),
        bucket_ids=dsn.forest.bucket_ids.cpu().numpy(),
        bucket_index=dsn.forest.bucket_index.cpu().numpy())
    view = types.SimpleNamespace(forest=fnp, x_all=x_rows, delta=dsn.delta)
    # K1 sums q.x and ||x||^2 as f32 fmaf chains in feature order; over
    # D = 896 terms the rounding grows past the 8 ulp of the norms that hold
    # at D <= 20.  A chain of D terms is off by at most D u sum|terms| (u =
    # 2^-24), so d^2 by at most D 2^-23 (||q||^2 + ||x||^2): the tolerance
    # here, with the error actually met printed beside it
    rel = SERVE_D * 2.0 ** -23
    routed = BruteForce(x_rows, q, route=Route(view, q), k=SERVE_K, rel=rel)
    chf = check_forest(routed, d.cpu().numpy(), ids.cpu().numpy())
    qn2 = (q.double() ** 2).sum(1)[:, None]
    x2 = (x_rows[ids.long()].double() ** 2).sum(-1)
    ulps = float(((d.double() ** 2 - routed.exact_d2(ids.long())).abs()
                  / (2.0 ** -23 * (qn2 + x2))).max())
    hist = eng.metrics()["histograms"]
    steps = max(eng.steps, 1)
    out = dict(build_s=t_build, phase_s=dict(rep.phase_s), n_clusters=rep.n_clusters,
               iterations=rep.detail["dbscan_iterations"], indexes=f.n_indexes,
               buckets=f.n_buckets, c_max=f.c_max, delta_shape=list(ds.delta.x.shape),
               build_launches=build_launches, steps=eng.steps, wall_s=wall,
               tok_per_s=16 * 32 / wall,
               step_ms=float(np.median(eng._step_times)) * 1e3,
               prefill_ms=hist["serve.prefill"]["p50"] * 1e3,
               ingest_ms=hist["serve.ingest_latency_s"]["p50"] * 1e3,
               accepted=accepted, launches=launches,
               k1_per_step=launches["bucket_scan_topk"] / steps,
               k2_per_step=(launches["pairwise_sq_l2"] - 2 * len(ings)) / steps,
               routed_found=chf["routed_found"], outside=chf["outside"], d2_err_ulps=ulps)
    log(f"[serve-stream] {SERVE_ARCH} full width on the forest datastore: 16 requests x 32 "
        f"tokens with 16 inserts of 64 keys in {wall:.2f} s ({out['tok_per_s']:.1f} tok/s), "
        f"{eng.steps} decode steps, median step {out['step_ms']:.2f} ms, p50 prefill "
        f"{out['prefill_ms']:.1f} ms, p50 insert {out['ingest_ms']:.2f} ms; {accepted} of "
        f"{16 * 64} keys accepted, the delta holds exactly them and each retrieves its own "
        f"token; K1 {out['k1_per_step']:.2f} and K2 {out['k2_per_step']:.2f} launches per "
        f"decode step (K2 2 per insert besides); forest_knn exact over the routed rows "
        f"(found {chf['routed_found']:.4f}, {chf['outside']:.4f} from unrouted buckets; d^2 "
        f"within {ulps:.1f} ulp of the norms of the exact value, held to {SERVE_D}); "
        f"launches {launches} ({smi})")
    out["k1_time"] = time_k1_datastore(dsn, retrieval_problem(keys, 8, SEED + 17).cpu().numpy(),
                                       smi)
    out["profile"] = profile_serving(model, dsn, out["step_ms"],
                                     kernel=("K1", ("scan_phase_kernel",)),
                                     what="forest datastore")
    out["k3_time"] = time_k3_wide(keys, float(np.float32(built["ix"].cfg.index.eps) ** 2), smi)
    return out


def time_k3_wide(keys, eps_sq: float, smi: str) -> dict:
    """K3 on the >64-wide path that the datastore's DBSCAN takes: 4,096 of
    the 65,536 key rows as queries against all of them (a sixteenth of one
    build pass), beside its bound, Q N (2D + 3) f32 operations."""
    from repro_torch.kernels.eps_graph import eps_count_cuda

    q = keys[:4_096]
    qn, n, d = q.shape[0], keys.shape[0], keys.shape[1]
    ms = device_ms(lambda: eps_count_cuda(q, keys, eps_sq), reps=3)
    flops = float(qn) * n * (2 * d + 3)
    b_ms, by = bound(4.0 * (qn + n) * d + 4.0 * qn, flops)
    log(f"[time] K3 eps_count Q={qn} N={n} D={d} (the >64-wide path): kernel {ms:.1f} ms, "
        f"bound {b_ms:.2f} ms by {by} ({b_ms / ms:.1%} of it), "
        f"{flops / ms / 1e9:.3f} TFLOP/s ({smi})")
    return dict(shape=f"Q={qn} N={n} D={d}", ms=ms, bound_ms=b_ms, bound_by=by)


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
            if any(w in line for w in ("entry function", "registers", "spill")):
                log(f"[build] {src_name}: {line.strip()}")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    k2_err = check_k2(dev, gen)
    k1_err = check_k1(dev, gen)
    eps_err = check_eps_unit(dev, gen)
    data = make_data()
    eps_data = {ds: check_eps_data(ds, torch.from_numpy(data[ds]).to(dev),
                                   BUILD_CFG[ds]["eps"], BUILD_CFG[ds]["min_pts"])
                for ds, *_ in DATASETS}

    sl = run_slice(dev, data)
    check_kernel_vs_plain_search(sl["built"])
    ov = run_overlap(dev, sl["built"], sl["results"])
    cfg = BUILD_CFG["Tracking"]
    db = check_dbscan(torch.from_numpy(data["Tracking"]).to(dev), cfg["eps"], cfg["min_pts"])
    k2_rows = time_k2(sl["built"])
    k1_rows = time_k1(sl["built"])
    store = serving_datastore(dev)
    k6_ms = k6_control(store[0])
    eps_rows = time_eps(sl["built"], ov, smi, k6_ms)
    prof_rows = profile_searches(sl["built"], sl["results"])
    model, sv = serve_phase(dev, gen, *store)
    del store
    torch.cuda.empty_cache()
    stream = bench_stream_phase(dev, smi)
    ward_stream = ward_stream_phase(dev, ov["builds"][("WARD", "vbm")]["idx"][False], smi)
    blob_obm = blob_obm_phase(dev, smi)
    forest_serve = forest_serve_phase(dev, model, smi)

    # how much of each search's wall time its one K1 launch accounts for
    walls = {(n, qz, bm): w for n, qz, bm, _, w in sl["results"]}
    for r in k1_rows:
        wall_ms = walls[(r["dataset"], r["quantize"], r["beam"])] * 1e3
        log(f"[time] {r['shape']}: K1 device time {r['ms']:.3f} ms of "
            f"the search's {wall_ms:.2f} ms wall ({r['ms'] / wall_ms:.1%})")

    def entry(kname, src_file, replaces, row, err, launches):
        return dict(
            name=kname, route="cuda", source=src_file, replaces=replaces,
            launches=launches[kname], max_abs_err=err, ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"], shape=row["shape"],
        )

    # K1/K2: launches of the baseline searches (phase 5); K3-K5: of the
    # overlap builds and searches (phases 6-7); times at the WARD shapes
    eps_src = "src/repro_torch/csrc/eps_graph.cu"
    eps_d2 = max([eps_err] + [v["k5_max_d2_err"] for v in eps_data.values()])
    eps_counts = max(v["k3_max"] for v in eps_data.values())
    kernels = [
        entry("bucket_scan_topk", "src/repro_torch/csrc/bucket_scan.cu",
              "src/repro/kernels/bucket_scan.py:197", k1_rows[0],
              max([k1_err] + [r["max_abs_err"] for r in k1_rows]), sl["launches"]),
        entry("pairwise_sq_l2", "src/repro_torch/csrc/pairwise_l2.cu",
              "src/repro/kernels/pairwise_l2.py:102", k2_rows[0],
              max([k2_err] + [r["max_abs_err"] for r in k2_rows]), sl["launches"]),
        entry("eps_count", eps_src, "src/repro/kernels/pairwise_l2.py:211",
              eps_rows[0], float(eps_counts), ov["launches"]),
        entry("eps_min_label", eps_src, "src/repro/kernels/pairwise_l2.py:238",
              eps_rows[1], float(max(v["k4_max"] for v in eps_data.values())), ov["launches"]),
        entry("eps_nearest_core", eps_src, "src/repro/kernels/pairwise_l2.py:270",
              eps_rows[2], eps_d2, ov["launches"]),
        # K6/K7: launches of the serving runs on the f32 and the int8
        # datastore (phase 11); times at the engine's decode batch, Q = 8
        entry("knn_topk", "src/repro_torch/csrc/knn_topk.cu",
              "src/repro/kernels/topk.py:103", sv["times"][0],
              max(v["k6"]["max_abs_err"] for v in sv["scale"].values()),
              {"knn_topk": sv["runs"]["f32"]["steps"]}),
        entry("pairwise_sq_l2_int8", "src/repro_torch/csrc/pairwise_int8.cu",
              "src/repro/kernels/pairwise_l2.py:310", sv["times"][1],
              max(v["k7"]["max_abs_err"] for v in sv["scale"].values()),
              {"pairwise_sq_l2_int8": sv["runs"]["int8"]["steps"]}),
    ]
    if args.json:
        builds = {f"{n} {m}": dict(structure=b["structure"], links=b["links"],
                                   decision=b["decision"], **b["rows"][False])
                  for (n, m), b in ov["builds"].items()}
        detail = dict(card=smi, kernels=kernels, k1=k1_rows, k2=k2_rows, eps=eps_rows,
                      eps_data=eps_data, builds=builds, searches=ov["searches"],
                      dbscan=db, profile=prof_rows, serve=sv, stream=stream,
                      ward_stream=ward_stream, blob_obm=blob_obm, forest_serve=forest_serve,
                      nvcc_s=t_build, seconds=time.perf_counter() - t_start)
        out = Path(args.json)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(detail, indent=1, default=float))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
