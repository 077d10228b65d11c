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
   fewer than k reachable and a delta phase seeded with the main carry; and
   with a ``qmask`` (half the queries masked, f32 and int8, beam 1 and 4, a
   delta phase from a masked carry), an all-true mask equal to none;
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
   with their launch grid, the earlier run's time and ``cdist`` + ``topk``
   at Q = 8 on the serving datastore as this run's control; then one
   ``torch.profiler`` pass per baseline search for
   the device's busy share and launches;
9. K6 (``knn_topk``) and K7 (``pairwise_sq_l2_int8``) against their plain
   versions, bit-equal on grid rows (N < k, ragged N, D 5/64/896, k 1/8/16,
   Q on both sides of K6's two block shapes, exact ties across the planner's
   row ranges);
10. K6 and K7 at data scale: a 2^20 x 896 datastore drawn on the card from
    ``embedding_datastore``'s recipe, Q = 8 and 1,024 (K6's stream and
    tiled block shapes), under the in-band
    rule against the plain versions and recall 1.0 up to ties against an
    f64 brute force;
11. kNN-LM serving: qwen2-0.5b at full width (seeded weights) in
    ``ServeEngine(num_slots=8, max_len=256)``, 16 requests of 8-64 prompt
    tokens and 32 new tokens, with retrieval off, on the f32 datastore (K6)
    and on its int8 twin (K7): every request completes, the books balance,
    K6/K7 launch once per decode step, three captured steps' top-k held to
    the plain version; then the 2-slot vs 1-slot agreement (printed), a
    profiled window of decode steps and K6/K7 times beside the plain
    versions, ``cdist`` + ``topk``, the bound and K6's previous design, at
    Q = 8 and 1,024;
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
    its routed rows, K1 twice a decode step; K1 timed at D = 896;
16. the rest of the facade on forests built above: phase 13's streamed WARD
    index saved and loaded (file size, save and load seconds; searches
    bitwise equal to before the save, 2 K1 launches and at most 2 syncs a
    search), the same search with metrics on and off (bitwise equal, walls
    in turns), ``explain`` on WARD, Tracking VBM and the blob forest at beam
    1 and 4 (its result the search's bit for bit, contributing + wasted ==
    ``buckets_visited`` every query, the prefix invariant of its decode
    against the kernel's counters and a replay of the plain phase), the
    measured-waste trigger against a CPU twin, and ``to_prometheus()``
    parsed back;
17. the sharded and routed layouts on the forests above, four islands
    (``["cuda:0"] * 4``, or one per card where four are present): phase
    13's streamed WARD index under ``sharded`` and ``routed`` (fanout all,
    targeted, auto), 1,024 queries, f32 and int8, beam 1 and 4, bitwise
    equal to the single layout, island rows summing to the fleet counters,
    K1 launched S times a phase, the host syncs of a search, one ingest
    batch equal to the single layout's delta state, saved sharded and
    loaded routed; Tracking VBM's routed ``auto`` decision held to a CPU
    twin's; qwen2-0.5b at full width on phase 15's forest datastore under
    a routed layout, greedy tokens equal to the single layout's; the flat
    2^20 x 896 datastore and its int8 twin split over the islands in
    ``knn_logits`` under ``use_mesh``, equal to one scan, K6 / K7 once per
    island; the search walls (single / sharded / routed, in turns), each
    island's K1 time and the routed pruning share;
18. the model families (MoE, MLA, Mamba, RWKV, encoder-decoder, the vision
    stub) serving with kNN-LM retrieval: the ten smoke configurations at
    f32 compute on the card against the same seeded weights on the CPU;
    deepseek-v2-236b at its published widths, depth 3 (the dense first
    layer and 2 MoE layers, bf16 params, ~18.7 GB), and rwkv6-3b whole, each
    first with its prefill + decode held to its forward at f32 compute, then
    in ``ServeEngine(num_slots=8, max_len=256)`` with phase 11's request mix
    on flat stores of 2^18 x 5,120 and 65,536 x 2,560 keys (K6) and their
    int8 twins (K7), three captured steps' top-k held to the plain version;
    whisper-tiny whole through ``Model.prefill(frames=...)`` and 32 decode
    steps on a 65,536 x 384 store; qwen3-moe-235b-a22b, granite-20b,
    deepseek-67b and pixtral-12b at full width, depth 2, jamba at its smoke
    widths and its Mamba mixer alone at full width, decode held to forward;
    K6 / K7 timed at D = 5,120, 2,560 and 384;
19. training: one ``make_train_step`` step of each of the ten smoke
    configurations (AdamW or Adafactor as each names) at f32 compute on the
    card against the same seeded weights and batch on the CPU, loss,
    gradients and updated leaves held; qwen2-0.5b at its published widths
    and depth, first its f32 loss and gradients on 1 x 32 tokens card vs
    CPU, then ``Trainer.run`` for 200 steps of ``TokenPipeline`` batches of
    8 x 512 (bf16 compute, AdamW, remat), the loss held to fall by 2 nats,
    checkpoints at steps 100 and 200, and a fresh trainer resumed from step
    200 bit for bit; deepseek-v2-236b at its published widths, depth 3, its
    loss held to the forward's cross-entropy and its bf16 gradients finite;
20. the launch tooling and MoE's expert-parallel islands: one MoE layer at
    deepseek-v2-236b's published widths on four islands of the card under
    (data, model) = (1, 4) and (2, 2), the weight-stationary (T = 8),
    token-sharded (T = 2,048) and all-to-all paths each held to the
    single-device layer (f32 compute, atol 1e-4 of the output's scale,
    equal drop counts); qwen3-moe-235b-a22b at published widths, depth 2,
    f32: one train step's loss and gradients under (1, 4) with moe_a2a held
    to the single-device step's; deepseek-v2-236b depth 3 served with phase
    18's request mix under (1, 4), the MoE on islands and the f32 store
    split over them (K6 once per island per step), the split top-k and
    p_knn equal to one scan's bit for bit, its teacher-forced logits within
    1.5x the single bf16 run's own gap to f32 of that run; the train
    launcher with ``--mesh auto`` (20 steps) and ``--mesh prod`` refused
    (256 devices); the dry-run of {qwen2-0.5b, deepseek-v2-236b} x
    {train_4k, decode_32k} x {single, multi} in a child process started
    after phase 19 on a host core of its own, each record ok (no
    propagation error, replicated ops within the limit) and rendered by
    ``benchmarks/roofline.py``, and qwen2-0.5b's (1, 1) train step at 8 x
    512 counting the FLOPs that ``FlopCounterMode`` counts on the card.

The last lines are one JSON object of per-kernel numbers, then
``{"ok": true, "device": {...}}``; ``--json PATH`` also writes the full
per-shape detail there.  Imports nothing of JAX or of ``repro``.
"""
from __future__ import annotations

import json
import os
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


def device_kernels(prof) -> list:
    """The device's operations in a ``torch.profiler`` profile
    (``key_averages``), without the user ranges the profiler also draws on
    the device's timeline (the program's spans and search phases open as
    ranges while a profiler records): those are no work of the device, and
    the kernels inside them already count their time."""
    import torch

    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


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


def compare_phase(args, what: str, qmask=None):
    """The K1 phase kernel against the plain phase on the same operands:
    bit for bit in top_d, top_i, visits, ndist, npad and qsteps.  With a
    ``qmask``, a masked query must also keep its carry with zero counters."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.bucket_scan import bucket_scan_phase_cuda

    got = bucket_scan_phase_cuda(*args, qmask=qmask)
    want = ref.bucket_scan_phase_ref(*args, qmask=qmask)
    torch.cuda.synchronize()
    for name, a, b in zip(("top_d", "top_i", "visits", "ndist", "npad", "qsteps"), got, want):
        require(a.dtype == b.dtype and torch.equal(a, b), f"K1 {what}: {name} differs")
    if qmask is not None:
        off = ~qmask
        require(torch.equal(got[0][off], args[7][off]) and torch.equal(got[1][off], args[8][off]),
                f"K1 {what}: a masked query's carry changed")
        require(all(bool((c[off] == 0).all()) for c in got[2:]),
                f"K1 {what}: a masked query did work")
    return got


def check_k1_qmask(dev, gen) -> int:
    """K1 with a ``qmask`` (the routed layout's host pruning) against the
    plain phase, bit for bit on grid rows: f32 and int8, beam 1 and 4, half
    the queries masked (WARD's and Tracking's widths and a small case), a
    delta phase seeded from a masked carry; and an all-true mask
    bit-identical to no mask, kernel against kernel."""
    import torch

    from repro_torch.kernels.bucket_scan import bucket_scan_phase_cuda

    n = 0
    for shape in [(NQ, 1498, 1000, 5, 1, K), (NQ, 1498, 1000, 5, 4, K),
                  (NQ, 841, 250, 20, 1, K), (NQ, 841, 250, 20, 4, K), (5, 13, 4, 8, 4, 11)]:
        for int8 in (False, True):
            args = phase_problem(gen, dev, *shape, int8=int8)
            mask = torch.rand(shape[0], generator=gen, device=dev) < 0.5
            compare_phase(args, f"{shape} int8={int8} half masked", qmask=mask)
            full = bucket_scan_phase_cuda(*args, qmask=torch.ones_like(mask))
            none = bucket_scan_phase_cuda(*args)
            torch.cuda.synchronize()
            require(all(torch.equal(a, b) for a, b in zip(full, none)),
                    f"K1 {shape} int8={int8}: an all-true qmask differs from no qmask")
            n += 2
    for beam in (1, 4):
        main = phase_problem(gen, dev, 256, 40, 64, 5, beam, K)
        mask = torch.rand(256, generator=gen, device=dev) < 0.5
        carry = compare_phase(main, f"masked main phase beam={beam}", qmask=mask)
        delta = phase_problem(gen, dev, 256, 8, 50, 5, beam, K, pad=0.5)
        delta[0], delta[7], delta[8] = main[0], carry[0], carry[1]
        compare_phase(delta, f"delta phase seeded from a masked carry beam={beam}", qmask=mask)
        n += 2
    return n


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
    n_mask = check_k1_qmask(dev, gen)
    log(f"[K1] {n} phases equal the plain phase bit for bit on the card (grid rows; "
        f"f32 and int8, beam 1/3/4, main-path widths, C = 2500, kk = 300, exact ties, "
        f"fewer than k, a delta-seeded carry); steps per phase {min(steps)}-{max(steps)}; "
        f"with qmask: {n_mask} phases (half the queries masked, f32 and int8, beam 1/4, "
        f"a delta phase from a masked carry) equal the plain phase bit for bit, and an "
        f"all-true qmask equals no qmask bit for bit")
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
# NVIDIA H100 80GB HBM3, 700.00 W), each with the design it had then: K3,
# K6 and K7 were redesigned since (K6 from three launches a call to one).
# ``cdist`` + ``topk`` at Q = 8 on the serving datastore runs library code
# this repository does not change, so its time in this run (the control)
# says whether this card runs as that one did.
EARLIER_EPS_MS = {
    ("eps_count", "WARD"): 586.7, ("eps_min_label", "WARD"): 382.6,
    ("eps_nearest_core", "WARD"): 460.5, ("eps_count", "Tracking"): 7.66,
    ("eps_min_label", "Tracking"): 4.09, ("eps_nearest_core", "Tracking"): 4.62,
}
EARLIER_SERVE_MS = {("knn_topk", 8): 1.564, ("knn_topk", 1024): 117.9,
                    ("pairwise_sq_l2_int8", 8): 1.041, ("pairwise_sq_l2_int8", 1024): 113.3}
# K6's previous (three-launch) design at Q = 8 on the families' stores and on
# one island's quarter, keyed by (N, D)
EARLIER_K6_MS = {(1 << 18, 5120): 2.297, (65_536, 2560): 0.418, (65_536, 384): 0.109,
                 (65_536, 5120): 0.784}
EARLIER_CONTROL_MS = 10.12  # cdist + topk, Q = 8 on the serving datastore
# K6's rows are timed behind ~0.5 ms of queued sleep (``device_ms``'s
# launches_hint): its wrapper's host side (the plan, the scratch) can take
# longer than the default 0.1 ms on the card machine's host, which would
# put host time inside the measured interval.
K6_SLEEP = 5


def library_control(keys) -> float:
    """``cdist`` + ``topk`` at Q = 8 on the serving datastore, ms: the
    same-run control."""
    import torch

    q = retrieval_problem(keys, 8, SEED + 8)
    return device_ms(lambda: torch.topk(torch.cdist(q, keys).square_(), SERVE_K, dim=1,
                                        largest=False), reps=21, launches_hint=K6_SLEEP)


def control_text(control_ms: float) -> str:
    return (f"control cdist+topk Q=8 {control_ms:.3f} ms in this run against "
            f"{EARLIER_CONTROL_MS:.2f} ms earlier")


def time_eps(built, overlap, smi: str, control_ms: float) -> list[dict]:
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
    and the control's time in this run (``control_ms``)."""
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
                             launches_per_build=per_build[kname], control_ms=control_ms,
                             card=smi))
            log(f"[time] {kname} {name} ({n} x {n} x {d}, {cols} columns computed) on {smi}: "
                f"kernel {ms:.2f} ms, grid {tuple(grid)}, plain {plain_ms:.2f} ms (blocks "
                f"of {blk} rows), bound {b_ms:.2f} ms by {by} ({b_ms / ms:.1%} of it); "
                f"earlier run (PERF.md) {earlier:.2f} ms; {control_text(control_ms)}; "
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


def visited_slots(args):
    """The (Q, W) slots of ``order`` that the lockstep plain phase makes
    active, and its final carry: replays ``ref.bucket_scan_phase_ref`` step
    by step."""
    import torch

    from repro_torch.kernels import ref

    q, bx, ids, count, order, lb, beam, top_d, top_i, scale = args
    visited = torch.zeros(order.shape, dtype=torch.bool, device=q.device)
    for t in range(order.shape[1] // beam):
        lo = t * beam
        act = lb[:, lo:lo + beam] <= torch.sqrt(top_d[:, -1])[:, None]
        if not bool(act.any()):
            break
        visited[:, lo:lo + beam] = act
        top_d, top_i = ref.bucket_scan_topk_ref(q, bx, ids, order[:, lo:lo + beam], act,
                                                top_d, top_i, scale)
    return visited, top_d, top_i


def touched_buckets(args):
    """Buckets the lockstep plain phase makes active (each once)."""
    import torch

    visited, _, _ = visited_slots(args)
    touched = torch.zeros(args[1].shape[0], dtype=torch.bool, device=args[0].device)
    touched[args[4][visited].long()] = True
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
    from repro_torch.kernels.bucket_scan import blocks_per_sm, bucket_scan_phase_cuda

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
            # what the kernel copies through L2: rows [0, extent) of the
            # bucket (ids, rows, scales) for every (query, active slot) visit
            staged = torch.zeros(qn, dtype=torch.int32, device=q.device)
            bucket_scan_phase_cuda(*args, staged=staged)
            staged_share = float(staged.sum()) / max(float(got[4].sum()), 1.0)
            gathered = float(staged.sum()) * (4 + row_bytes)
            blocks = blocks_per_sm(cap, d, kk, beam, int8=quantize)
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
                             gathered=gathered, staged_share=staged_share,
                             blocks_per_sm=blocks, qsteps_max=int(qsteps.max()), qsteps_mean=float(st.mean()),
                             max_abs_err=err, counters_differ=int(differ.sum())))
            log(f"[time] K1 {name} {kind} beam={beam} (Q={qn}, C={cap}, D={d}), one phase: "
                f"kernel {ms * 1e3:.1f} us/launch, plain {plain:.2f} ms, bound "
                f"{b_ms * 1e3:.2f} us by {by} ({b_ms / ms:.1%} of it; {nbytes} B: "
                f"{int(touched.sum())} distinct buckets once, queries, visited slots, "
                f"carry and outputs); {gathered / 1e9:.3f} GB copied through L2 "
                f"({staged_share:.1%} of the visited capacity), "
                f"{gathered / ms / 1e9:.2f} TB/s; {blocks} blocks an SM; "
                f"qsteps max {int(qsteps.max())} mean {float(st.mean()):.2f}; "
                f"max |kernel - plain| {err:.2e}, counters differ on {int(differ.sum())} queries")
    return rows


def profile_searches(built, results) -> list[dict]:
    """One profiled search per dataset and beam (f32): device time summed
    over the kernels the profiler saw, K1's and K2's share of it, and the
    device busy share against the same search's unprofiled wall time from
    the slice phase (the profiler's own host overhead inflates its wall)."""
    from torch.profiler import ProfilerActivity, profile

    walls = {(n, qz, bm): w for n, qz, bm, _, w in results}
    rows = []
    for name, b in built.items():
        ix = b["idx"][False]
        for beam in (1, 4):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                ix.search(b["q"], k=K, beam=beam)
            kernels = device_kernels(prof)
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
    Q on both sides of K6's block shapes (stream Q <= 32, tiled above), and
    exact ties from rows duplicated into the planner's last row range."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.pairwise_l2 import pairwise_sq_l2_int8_cuda
    from repro_torch.kernels.topk import knn_topk_cuda, plan

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases, regimes = 0, set()
    for d in (5, 64, 896):
        for qn, n in ((3, 5), (8, 1000), (9, 3001), (32, 4099), (33, 4099), (1030, 2049),
                      (8, 70_001), (40, 70_001)):
            for k in (1, 8, 16):
                q, x = grid_rows(gen, dev, qn, d), grid_rows(gen, dev, n, d)
                p = plan(qn, n, k, sms)
                regimes.add(p.regime)
                if p.ranges > 1:  # a duplicate of row 1 in the last range
                    x[n - 1] = x[1]
                    q[0] = x[1]
                kv, ki = knn_topk_cuda(q, x, k)
                rv, ri = ref.knn_topk_ref(q, x, k)
                torch.cuda.synchronize()
                require(torch.equal(kv, rv) and torch.equal(ki, ri),
                        f"K6 differs from its plain version at {(qn, n, d, k)}")
                if p.ranges > 1 and k > 1:
                    require(int(ki[0, 0]) == 1 and int(ki[0, 1]) == n - 1,
                            f"K6 tie order across row ranges at {(qn, n, d, k)}")
                cases += 1
            xq = torch.randint(-127, 128, (n, d), generator=gen, device=dev).to(torch.int8)
            s = 2.0 ** -torch.randint(4, 8, (n,), generator=gen, device=dev).float()
            got = pairwise_sq_l2_int8_cuda(q, xq, s)
            want = ref.pairwise_sq_l2_int8_ref(q, xq, s)
            torch.cuda.synchronize()
            require(torch.equal(got, want), f"K7 differs from its plain version at {(qn, n, d)}")
            cases += 1
    require(regimes == {"stream", "tiled"}, f"K6 grid cases ran {regimes} only")
    log(f"[K6/K7] {cases} grid cases bit-equal to the plain versions (N < k, ragged N, "
        "D 5/64/896, k 1/8/16, K6 stream and tiled, exact ties across row ranges)")
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
    from repro_torch.kernels.topk import knn_topk_cuda, plan

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
        regime = plan(nq, SERVE_N, SERVE_K, torch.cuda.get_device_properties(dev)
                      .multi_processor_count).regime
        log(f"[K6/K7] Q={nq} x {SERVE_N} x {SERVE_D}, k={SERVE_K}: K6 ({regime}) max "
            f"|kernel - plain| "
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


def hold_captured(ds, kept, k: int, what: str) -> int:
    """The kernel top-k (K6, or K7 + the stable selection) of each captured
    step's queries held to the plain version by ``hold_topk``; three steps
    must have been captured."""
    import torch

    from repro_torch.kernels import ops, ref

    xf = ds.keys if ds.scale is None else ds.keys.float() * ds.scale[:, None]
    xx_max = max_sq_norm(xf)
    for q in kept:
        if ds.scale is None:
            kv, ki = ops.knn_topk(q, ds.keys, k=k)
            rv, ri = ref.knn_topk_ref(q, ds.keys, k + 1)
        else:
            kv, ki = ref.topk_smallest(ops.pairwise_sq_l2_int8(q, ds.keys, ds.scale), k)
            rv, ri = ref.topk_smallest(ref.pairwise_sq_l2_int8_ref(q, ds.keys, ds.scale), k + 1)
        hold_topk(kv, ki.to(torch.int32), rv[:, :-1], ri[:, :-1].to(torch.int32),
                  rv[:, -1], q, xf, xx_max, f"{what} step")
    require(len(kept) == 3, f"{what}: {len(kept)} steps captured, want 3")
    return len(kept)


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

    from repro_torch.kernels import ops
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
            checked = hold_captured(ds, rec.kept, cfg.retrieval.k, f"serving {name}")
        hist = reg.snapshot()["histograms"]
        lat = hist["serve.request_latency_s"]
        step_ms = float(np.median(eng._step_times)) * 1e3
        runs[name] = dict(steps=eng.steps, tokens=int(toks.size), wall_s=wall,
                          tok_per_s=toks.size / wall, p50_s=lat["p50"], p99_s=lat["p99"],
                          step_ms=step_ms, prefill_ms=hist["serve.prefill"]["p50"] * 1e3,
                          launches={k: v for k, v in launches.items() if v},
                          checked_steps=checked)
        log(f"[serve] {cfg.name} ({cfg.num_layers} layers), retrieval {name}: 16 requests x 32 tokens in "
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
                    kernel=("K6", ("knn_topk",)), what="f32 datastore") -> dict:
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
    kernels = device_kernels(prof)
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
    anything).  ``cdist`` + ``topk`` at Q = 8 is the same-run control of
    K7's times."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.pairwise_l2 import pairwise_sq_l2_int8_cuda
    from repro_torch.kernels.topk import knn_topk_cuda, plan

    n, d, k = SERVE_N, SERVE_D, SERVE_K
    rows = []
    control_ms = None
    for nq in (8, 1024):
        q = retrieval_problem(keys, nq, SEED + nq)
        reps = 21 if nq == 8 else 3  # Q = 8 times move a few % between reps
        flops = 2.0 * nq * n * d + 2.0 * (nq + n) * d
        ms = device_ms(lambda: knn_topk_cuda(q, keys, k), reps=reps, launches_hint=K6_SLEEP)
        plain = device_ms(lambda: ref.knn_topk_ref(q, keys, k), reps=reps,
                          launches_hint=K6_SLEEP)
        lib = device_ms(lambda: torch.topk(torch.cdist(q, keys).square_(), k, dim=1,
                                           largest=False), reps=reps, launches_hint=K6_SLEEP)
        control_ms = lib if nq == 8 else control_ms
        nbytes = 4 * (nq * d + n * d) + 8 * nq * k
        b_ms, by = bound(nbytes, flops)
        earlier = EARLIER_SERVE_MS[("knn_topk", nq)]
        p = plan(nq, n, k, torch.cuda.get_device_properties(dev).multi_processor_count)
        rows.append(dict(name="knn_topk", shape=f"Q={nq} N={n} D={d} k={k}", nq=nq, ms=ms,
                         plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=by,
                         bytes=nbytes, flops=flops, earlier_ms=earlier, regime=p.regime,
                         grid=[p.q_tiles, p.ranges]))
        log(f"[time] K6 knn_topk Q={nq} N={n} D={d} k={k} ({p.regime}, grid "
            f"{p.q_tiles} x {p.ranges}): kernel {ms:.3f} ms, plain {plain:.3f} ms, "
            f"cdist+topk {lib:.3f} ms, bound {b_ms:.3f} ms by {by} ({b_ms / ms:.1%} of it); "
            f"previous design (PERF.md) {earlier:.3f} ms")
        ms = device_ms(lambda: pairwise_sq_l2_int8_cuda(q, xq, scale), reps=reps)
        plain = device_ms(lambda: ref.pairwise_sq_l2_int8_ref(q, xq, scale), reps=reps)
        nbytes = 4 * nq * d + n * d + 4 * n + 4 * nq * n
        b_ms, by = bound(nbytes, flops + float(n) * d)
        earlier = EARLIER_SERVE_MS[("pairwise_sq_l2_int8", nq)]
        row = dict(name="pairwise_sq_l2_int8", shape=f"Q={nq} N={n} D={d}", nq=nq,
                   ms=ms, plain_ms=plain, library_ms=None, bound_ms=b_ms, bound_by=by,
                   bytes=nbytes, flops=flops + float(n) * d, earlier_ms=earlier,
                   control_ms=control_ms)
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
            f"run (PERF.md, previous design) {earlier:.3f} ms; {control_text(control_ms)}"
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
    host syncs and K1 launches of one search.  Returns (the numbers, the
    card's streamed index)."""
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
    return out, card


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
    # phase 17 serves the same index under a routed layout
    return out, dict(ix=built["ix"], values=(values % cfg.vocab_size).cpu().numpy(),
                     prompts=prompts, stream=stream_np, tokens=tokens)


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
# phase 16: persistence, telemetry and explain
# --------------------------------------------------------------------------

def same_result(a, b) -> bool:
    """Two SearchResults bit for bit: distances, ids and every counter."""
    import numpy as np

    return (np.array_equal(a.dists, b.dists) and np.array_equal(a.ids, b.ids)
            and all(np.array_equal(a.stats[k], b.stats[k]) for k in a.stats))


def alternate_ms(calls: dict, reps: int = 7) -> dict:
    """Host wall ms of each call (each returns host arrays, so each is
    synchronised), the calls taken in turns after one warm-up each:
    {name: (first quartile, median, third quartile)}."""
    for fn in calls.values():
        fn()
    times = {name: [] for name in calls}
    for _ in range(reps):
        for name, fn in calls.items():
            t0 = time.perf_counter()
            fn()
            times[name].append((time.perf_counter() - t0) * 1e3)
    return {name: tuple(statistics.quantiles(v, n=4)[:1]) + (statistics.median(v),)
            + tuple(statistics.quantiles(v, n=4)[2:]) for name, v in times.items()}


def check_explain_prefix(ix, q, beam: int) -> dict:
    """The decode's invariant on the card, at ``beam``: a phase visits
    exactly the first ``visits`` entries of its ``order``.

    * the kernel's own accounting: each query's ``distances`` counter equals
      the bucket sizes summed over the decoded prefixes (main and delta),
      every query;
    * the plain lockstep phase replayed on the same operands (the search's
      route, bounds and order; the delta phase seeded with the replay's
      main carry) visits a prefix of ``order``, every query, and its length
      equals the kernel's visit count except where a bound lies within the
      rounding of the k-th best (the two round member distances apart):
      at most 1% of queries, each by at most ``beam`` visits, the rule of
      ``check_kernel_vs_plain_search``."""
    import torch

    from repro_torch.core.knn import delta_bounds, knn_search_explain_impl, route_select
    from repro_torch.stream.ingest import delta_view

    args = phase_operands(ix, q, beam)
    qt, df = args[0], ix.device
    dv = None if ix.device_delta is None else delta_view(ix.device_delta)
    _, _, st, rows = knn_search_explain_impl(df, qt, k=K, beam=beam, delta=dv)
    require(torch.equal(rows.order, args[4]), "the explain plan's order is not the search's")
    count = args[3]
    cols = torch.arange(rows.order.shape[1], device=qt.device)[None]
    kernel_prefix = cols < rows.visits[0][:, None]
    ndist = torch.where(kernel_prefix, count[rows.order.long()], 0).sum(1)
    replay, top_d, top_i = visited_slots(args)
    phases = [(replay, rows.visits[0])]
    if dv is not None:
        dcount = dv.mask.sum(1, dtype=torch.int32)
        dcols = torch.arange(rows.dorder.shape[1], device=qt.device)[None]
        ndist = ndist + torch.where(dcols < rows.dvisits[0][:, None],
                                    dcount[rows.dorder.long()], 0).sum(1)
        sel, _, _ = route_select(df, qt)
        db = delta_bounds(dv, qt, sel, beam=beam)
        require(torch.equal(db.order, rows.dorder), "the delta order is not the search's")
        dreplay, _, _ = visited_slots([qt, dv.x, dv.ids, dcount, db.order, db.lb_sorted, beam,
                                       top_d, top_i, None])
        phases.append((dreplay, rows.dvisits[0]))
    require(torch.equal(ndist.to(torch.int32), st.distances),
            "a kernel's distances counter is not the decoded prefix's bucket sizes")
    differ = torch.zeros(qt.shape[0], dtype=torch.bool, device=qt.device)
    worst = 0
    for seen, kvis in phases:
        own = seen.sum(1)
        w = torch.arange(seen.shape[1], device=qt.device)[None]
        require(torch.equal(seen, w < own[:, None]), "the replayed phase skipped a slot")
        gap = (own - kvis).abs()
        differ |= gap > 0
        worst = max(worst, int(gap.max()))
    require(float(differ.double().mean()) <= 0.01 and worst <= beam,
            f"replayed visits differ from the kernel's on {int(differ.sum())} queries "
            f"(by up to {worst})")
    return dict(queries_differ=int(differ.sum()), max_gap=worst)


def counters_survive_prometheus(ix) -> int:
    """``to_prometheus()`` parsed back: every registry counter comes back
    under its sanitized name and labels with its value.  Returns the
    number of counters checked."""
    from repro_torch.obs import export

    got = {(s["name"], tuple(sorted(s["labels"].items()))): s["value"]
           for s in export.parse_prometheus(ix.obs.to_prometheus())}
    counters = ix.obs.snapshot()["counters"]
    for key, val in counters.items():
        name, labels = export._split_key(key)
        back = got.get((export._sanitize(name), tuple(sorted(labels.items()))))
        require(back == val, f"counter {key} = {val} came back as {back}")
    return len(counters)


def persist_explain_phase(dev, ward, tracking, blob, smi: str) -> dict:
    """Phase 16: the rest of the single-device facade on forests earlier
    phases built (nothing new is built).

    * ``save`` / ``load``: phase 13's streamed WARD 1M VBM index, delta
      included, to a temporary directory and back onto the card; the 1,024
      queries' searches (f32, beam 1 and 4, forest and all) bitwise equal to
      the index's before the save, 2 K1 launches and at most 2 host syncs a
      search;
    * metrics on and off: the same WARD search on the loaded index and on a
      twin with ``ObsConfig(enabled=False)``, bitwise equal, walls taken in
      turns;
    * ``explain`` on WARD, Tracking VBM and the blob forest, beam 1 and 4:
      ``report.result`` bitwise equal to ``search()``, contributing + wasted
      == ``buckets_visited`` every query, the prefix invariant
      (``check_explain_prefix``); explain's syncs and wall beside the
      search's, the wasted fraction and the top wasted pairs;
    * the measured-waste trigger: the blob forest with ``wasted_rebuild``
      set, on the card and on a CPU twin, the same ingest and explain calls,
      then ``maintain()``: the ``wasted`` triggers equal;
    * ``to_prometheus()`` of the loaded WARD index parses back with every
      counter intact."""
    import dataclasses
    import os
    import tempfile

    import numpy as np
    import torch

    from repro_torch.api import Config, ObsConfig, OverlapIndex, StreamConfig

    t_phase = time.perf_counter()
    q = make_queries(ward.x_all, SEED + 16)
    searches = [(b, m) for b in (1, 4) for m in ("forest", "all")]
    before = {s: ward.search(q, k=K, beam=s[0], mode=s[1]) for s in searches}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path = ward.save(os.path.join(tmp, "ward"))
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        lx = OverlapIndex.load(path, device=dev)
        load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lx.device  # the upload
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    for s in searches:
        require(same_result(lx.search(q, k=K, beam=s[0], mode=s[1]), before[s]),
                f"WARD after load, beam {s[0]} {s[1]}: not bitwise equal to before the save")
    per = one_search_launches(lx, q)
    require(per["bucket_scan_topk"] == 2, f"K1 launched {per['bucket_scan_topk']} times a "
            "search after load")
    syncs = count_syncs(lambda: lx.search(q, k=K))
    require(syncs <= 2, f"a search after load synchronises {syncs} times")
    log(f"[persist] WARD {lx.n_total:,} x {lx.x_all.shape[1]} VBM + delta "
        f"({sum(lx.structure()['delta_fill'])} "
        f"rows): save {save_s:.3f} s, {size / 1e6:.2f} MB on disk; load {load_s:.3f} s, upload "
        f"{upload_s:.3f} s; searches beam 1/4 forest/all bitwise equal to before the save; K1 "
        f"launches {per['bucket_scan_topk']}, host syncs {syncs} a search ({smi})")

    off = OverlapIndex._wire(
        lx.x_all, lx.forest, dataclasses.replace(lx.cfg, obs=ObsConfig(enabled=False)),
        lx.build_report, dev, n_total=lx.n_total, delta=lx.device_delta, capacity=lx.capacity,
        monitor_baseline=lx.monitor.rates_baseline)
    require(same_result(lx.search(q, k=K), off.search(q, k=K)),
            "metrics on and off give different results")
    walls = alternate_ms({"on": lambda: lx.search(q, k=K), "off": lambda: off.search(q, k=K)},
                         reps=25)
    syncs_on = count_syncs(lambda: lx.search(q, k=K))
    require(syncs_on <= 2, f"a search with metrics on synchronises {syncs_on} times")
    log(f"[metrics] WARD f32 beam 1, {NQ} queries, 25 of each in turns: metrics on "
        f"{walls['on'][1]:.3f} ms (quartiles {walls['on'][0]:.3f}-{walls['on'][2]:.3f}), off "
        f"{walls['off'][1]:.3f} ms ({walls['off'][0]:.3f}-{walls['off'][2]:.3f}); results "
        f"bitwise equal, {syncs_on} syncs with metrics on ({smi})")

    explain = {}
    for name, ix in (("WARD", lx), ("Tracking", tracking), ("Blob", blob)):
        qx = q if name == "WARD" else make_queries(ix.x_all, SEED + 16)
        for beam in (1, 4):
            res = ix.search(qx, k=K, beam=beam)
            rep = ix.explain(qx, k=K, beam=beam, feed_monitor=False)
            require(same_result(rep.result, res), f"{name} beam {beam}: explain's result is "
                    "not the search's")
            require(np.array_equal(rep.contributing + rep.wasted,
                                   res.stats["buckets_visited"]),
                    f"{name} beam {beam}: contributing + wasted != buckets_visited")
            prefix = check_explain_prefix(ix, qx, beam)
            ex_syncs = count_syncs(lambda: ix.explain(qx, k=K, beam=beam, feed_monitor=False))
            ms = alternate_ms({
                "search": lambda: ix.search(qx, k=K, beam=beam),
                "explain": lambda: ix.explain(qx, k=K, beam=beam, feed_monitor=False)}, reps=5)
            row = dict(search_ms=ms["search"][1], explain_ms=ms["explain"][1], syncs=ex_syncs,
                       wasted_fraction=rep.wasted_fraction, visits=rep.total_visits,
                       top_pairs=rep.top_pairs(3), **prefix)
            explain[f"{name} beam {beam}"] = row
            log(f"[explain] {name} {ix.n_total:,} x {ix.x_all.shape[1]} ({ix.n_indexes} "
                f"indexes) beam {beam}: result bitwise the search's, contributing + wasted == "
                f"buckets_visited on all {len(qx)} queries; prefix invariant held (replay vs "
                f"kernel visits differ on {prefix['queries_differ']} queries, by <= "
                f"{prefix['max_gap']}); explain {ms['explain'][1]:.2f} ms vs search "
                f"{ms['search'][1]:.2f} ms wall (medians of 5), {ex_syncs} syncs; wasted "
                f"{rep.wasted_fraction:.4f} of {rep.total_visits} visits; top wasted pairs "
                f"{rep.top_pairs(3)} ({smi})")

    cfg = Config(index=blob.cfg.index, stream=StreamConfig(capacity=64, wasted_rebuild=0.05))
    twins = [OverlapIndex._wire(blob.x_all, blob.forest, cfg, blob.build_report, d)
             for d in (dev, torch.device("cpu"))]
    g = np.random.default_rng(SEED + 16)
    xb = (blob.x_all[g.choice(blob.n_total, 48)]
          + 0.1 * g.normal(size=(48, blob.x_all.shape[1]))).astype(np.float32)
    qw = np.concatenate([make_queries(blob.x_all, SEED + 17)[:32],
                         g.uniform(-15, 15, size=(32, blob.x_all.shape[1])).astype(np.float32)])
    reps, wasted = [], []
    for ix in twins:
        ix.ingest(xb)
        reps.append(ix.explain(qw, k=5))
        wasted.append({i: w for i, w in ix.maintain().reasons.items() if "wasted" in w})
    rc, rh = reps
    n_diff = int((rc.wasted != rh.wasted).sum() + (rc.home != rh.home).sum())
    require(wasted[0] == wasted[1] and wasted[0],
            f"wasted triggers {wasted[0]} on the card, {wasted[1]} on the CPU")
    log(f"[explain] blob wasted_rebuild 0.05: maintain()'s wasted triggers {sorted(wasted[0])} "
        f"on the card equal the CPU twin's; per-query wasted / home entries differing "
        f"{n_diff} ({smi})")

    n_counters = counters_survive_prometheus(lx)
    log(f"[metrics] WARD to_prometheus(): {n_counters} counters parse back intact")
    return dict(save_s=save_s, load_s=load_s, upload_s=upload_s, file_bytes=size,
                k1_per_search=per["bucket_scan_topk"], syncs=syncs, metrics_ms=walls,
                metrics_on_syncs=syncs_on, explain=explain,
                wasted_triggers=sorted(wasted[0]), twin_differ=n_diff,
                prometheus_counters=n_counters, seconds=time.perf_counter() - t_phase)


# --------------------------------------------------------------------------

# --------------------------------------------------------------------------
# phase 17: the sharded and routed layouts
# --------------------------------------------------------------------------

LAYOUT_SHARDS = 4
FANOUTS = ("all", "targeted", "auto")


def layout_islands() -> list:
    """Four islands: one per card where four are present, else four on
    cuda:0 (islands on one card run one after another on its stream)."""
    import torch

    if torch.cuda.device_count() >= LAYOUT_SHARDS:
        return [f"cuda:{i}" for i in range(LAYOUT_SHARDS)]
    return ["cuda:0"] * LAYOUT_SHARDS


def layouts() -> dict:
    from repro_torch.api import LayoutConfig, RoutingConfig

    out = {"sharded": LayoutConfig(kind="sharded", shards=LAYOUT_SHARDS)}
    for f in FANOUTS:
        out[f"routed {f}"] = LayoutConfig(kind="routed", shards=LAYOUT_SHARDS,
                                          routing=RoutingConfig(fanout=f))
    return out


def layout_twin(ix, layout, devices, *, quantize: bool = False):
    """``ix``'s forest and live delta under another layout (a fresh index on
    the same state; the streaming writes are functional, so neither index
    changes the other)."""
    import dataclasses

    from repro_torch.api import OverlapIndex

    cfg = dataclasses.replace(ix.cfg, layout=layout,
                              search=dataclasses.replace(ix.cfg.search, quantize=quantize))
    return OverlapIndex._wire(ix.x_all, ix.forest, cfg, ix.build_report, devices,
                              n_total=ix.n_total, delta=ix.delta, capacity=ix.capacity)


def router_stats(ix, q):
    """One search's RouterStats (host numpy) through the routed backend's
    own decision (``router.route_dispatch``), without the scan."""
    import torch

    from repro_torch.distributed import router

    b = ix.backend
    delta = None if ix.device_delta is None else b.delta_view(ix.device_delta)
    _, r = router.route_dispatch(b.mesh, ix.device, torch.from_numpy(q).to(b.device), delta,
                                 b.table, k=K, fanout=b.routing.fanout)
    return {f: getattr(r, f).cpu().numpy() for f in r._fields}


def island_k1_ms(ix, q) -> list:
    """Device ms of each island's main-phase K1 launch at beam 1, on the
    operands the island's search gives it (route, bounds over its rows)."""
    import torch

    from repro_torch.core.knn import bucket_bounds, route_select
    from repro_torch.kernels.bucket_scan import bucket_scan_phase_cuda

    parts = ix.device.parts if hasattr(ix.device, "parts") else [ix.device]
    out = []
    for part in parts:
        qd = torch.from_numpy(q).to(part.bucket_x.device)
        sel, _, _ = route_select(part, qd)
        if hasattr(ix.device, "parts"):
            sel = torch.nn.functional.pad(sel, (0, 1))  # the pad buckets' sentinel
        mb = bucket_bounds(part, qd, sel)
        count = torch.sum(part.bucket_mask, 1, dtype=torch.int32)
        top_d = torch.full((qd.shape[0], K), float("inf"), device=qd.device)
        top_i = torch.full((qd.shape[0], K), -1, dtype=torch.int32, device=qd.device)
        out.append(device_ms(lambda: bucket_scan_phase_cuda(
            qd, part.bucket_x, part.bucket_ids, count, mb.order, mb.lb_sorted, 1, top_d,
            top_i, part.bucket_scale)))
    return out


def ward_layout_phase(ward, islands, smi: str) -> dict:
    """WARD 1M + 16,384 streamed (phase 13's index, its delta live) under the
    sharded layout and the routed one (fanout all, targeted, auto): 1,024
    queries, f32 and int8, beam 1 and 4, bitwise equal to the single
    layout; island rows summing to the fleet counters; K1 launched S times
    a phase; the host syncs of a search; one ingest batch equal to the
    single layout's delta state; save under sharded, load under routed."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.api import LayoutConfig, OverlapIndex
    from repro_torch.data.synthetic import ward_like
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    q = make_queries(ward.x_all, SEED + 17)
    n_idx = ward.forest.n_indexes
    out = dict(layouts={})
    searches = [("forest", 1), ("forest", 4), ("all", 1)]
    for quantize in (False, True):
        single = layout_twin(ward, LayoutConfig(), islands[0], quantize=quantize)
        ref = {sb: single.search(q, k=K, mode=sb[0], beam=sb[1]) for sb in searches}
        fanall = {}
        for name, lay in layouts().items():
            ix = layout_twin(ward, lay, islands, quantize=quantize)
            ops.reset_launch_counts()
            spill = {}
            for mode, beam in searches:
                res = ix.search(q, k=K, mode=mode, beam=beam)
                what = f"WARD {name} int8={quantize} mode={mode} beam={beam}"
                spill[f"{mode} {beam}"] = hold_layout(res, ref[(mode, beam)], what,
                                                      exact=mode == "all")
                if name == "sharded":
                    fanall[(mode, beam)] = res
                else:  # host pruning is invisible: routed == sharded fan-all
                    require(same_dists_ids(res, fanall[(mode, beam)]),
                            f"{what}: results differ from the sharded fan-all's")
            launches = ops.launch_counts()
            m = ix.metrics()
            for key in ("buckets_visited", "distances"):
                require(sum(v[key] for v in m["islands"].values()) == m["search"][key],
                        f"WARD {name}: island {key} do not sum to the fleet's")
            summed = sum(v["bound_distances"] for v in m["islands"].values())
            # every island routes the queries itself (mode="forest" routes;
            # mode="all" does not)
            n_routed = sum(len(q) for mode, _ in searches if mode == "forest")
            require(summed == m["search"]["bound_distances"]
                    + (LAYOUT_SHARDS - 1) * n_routed * n_idx,
                    f"WARD {name}: island bound distances off the fleet's")
            per = one_search_launches(ix, q)
            require(per["bucket_scan_topk"] == 2 * LAYOUT_SHARDS,
                    f"WARD {name}: K1 launched {per['bucket_scan_topk']} times a search")
            syncs = count_syncs(lambda: ix.search(q, k=K))
            row = dict(launches=launches, per_search=per, syncs=syncs, spill=spill,
                       islands={s: v for s, v in m["islands"].items()},
                       router={k: v for k, v in m["router"].items() if k != "table"})
            if lay.kind == "routed":
                r = router_stats(ix, q)
                row["pruned_share"] = float(r["pruned_hosts"].sum()) / (len(q) * LAYOUT_SHARDS)
                row["eligible_mean"] = float(r["eligible_hosts"].mean())
                row["targeted"] = bool(r["targeted"])
            out["layouts"][f"{name} {'int8' if quantize else 'f32'}"] = row
            log(f"[layout] WARD {name} {'int8' if quantize else 'f32 '}: {len(q)} queries, "
                f"forest beam 1 and 4 and all beam 1: equal to the single layout bit for bit "
                f"but for {spill} queries where an island's underfilled scan found closer "
                f"rows (mode all: none); K1 {per['bucket_scan_topk']} "
                f"and K2 {per['pairwise_sq_l2']} launches a search; host syncs a search "
                f"{syncs}; island buckets_visited "
                f"{[v['buckets_visited'] for v in m['islands'].values()]}"
                + (f"; router: targeted={row['targeted']}, mean eligible hosts "
                   f"{row['eligible_mean']:.2f}, pruned share {row['pruned_share']:.4f}"
                   if lay.kind == "routed" else ""))

    # times, in turns: single / sharded / routed auto, f32 beam 1
    single = layout_twin(ward, LayoutConfig(), islands[0])
    sharded = layout_twin(ward, layouts()["sharded"], islands)
    routed = layout_twin(ward, layouts()["routed auto"], islands)
    walls = alternate_ms({"single": lambda: single.search(q, k=K),
                          "sharded": lambda: sharded.search(q, k=K),
                          "routed auto": lambda: routed.search(q, k=K)})
    out["search_ms"] = walls
    out["k1_single_ms"] = island_k1_ms(single, q)[0]
    out["k1_island_ms"] = island_k1_ms(sharded, q)
    log(f"[time] WARD search of {len(q)} queries, f32 beam 1 with the delta, host wall ms "
        f"(q1, median, q3), in turns: "
        + ", ".join(f"{k} {v[1]:.2f} ({v[0]:.2f}-{v[2]:.2f})" for k, v in walls.items())
        + f"; K1 main phase: single {out['k1_single_ms']:.3f} ms, islands "
        + ", ".join(f"{v:.3f}" for v in out["k1_island_ms"]) + f" ms ({smi})")

    # one ingest batch on both layouts: the same accepts and delta state
    batch = ward_like(1_024, seed=3)
    ids_single = single.ingest(batch)
    ids_sharded = sharded.ingest(batch)
    require(np.array_equal(ids_single, ids_sharded), "WARD ingest: ids differ")
    require(single.ingest_stats() == sharded.ingest_stats()
            and len(single.rebuild_log) == len(sharded.rebuild_log),
            "WARD ingest: the two layouts took different paths")
    ds, dh = single.delta, sharded.delta
    same = {n: bool(torch.equal(getattr(ds, n).cpu(), getattr(dh, n).cpu())) for n in DELTA_FIELDS}
    require(all(v for n, v in same.items() if n != "sum_x"),
            f"WARD ingest: the sharded delta differs from the single layout's: {same}")
    live = (torch.arange(ds.x.shape[1], device=ds.x.device)[None, :]
            < ds.count[:, None]).cpu().numpy()
    abs_sum = (np.abs(ds.x.cpu().numpy().astype(np.float64)) * live[..., None]).sum(1)
    sum_err = np.abs(ds.sum_x.cpu().numpy().astype(np.float64) - dh.sum_x.cpu().numpy())
    require(bool((sum_err <= ds.count.cpu().numpy()[:, None] * 2.0 ** -23 * abs_sum).all()),
            "WARD ingest: the sharded delta's sum_x off the single layout's")
    out["ingest"] = dict(bitwise=same, rebuilds=len(single.rebuild_log),
                         accepted=int(ds.count.sum()))
    res = single.search(q, k=K)
    hold_layout(sharded.search(q, k=K), res, "WARD: search after the ingest", exact=False)

    # save under sharded, load under routed
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path = sharded.save(Path(tmp) / "ward_sharded.npz")
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = OverlapIndex.load(path, layout=layouts()["routed auto"], device=islands)
        t_load = time.perf_counter() - t0
    require(loaded.backend.kind == "routed", "WARD load: not routed")
    for beam in (1, 4):
        require(same_dists_ids(loaded.search(q, k=K, beam=beam),
                               sharded.search(q, k=K, beam=beam)),
                f"WARD: saved sharded, loaded routed, beam={beam}: results differ")
    out.update(save_s=t_save, load_s=t_load, seconds=time.perf_counter() - t_phase)
    log(f"[layout] WARD one ingest batch of 1,024 on single and sharded: ids, accepts, "
        f"rebuilds ({len(single.rebuild_log)}) and delta state equal (bitwise: "
        f"{', '.join(n for n, v in same.items() if v)}; sum_x within the summation bound); "
        f"saved sharded {t_save:.2f} s, loaded routed {t_load:.2f} s, searches bitwise "
        f"equal; phase {out['seconds']:.1f} s ({smi})")
    return out


def same_dists_ids(a, b) -> bool:
    import numpy as np

    return np.array_equal(a.dists, b.dists) and np.array_equal(a.ids, b.ids)


def hold_layout(res, ref, what: str, *, exact: bool) -> int:
    """A sharded or routed result against the single layout's: bitwise equal
    per query, except (``mode="forest"`` only) queries where an island with
    fewer than k eligible members spilled into other indexes' buckets and
    found strictly closer rows than the single layout's routed scan, which
    the JAX package's sharded layout does too.  Returns that count."""
    import numpy as np

    differ = ~((res.dists == ref.dists).all(1) & (res.ids == ref.ids).all(1))
    if exact:
        require(not differ.any(), f"{what}: {int(differ.sum())} queries differ from the "
                "single layout's")
    better = res.dists[:, -1] < ref.dists[:, -1]
    require(bool((better | ~differ).all()),
            f"{what}: a query differs from the single layout's without closer rows")
    return int(differ.sum())


def tracking_router_phase(tracking, islands, smi: str) -> dict:
    """Tracking VBM (24 indexes) under the routed layout, fanout auto: the
    router's eligible and pruned hosts per query and its targeted/fan-all
    choice on the card, held to a CPU twin's (the same forest on four CPU
    islands), and the results bitwise equal to the single layout's."""
    import numpy as np

    from repro_torch.api import LayoutConfig

    lay = layouts()["routed auto"]
    card = layout_twin(tracking, lay, islands)
    host = layout_twin(tracking, lay, ["cpu"] * LAYOUT_SHARDS)
    q = make_queries(tracking.x_all, SEED + 18)
    rc, rh = router_stats(card, q), router_stats(host, q)
    for f in ("eligible_hosts", "pruned_hosts", "targeted"):
        require(np.array_equal(rc[f], rh[f]), f"Tracking router: {f} differs from the CPU twin's")
    for f in ("wire_targeted", "wire_fanall", "cost_targeted", "cost_fanall"):
        require(bool(np.isclose(rc[f], rh[f], rtol=1e-6)), f"Tracking router: {f} off the CPU's")
    single = layout_twin(tracking, LayoutConfig(), islands[0])
    fanall = layout_twin(tracking, layouts()["sharded"], islands)
    res = card.search(q, k=K)
    require(same_dists_ids(res, fanall.search(q, k=K)),
            "Tracking routed: results differ from the sharded fan-all's")
    spill = hold_layout(res, single.search(q, k=K), "Tracking routed", exact=False)
    hold_layout(card.search(q, k=K, mode="all"), single.search(q, k=K, mode="all"),
                "Tracking routed mode=all", exact=True)
    out = dict(n_indexes=tracking.forest.n_indexes, spill_queries=spill,
               eligible_hosts=int(rc["eligible_hosts"].sum()),
               pruned_hosts=int(rc["pruned_hosts"].sum()), targeted=bool(rc["targeted"]),
               cost_targeted=float(rc["cost_targeted"]), cost_fanall=float(rc["cost_fanall"]),
               host_counts=card.backend.table.host_counts.cpu().numpy().tolist())
    log(f"[layout] Tracking VBM ({out['n_indexes']} indexes) routed auto over "
        f"{LAYOUT_SHARDS} islands, {len(q)} queries: eligible hosts {out['eligible_hosts']} of "
        f"{len(q) * LAYOUT_SHARDS}, pruned {out['pruned_hosts']}, "
        f"{'targeted' if out['targeted'] else 'fan-all'} (priced {out['cost_targeted']:.4g} "
        f"vs {out['cost_fanall']:.4g} bytes), host members {out['host_counts']}; equal to "
        f"the CPU twin's decision; results bitwise equal to the sharded fan-all's, and to "
        f"the single layout's but for {spill} queries where an island's underfilled scan "
        f"found closer rows (mode all: bitwise equal) ({smi})")
    return out


def routed_serve_phase(dev, model, serve, islands, smi: str) -> dict:
    """qwen2-0.5b at full width on phase 15's 65,536 x 896 forest datastore,
    served from the single layout, the sharded layout and a routed layout
    (fanout auto) of four islands, each with phase 15's 16 requests and 16
    inserts.  Held: ``forest_knn`` on 1,024 queries equal to the single
    layout's but where an island's underfilled scan found strictly closer
    rows (as in the JAX package); the routed run's greedy tokens equal to
    the sharded fan-all run's (host pruning is invisible) and every run's
    accepts equal; the share of requests whose tokens equal the single
    run's printed, with K1 and K2 launches a decode step."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.api import OverlapIndex
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import IngestRequest, Request, ServeEngine
    from repro_torch.serve.retrieval import forest_knn

    ix = serve["ix"]
    srcs = {"single": ix}
    for name in ("sharded", "routed auto"):
        srcs[name] = OverlapIndex._wire(
            ix.x_all, ix.forest, dataclasses.replace(ix.cfg, layout=layouts()[name]),
            ix.build_report, islands)
    # the datastores' retrievals before any insert: the spill rule
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 20)
    x_rows = torch.from_numpy(ix.x_all).to(dev)
    rows = torch.randint(0, x_rows.shape[0], (NQ,), generator=g, device=dev)
    q = x_rows[rows] + 0.5 * torch.randn(x_rows[rows].shape, generator=g, device=dev)
    d_ref, v_ref = forest_knn(q, ix.to_datastore(serve["values"]), SERVE_K)
    spill = {}
    for name in ("sharded", "routed auto"):
        d, v = forest_knn(q, srcs[name].to_datastore(serve["values"]), SERVE_K)
        differ = ~((d == d_ref).all(1) & (v == v_ref).all(1))
        require(bool((d[:, -1] < d_ref[:, -1])[differ].all()),
                f"forest_knn {name}: a query differs from the single layout's without "
                "closer rows")
        spill[name] = int(differ.sum())
    runs = {}
    for name, src in srcs.items():
        ds = src.to_datastore(serve["values"], stream_capacity=STREAM_CAPACITY)
        eng = ServeEngine(model, num_slots=8, max_len=256, datastore=ds)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=32)
                for i, p in enumerate(serve["prompts"])]
        ings = [IngestRequest(rid=100 + i, keys=serve["stream"][i * 64:(i + 1) * 64],
                              values=serve["tokens"][i * 64:(i + 1) * 64]) for i in range(16)]
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        for r, ing in zip(reqs, ings):
            eng.submit(r)
            eng.submit(ing)
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        require(all(r.done and len(r.out_tokens) == 32 for r in reqs),
                f"layout serving ({name}): a request did not complete")
        steps = max(eng.steps, 1)
        runs[name] = dict(tokens=[list(r.out_tokens) for r in reqs],
                          accepted=[i.accepted for i in ings], steps=eng.steps, wall_s=wall,
                          step_ms=float(np.median(eng._step_times)) * 1e3, launches=launches,
                          k1_per_step=launches["bucket_scan_topk"] / steps,
                          k2_per_step=launches["pairwise_sq_l2"] / steps)
    require(runs["routed auto"]["tokens"] == runs["sharded"]["tokens"],
            "layout serving: the routed run's tokens differ from the sharded fan-all run's")
    require(runs["routed auto"]["accepted"] == runs["sharded"]["accepted"]
            == runs["single"]["accepted"], "layout serving: accepted inserts differ")
    require(runs["routed auto"]["launches"]["bucket_scan_topk"] > 0
            and runs["routed auto"]["launches"]["pairwise_sq_l2"] > 0,
            "layout serving: K1/K2 did not launch")
    same = float(np.mean([a == b for a, b in zip(runs["routed auto"]["tokens"],
                                                  runs["single"]["tokens"])]))
    for r in runs.values():
        r.pop("tokens")
    out = dict(runs=runs, forest_knn_spill=spill, same_tokens_share=same)
    log(f"[layout] {SERVE_ARCH} full width on the 65,536 x {SERVE_D} forest datastore over "
        f"{LAYOUT_SHARDS} islands: forest_knn of {NQ} queries equal to the single layout's "
        f"but for {spill} queries with closer rows from an island's spill; 16 requests x 32 "
        f"tokens with 16 inserts: routed tokens equal the sharded fan-all run's, accepts "
        f"equal on every layout, {same:.0%} of requests' tokens equal the single run's; "
        f"decode step median single {runs['single']['step_ms']:.2f} ms, sharded "
        f"{runs['sharded']['step_ms']:.2f} ms, routed {runs['routed auto']['step_ms']:.2f} "
        f"ms; K1 / K2 launches a decode step (K2 inserts included): "
        + ", ".join(f"{n} {r['k1_per_step']:.2f} / {r['k2_per_step']:.2f}"
                    for n, r in runs.items()) + f" ({smi})")
    return out


def flat_sharded_phase(model, keys, values, xq, scale, islands, smi: str) -> dict:
    """The flat 2^20 x 896 datastore (f32, K6) and its int8 twin (K7 + the
    stable selection) split over four islands in ``knn_logits`` under
    ``use_mesh``: at Q = 8 the top-k (d^2 and values) and p_knn equal the
    single-shard result bit for bit, with K6 / K7 once per island a call."""
    import torch

    from repro_torch.distributed import Mesh, use_mesh
    from repro_torch.kernels import ops
    from repro_torch.serve.retrieval import Datastore, _local_topk, _sharded_topk, knn_logits

    cfg = model.cfg  # phase 11's retrieval settings: k = SERVE_K
    q = retrieval_problem(keys, 8, SEED + 19)
    mesh = Mesh(islands)
    out = {}
    for name, ds, kname in (("f32", Datastore(keys=keys, values=values), "knn_topk"),
                            ("int8", Datastore(keys=xq, values=values, scale=scale),
                             "pairwise_sq_l2_int8")):
        want_d, want_i = _local_topk(q, ds, SERVE_K)
        want_v = values[want_i.long()]
        ops.reset_launch_counts()
        got_d, got_v = _sharded_topk(q, ds, SERVE_K, mesh)
        torch.cuda.synchronize()
        n_launch = ops.launch_counts()[kname]
        require(n_launch == LAYOUT_SHARDS, f"flat {name}: {kname} launched {n_launch} times")
        require(torch.equal(got_d, want_d) and torch.equal(got_v, want_v),
                f"flat {name}: the sharded top-k differs from the single-shard one")
        with use_mesh(mesh):
            p_sh = knn_logits(q, ds, cfg)
        require(torch.equal(p_sh, knn_logits(q, ds, cfg)),
                f"flat {name}: sharded p_knn differs")
        ms_single = device_ms(lambda: _local_topk(q, ds, SERVE_K), reps=11)
        ms_sharded = device_ms(lambda: _sharded_topk(q, ds, SERVE_K, mesh), reps=11,
                               launches_hint=LAYOUT_SHARDS)
        out[name] = dict(launches=n_launch, single_ms=ms_single, sharded_ms=ms_sharded)
        log(f"[layout] flat {name} {SERVE_N} x {SERVE_D} over {LAYOUT_SHARDS} islands, Q = 8: "
            f"top-k and p_knn bitwise equal to one scan; {kname} {n_launch} launches a call; "
            f"device ms single {ms_single:.3f}, sharded {ms_sharded:.3f} ({smi})")
    return out


def layout_phase(dev, ward, tracking, model, serve, store, smi: str) -> dict:
    """Phase 17: the sharded and routed layouts on forests built above."""
    islands = layout_islands()
    log(f"[layout] islands {islands}")
    t0 = time.perf_counter()
    out = dict(islands=islands)
    out["ward"] = ward_layout_phase(ward, islands, smi)
    out["tracking"] = tracking_router_phase(tracking, islands, smi)
    out["serve"] = routed_serve_phase(dev, model, serve, islands, smi)
    out["flat"] = flat_sharded_phase(model, *store, islands, smi)
    out["seconds"] = time.perf_counter() - t0
    log(f"[layout] phase 17 {out['seconds']:.1f} s")
    return out


# --------------------------------------------------------------------------
# phase 18: the model families (MoE, MLA, Mamba, RWKV, encoder-decoder, the
# vision stub) serving with kNN-LM retrieval
# --------------------------------------------------------------------------

FAMILY_STORE_ROWS = {"deepseek-v2-236b": 1 << 18, "rwkv6-3b": 65_536, "whisper-tiny": 65_536}
HOLD_ATOL, HOLD_RTOL = 2e-3, 1e-3  # the JAX package's test_prefill_decode_matches_forward
CARD_CPU_TOL = 1e-4


def family_config(arch: str, layers: int | None = None):
    """The published configuration of ``arch``, its depth cut to ``layers``
    where given (the CPU rehearsal swaps in the smoke configuration)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    return cfg.replace(num_layers=layers) if layers else cfg


def family_inputs(cfg, b: int, s: int, seed: int, dev):
    """(tokens (B, S), keyword inputs): frames (B, encoder_seq, D) for
    whisper, stub patches (B, P, D) for pixtral, N(0, 0.1^2) each."""
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=g, device=dev)
    kw = {}
    if cfg.family == "encdec":
        kw["frames"] = 0.1 * torch.randn((b, cfg.encoder_seq, cfg.d_model), generator=g,
                                         device=dev)
    if cfg.frontend == "vision_stub":
        kw["patches"] = 0.1 * torch.randn((b, cfg.num_stub_patches, cfg.d_model), generator=g,
                                          device=dev)
    return toks, kw


def hold_decode(model, what: str, *, b: int = 1, s0: int = 8, steps: int = 8) -> dict:
    """Prefill of ``s0`` tokens, then ``steps`` teacher-forced decode steps,
    held to the forward over all ``s0 + steps`` tokens; the model computes
    in f32.  The tolerance is the JAX package's own for this check (atol
    2e-3, rtol 1e-3, set on its smoke configs), its atol widened to 4x the
    run's noise floor where that is larger: the gap between the prefill's
    logits and the forward's at the same positions, the same computation in
    another product shape, whose f32 reassociation noise grows with depth
    (rwkv6-3b's 32 recurrent layers).

    An MoE forward over T tokens drops the assignments past an expert's
    capacity C(T) (8 slots at the published factor of 1.25 up to T ~ 100),
    and the routing of a randomly initialised model is correlated across
    tokens, so a forward over more than C(T) tokens may drop where one-token
    decode steps do not (the JAX package's smoke configs raise the factor
    to 4 for its check).  Where C(T) < T, prompt and steps are halved until
    T <= C(T): an expert takes at most one choice of a token, so then
    nothing drops in either."""
    import torch

    from repro_torch.models.moe import capacity

    cfg = model.cfg
    s0 = max(s0, cfg.num_stub_patches + 8) if cfg.frontend == "vision_stub" else s0
    m = cfg.moe
    while m is not None and capacity(b * (s0 + steps), m.top_k, m.num_experts,
                                     m.capacity_factor) < b * (s0 + steps):
        s0, steps = s0 // 2, steps // 2
    toks, kw = family_inputs(cfg, b, s0 + steps, SEED + 18, model.device)
    full, aux, _ = model.forward(toks, **kw)
    logits, cache = model.prefill(toks[:, :s0], max_len=s0 + steps, **kw)
    floor = float((logits - full[:, :s0]).abs().max())
    pairs = [(model.decode_step(toks[:, p:p + 1], cache, p), full[:, p])
             for p in range(s0, s0 + steps)]
    torch.cuda.synchronize()
    atol = max(HOLD_ATOL, 4.0 * floor)
    err = max(float((g - w).abs().max()) for g, w in pairs)
    ok = all(bool(((g - w).abs() <= atol + HOLD_RTOL * w.abs()).all()) for g, w in pairs)
    require(bool(torch.isfinite(full).all()), f"{what}: non-finite logits")
    require(ok, f"{what}: decode differs from the forward by {err:.3e} (atol {atol:.3e})")
    out = dict(max_err=err, floor=floor, atol=atol, scale=float(full.abs().max()),
               tokens=b * (s0 + steps), router_aux=float(aux["router_aux"]),
               router_z=float(aux["router_z"]))
    log(f"[families] {what}: prefill {s0} + {steps} decode steps (B = {b}) held to the "
        f"forward, max |decode - forward| {err:.3e} (atol {atol:.1e}; prefill vs forward "
        f"{floor:.3e}; logits up to {out['scale']:.2f}); router aux {out['router_aux']:.4f}, "
        f"z {out['router_z']:.4f}")
    return out


def free_card() -> None:
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def card_vs_cpu(dev) -> dict:
    """Each of the ten smoke configurations with f32 compute: one seeded
    model on the CPU, its weights copied to the card, forward logits and
    router losses, prefill and two decode steps held to the CPU run at
    1e-4 of the logits' scale (two f32 libraries' reassociation noise; the
    CPU tests hold the port to the JAX package at 1e-5)."""
    import torch

    from repro_torch.configs import ARCH_IDS, get_smoke_config
    from repro_torch.models.model import Model

    out = {}
    for arch in ARCH_IDS:
        cfg = get_smoke_config(arch).replace(compute_dtype="float32")
        host = Model(cfg, device="cpu", seed=SEED)
        card = Model(cfg, device=dev, seed=None)
        card.load_state_dict(host.state_dict())
        card.cast_weights()
        toks, kw = family_inputs(cfg, 2, 8, SEED + 5, "cpu")
        res = {}
        for name, m in (("cpu", host), ("card", card)):
            mk = {k: v.to(m.device) for k, v in kw.items()}
            lg, aux, _ = m.forward(toks.to(m.device), **mk)
            _, cache = m.prefill(toks[:, :6].to(m.device), max_len=12, **mk)
            steps = [m.decode_step(toks[:, p:p + 1].to(m.device), cache, p) for p in (6, 7)]
            res[name] = [t.float().cpu() for t in [lg, *steps]] + [
                torch.stack([aux["router_aux"], aux["router_z"]]).cpu()]
        err = 0.0
        for got, want in zip(res["card"], res["cpu"]):
            tol = CARD_CPU_TOL * max(1.0, float(want.abs().max()))
            err = max(err, float((got - want).abs().max()))
            require(bool(((got - want).abs() <= tol + CARD_CPU_TOL * want.abs()).all()),
                    f"card vs CPU {arch}: {float((got - want).abs().max()):.3e}")
        out[arch] = err
        del host, card
    free_card()
    log(f"[families] card vs CPU, ten smoke configs at f32 compute (forward, router losses, "
        f"prefill + 2 decode steps): max |card - cpu| "
        f"{ {a: float(f'{e:.2e}') for a, e in out.items()} }")
    return out


def time_family_retrieval(keys, xq, scale, what: str) -> list[dict]:
    """K6 and K7 at the engine's decode batch (Q = 8) on a family's store,
    beside the plain versions (K6 also ``cdist`` + ``topk``) and the bound
    (each input read once, each output written once; 2QND + 2(Q+N)D f32
    operations, K7 N*D more for the dequantizing)."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.pairwise_l2 import pairwise_sq_l2_int8_cuda
    from repro_torch.kernels.topk import knn_topk_cuda

    n, d = keys.shape
    q = retrieval_problem(keys, 8, SEED + 8)
    flops = 2.0 * 8 * n * d + 2.0 * (8 + n) * d
    rows = []
    for name, fn, plain, lib, nbytes, ops_ in (
        ("knn_topk", lambda: knn_topk_cuda(q, keys, SERVE_K),
         lambda: ref.knn_topk_ref(q, keys, SERVE_K),
         lambda: torch.topk(torch.cdist(q, keys).square_(), SERVE_K, dim=1, largest=False),
         4 * (8 * d + n * d) + 8 * 8 * SERVE_K, flops),
        ("pairwise_sq_l2_int8", lambda: pairwise_sq_l2_int8_cuda(q, xq, scale),
         lambda: ref.pairwise_sq_l2_int8_ref(q, xq, scale), None,
         4 * 8 * d + n * d + 4 * n + 4 * 8 * n, flops + float(n) * d),
    ):
        hint = K6_SLEEP if lib else 1
        ms = device_ms(fn, reps=21, launches_hint=hint)
        plain_ms = device_ms(plain, reps=21, launches_hint=hint)
        lib_ms = device_ms(lib, reps=21, launches_hint=hint) if lib else None
        b_ms, by = bound(nbytes, ops_)
        earlier = EARLIER_K6_MS.get((n, d)) if lib else None
        rows.append(dict(name=name, shape=f"Q=8 N={n} D={d}" + (f" k={SERVE_K}" if lib else ""),
                         ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                         bound_by=by, store=what, earlier_ms=earlier))
        log(f"[time] {name} on {what} (Q=8 N={n} D={d}): kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, " + (f"cdist+topk {lib_ms:.3f} ms, " if lib else "")
            + f"bound {b_ms:.3f} ms by {by} ({b_ms / ms:.1%} of it)"
            + (f"; previous design (PERF.md) {earlier:.3f} ms" if earlier else ""))
    return rows


def family_store(dev, cfg, rows: int):
    """A flat f32 store of ``rows`` keys at the model's width drawn on the
    card from ``embedding_datastore``'s recipe, and its int8 twin."""
    from repro_torch.data.synthetic import embedding_datastore_on
    from repro_torch.serve.retrieval import build_flat_datastore

    keys, values = embedding_datastore_on(dev, rows, cfg.d_model, seed=SEED + 18)
    vals = values % cfg.vocab_size
    return {"f32": build_flat_datastore(keys, vals, device=dev),
            "int8": build_flat_datastore(keys, vals, quantized=True, device=dev)}


def family_serving(dev, arch: str, layers: int | None, runs: tuple[str, ...], smi: str) -> dict:
    """A decoder-only family through ``ServeEngine(num_slots=8,
    max_len=256)`` as phase 11 serves qwen2-0.5b: first its decode held to
    its forward at f32 compute, then the serving model in its own compute
    dtype (the same seeded weights) with retrieval off and/or on the flat
    f32 store (K6) and its int8 twin (K7 + the stable selection), k = 8,
    lambda = 0.25; a profiled window of decode steps on the f32 store."""
    import torch

    from repro_torch.configs.base import RetrievalConfig
    from repro_torch.models.model import Model, param_bytes

    base = family_config(arch, layers)
    m32 = Model(base.replace(compute_dtype="float32"), device=dev, seed=SEED)
    hold = hold_decode(m32, f"{arch} at f32 compute")
    del m32
    free_card()
    rows = FAMILY_STORE_ROWS[arch]
    cfg = base.replace(retrieval=RetrievalConfig(enabled=True, k=SERVE_K, lam=0.25,
                                                 datastore_size=rows))
    t0 = time.perf_counter()
    model = Model(cfg, device=dev, seed=SEED)
    torch.cuda.synchronize()
    pbytes = param_bytes(model)
    log(f"[families] {arch}: {cfg.num_layers} layers (published {family_config(arch).num_layers}), "
        f"d_model {cfg.d_model}, params {pbytes / 1e9:.2f} GB in {cfg.param_dtype}, card "
        f"memory after init {torch.cuda.memory_allocated() / 1e9:.2f} GB (seeded init "
        f"{time.perf_counter() - t0:.1f} s); compute {cfg.compute_dtype}")
    stores = family_store(dev, cfg, rows)
    datastores = {name: (None if name == "off" else stores[name]) for name in runs}
    serving = run_serving(dev, model, datastores)
    prof = profile_serving(model, stores["f32"], serving["f32"]["step_ms"],
                           what=f"{arch}, f32 store")
    times = time_family_retrieval(stores["f32"].keys, stores["int8"].keys,
                                  stores["int8"].scale, f"{arch}'s {rows} x {cfg.d_model} store")
    del model, stores, datastores
    free_card()
    return dict(layers=cfg.num_layers, param_bytes=pbytes, hold=hold, runs=serving,
                profile=prof, times=times)


def whisper_phase(dev, smi: str) -> dict:
    """whisper-tiny whole: ``Model.prefill(tokens, frames=(8, 1500, 384))``
    and 32 greedy ``decode_step``s on a flat 65,536 x 384 store (K6) and on
    its int8 twin (K7), three captured steps' top-k held to the plain
    version as phase 11 holds them; K6 / K7 once a step."""
    import torch

    from repro_torch.configs.base import RetrievalConfig
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.serve import retrieval

    arch = "whisper-tiny"
    base = family_config(arch)
    m32 = Model(base.replace(compute_dtype="float32"), device=dev, seed=SEED)
    hold = hold_decode(m32, f"{arch} at f32 compute", b=2)
    del m32
    rows = FAMILY_STORE_ROWS[arch]
    cfg = base.replace(retrieval=RetrievalConfig(enabled=True, k=SERVE_K, lam=0.25,
                                                 datastore_size=rows))
    model = Model(cfg, device=dev, seed=SEED)
    stores = family_store(dev, cfg, rows)
    toks, kw = family_inputs(cfg, 8, 8, SEED + 9, dev)
    out = dict(hold=hold)
    for name, ds in stores.items():
        rec = _TopkRecorder(retrieval._local_topk, keep=(2, 15, 30))
        retrieval._local_topk = rec
        try:
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            logits, cache = model.prefill(toks, max_len=64, **kw)
            nxt = torch.argmax(logits[:, -1], -1)[:, None]
            torch.cuda.synchronize()
            t_pre = time.perf_counter() - t0
            step_s = []
            for p in range(8, 40):
                t1 = time.perf_counter()
                nxt = torch.argmax(model.decode_step(nxt, cache, p, datastore=ds), -1)[:, None]
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t1)
            launches = ops.launch_counts()
        finally:
            retrieval._local_topk = rec.fn
        kname = "knn_topk" if name == "f32" else "pairwise_sq_l2_int8"
        require(launches[kname] == 32, f"{arch} {name}: {kname} launched {launches[kname]} times")
        hold_captured(ds, rec.kept, SERVE_K, f"{arch} {name}")
        step_ms = statistics.median(step_s) * 1e3
        out[name] = dict(prefill_ms=t_pre * 1e3, step_ms=step_ms, launches=launches[kname],
                         tok_per_s=8 * 32 / (t_pre + sum(step_s)))
        log(f"[families] {arch} whole, frames (8, {cfg.encoder_seq}, {cfg.d_model}), retrieval "
            f"{name} on {rows} x {cfg.d_model}: prefill {t_pre * 1e3:.1f} ms, 32 decode steps, "
            f"median step {step_ms:.2f} ms, {out[name]['tok_per_s']:.1f} tok/s; {kname} "
            f"{launches[kname]} launches; top-k of 3 captured steps held to the plain version")
    out["times"] = time_family_retrieval(stores["f32"].keys, stores["int8"].keys,
                                         stores["int8"].scale, f"{arch}'s {rows} x {cfg.d_model} store")
    del model, stores
    free_card()
    return out


def mixer_phase(dev) -> dict:
    """The other architectures' mixers at f32 compute, decode held to the
    forward: qwen3-moe-235b-a22b, granite-20b (MQA), deepseek-67b and
    pixtral-12b (256 stub patches) at full width and depth 2; jamba at its
    smoke widths (one 8-layer unit is ~77 GB in bf16); and jamba's Mamba
    mixer alone at its full widths (a 64-token forward, then 8 one-token
    steps from its state, held to the 72-token forward)."""
    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models.mamba import Mamba
    from repro_torch.models.model import Model, param_bytes

    out = {}
    for arch in ("qwen3-moe-235b-a22b", "granite-20b", "deepseek-67b", "pixtral-12b"):
        m = Model(family_config(arch, 2).replace(compute_dtype="float32"), device=dev, seed=SEED)
        out[arch] = hold_decode(m, f"{arch} full width, depth 2, {param_bytes(m) / 1e9:.2f} GB "
                                f"of {m.cfg.param_dtype} params")
        del m
        free_card()
    arch = "jamba-1.5-large-398b"
    m = Model(get_smoke_config(arch).replace(compute_dtype="float32"), device=dev, seed=SEED)
    out[arch] = hold_decode(m, f"{arch} smoke widths ({m.cfg.num_layers} layers)", b=2)
    del m
    cfg = get_config(arch).replace(compute_dtype="float32")
    mix = Mamba(cfg, dev)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    mix.init_(g)
    mix.cast(torch.float32)
    x = torch.randn((1, 72, cfg.d_model), generator=g, device=dev)
    full, _ = mix(x)
    _, state = mix(x[:, :64])
    steps = [mix.decode(x[:, p:p + 1], state) for p in range(64, 72)]
    torch.cuda.synchronize()
    got, want = torch.cat(steps, 1), full[:, 64:]
    err = float((got - want).abs().max())
    require(bool(((got - want).abs() <= HOLD_ATOL + HOLD_RTOL * want.abs()).all()),
            f"jamba Mamba mixer: decode differs from the forward by {err:.3e}")
    d_in = mix.dims[0]
    out["jamba-mamba-mixer"] = dict(max_err=err, d_inner=d_in, scale=float(want.abs().max()))
    log(f"[families] jamba's Mamba mixer alone at full widths (d_model {cfg.d_model}, d_inner "
        f"{d_in}, d_state {mix.dims[1]}): 64-token forward + 8 decode steps held to the "
        f"72-token forward, max |decode - forward| {err:.3e} (outputs up to "
        f"{out['jamba-mamba-mixer']['scale']:.2f})")
    del mix, state, x, full
    free_card()
    return out


def families_phase(dev, smi: str) -> dict:
    """Phase 18: the model families on the card."""
    t0 = time.perf_counter()
    out = dict(card_vs_cpu=card_vs_cpu(dev))
    out["deepseek-v2-236b"] = family_serving(dev, "deepseek-v2-236b", 3,
                                             ("off", "f32", "int8"), smi)
    out["rwkv6-3b"] = family_serving(dev, "rwkv6-3b", None, ("f32", "int8"), smi)
    out["whisper-tiny"] = whisper_phase(dev, smi)
    out["mixers"] = mixer_phase(dev)
    out["seconds"] = time.perf_counter() - t0
    log(f"[families] phase 18 {out['seconds']:.1f} s ({smi})")
    return out


# --------------------------------------------------------------------------
# phase 19: training (the trainable model, Model.loss, AdamW / Adafactor,
# the train step, checkpoints, the token pipeline, the Trainer)
# --------------------------------------------------------------------------

TRAIN_RTOL = 1e-5
TRAIN_GRAD_ATOL = 1e-4  # of a leaf's scale: f32 gradients of two evaluations
TRAIN_UPDATE_ATOL = 1e-5  # of a leaf's largest |value|
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 200, 8, 512
TRAIN_ARCH = "qwen2-0.5b"
TRAIN_MIN_DROP = 2.0  # nats from the first 5 losses' mean to the last 20's


class _GradRecorder:
    """Stands in for ``torch.autograd.grad`` while installed: records the
    gradients each call returns, or, given ``replay``, returns those
    instead of computing them (moved to each parameter's device)."""

    def __init__(self, replay=None):
        import torch

        self.fn = torch.autograd.grad
        self.replay = replay
        self.got = []

    def __call__(self, outputs, inputs, **kw):
        if self.replay is None:
            out = self.fn(outputs, inputs, **kw)
        else:
            out = tuple(None if g is None else g.to(p.device)
                        for g, p in zip(self.replay[len(self.got)], inputs))
        self.got.append(out)
        return out

    def __enter__(self):
        import torch

        torch.autograd.grad = self
        return self

    def __exit__(self, *exc):
        import torch

        torch.autograd.grad = self.fn


def train_batch(cfg, b: int, s: int, seed: int) -> dict:
    """``tests/test_models.py``'s batch as numpy: tokens and targets, frames
    for whisper, stub patches for the vision stub."""
    import numpy as np

    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
             "targets": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = (rng.normal(size=(b, cfg.encoder_seq, cfg.d_model)) * 0.1
                           ).astype(np.float32)
    if cfg.frontend == "vision_stub":
        batch["patches"] = (rng.normal(size=(b, cfg.num_stub_patches, cfg.d_model)) * 0.1
                            ).astype(np.float32)
    return batch


def jax_leaf_grads(model, grads) -> list:
    """Per-parameter gradients (``model.parameters()`` order) as the JAX
    tree's leaves, on the CPU."""
    import torch

    from repro_torch.models.convert import jax_tree
    from repro_torch.tree import tree_leaves

    by_param = {p: torch.zeros_like(p) if g is None else g
                for p, g in zip(model.parameters(), grads)}
    return [leaf.value(by_param).float().cpu() for leaf in tree_leaves(jax_tree(model))]


def hold_leaves(got: list, want: list, atol_of_scale: float, what: str, *,
                floor: float = 0.0) -> float:
    """Each leaf to rtol 1e-5 and ``atol_of_scale`` x its scale (its largest
    |value|, floored at ``floor`` x the largest of all leaves).  Returns the
    largest gap relative to its leaf's scale."""
    top = max(float(w.abs().max()) for w in want)
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        scale = max(float(w.abs().max()), floor * top, 1e-30)
        gap = (g.float() - w.float()).abs()
        worst = max(worst, float(gap.max()) / scale)
        require(bool((gap <= atol_of_scale * scale + TRAIN_RTOL * w.float().abs()).all()),
                f"{what}: leaf {i} {tuple(w.shape)} differs by {float(gap.max()):.3e} "
                f"(scale {scale:.3e})")
    return worst


def step_card_vs_cpu(dev) -> dict:
    """Phase 19a: the ten smoke configurations at f32 compute, one
    ``make_train_step`` step each with the optimizer the configuration
    names, on the card and on the CPU from the same seeded weights and
    batch.  Held: the loss (rtol 1e-5), every gradient leaf as the step
    computed it (rtol 1e-5, atol 1e-4 of the leaf's scale floored at 1e-4 of
    the largest gradient: f32 gradients of two evaluations differ by up to
    ~5e-5 of a leaf's scale on deepseek-v2, a zero-gradient leaf holds only
    noise), and every updated parameter and optimizer moment (rtol 1e-5,
    atol 1e-5 of the leaf's largest |value|) against the CPU's step fed the
    card's gradients: AdamW's and Adafactor's first updates are sign-like,
    so a gradient element within rounding of zero may move either way."""
    import torch

    from repro_torch.configs import ARCH_IDS, get_smoke_config
    from repro_torch.models.model import Model
    from repro_torch.optim import cosine_with_warmup, get_optimizer
    from repro_torch.tree import tree_leaves
    from repro_torch.train.train_step import init_train_state, make_train_step

    out = {}
    for arch in ARCH_IDS:
        cfg = get_smoke_config(arch).replace(compute_dtype="float32")
        batch = train_batch(cfg, 2, 8, SEED + 19)
        models = {"cpu": Model(cfg, device="cpu", seed=SEED),
                  "replay": Model(cfg, device="cpu", seed=SEED),
                  "card": Model(cfg, device=dev, seed=None)}
        models["card"].load_state_dict(models["cpu"].state_dict())
        res = {}
        for name in ("card", "cpu", "replay"):
            m = models[name]
            opt = get_optimizer(cfg.optimizer)
            step = make_train_step(m, opt, cosine_with_warmup(1e-3, 0, 10))
            replay = res["card"]["grads"] if name == "replay" else None
            with _GradRecorder(replay) as rec:
                state, met = step(init_train_state(m, opt), batch)
            res[name] = dict(loss=float(met["loss"]), grads=rec.got,
                             leaves=[t.value().float().cpu() if hasattr(t, "value")
                                     else t.float().cpu() for t in tree_leaves(
                                         {"params": state["params"], "opt": state["opt"]})])
        card, cpu, rep = res["card"], res["cpu"], res["replay"]
        loss_gap = abs(card["loss"] - cpu["loss"])
        require(loss_gap <= TRAIN_RTOL * abs(cpu["loss"]),
                f"{arch}: card loss {card['loss']} vs CPU {cpu['loss']}")
        grad_gap = hold_leaves(jax_leaf_grads(models["card"], card["grads"][0]),
                               jax_leaf_grads(models["cpu"], cpu["grads"][0]),
                               TRAIN_GRAD_ATOL, f"{arch} gradients", floor=1e-4)
        upd_gap = hold_leaves(card["leaves"], rep["leaves"], TRAIN_UPDATE_ATOL,
                              f"{arch} updated leaves")
        plain_gap = max(float((a - b).abs().max()) for a, b in zip(card["leaves"], cpu["leaves"]))
        out[arch] = dict(optimizer=cfg.optimizer, loss=card["loss"], loss_gap=loss_gap,
                         grad_gap=grad_gap, update_gap=upd_gap, update_gap_own_grads=plain_gap)
        del models
    free_card()
    log(f"[train] 19a: one train step of each smoke config at f32 compute, card vs CPU: "
        f"largest loss gap {max(v['loss_gap'] for v in out.values()):.2e}, gradient gap "
        f"{max(v['grad_gap'] for v in out.values()):.2e} of a leaf's scale, updated "
        f"params/moments gap {max(v['update_gap'] for v in out.values()):.2e} of a leaf's "
        f"scale against the CPU step on the card's gradients (against the CPU's own "
        f"gradients: up to {max(v['update_gap_own_grads'] for v in out.values()):.2e} "
        f"absolute); " + ", ".join(f"{a} {v['optimizer']} {v['grad_gap']:.1e}"
                                   for a, v in out.items()))
    return out


def qwen_grads_card_vs_cpu(dev) -> dict:
    """Phase 19b, first: qwen2-0.5b at its published widths and depth with
    f32 compute, ``Model.loss`` and its gradients on 1 x 32 tokens, the card
    against the CPU from the same seeded weights, held as in 19a."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model import Model

    cfg = get_config(TRAIN_ARCH).replace(compute_dtype="float32")
    batch = train_batch(cfg, 1, 32, SEED + 20)
    host = Model(cfg, device="cpu", seed=SEED)
    card = Model(cfg, device=dev, seed=None)
    card.load_state_dict(host.state_dict())
    got = {}
    for name, m in (("cpu", host), ("card", card)):
        t0 = time.perf_counter()
        loss, _ = m.loss(batch)
        grads = torch.autograd.grad(loss, list(m.parameters()))
        got[name] = (float(loss.detach()), jax_leaf_grads(m, grads), time.perf_counter() - t0)
        del grads
    del host, card
    free_card()
    loss_gap = abs(got["card"][0] - got["cpu"][0])
    require(loss_gap <= TRAIN_RTOL * abs(got["cpu"][0]),
            f"{TRAIN_ARCH} f32 loss: card {got['card'][0]} vs CPU {got['cpu'][0]}")
    gap = hold_leaves(got["card"][1], got["cpu"][1], TRAIN_GRAD_ATOL,
                      f"{TRAIN_ARCH} f32 gradients", floor=1e-4)
    log(f"[train] 19b: {TRAIN_ARCH} full width ({cfg.num_layers} layers, d {cfg.d_model}, "
        f"vocab {cfg.vocab_size}), f32 compute, loss + gradients on 1 x 32 tokens: card vs "
        f"CPU loss gap {loss_gap:.2e}, largest gradient gap {gap:.2e} of a leaf's scale")
    return dict(loss=got["card"][0], loss_gap=loss_gap, grad_gap=gap,
                cpu_s=got["cpu"][2], card_s=got["card"][2])


def update_phase_ms(model, state) -> float:
    """Device ms of what a train step does after its backward pass (the
    gradients as the JAX leaves, the clip, the params stacked, the optimizer
    update, the write-back), on gradients of one backward pass; it
    changes the weights."""
    import torch

    from repro_torch.models.convert import Leaf
    from repro_torch.optim import adamw, clip_by_global_norm
    from repro_torch.tree import tree_leaves, tree_map

    params = list(model.parameters())
    by_param = {p: torch.full_like(p, 1e-3) for p in params}
    leaves, opt = state["params"], adamw()
    box = {"opt": state["opt"]}

    def update():
        grads, _ = clip_by_global_norm(tree_map(lambda lf: lf.value(by_param), leaves), 1.0)
        new, box["opt"] = opt.update(grads, box["opt"], tree_map(Leaf.value, leaves),
                                     torch.tensor(1e-6, device=model.device))
        for leaf, v in zip(tree_leaves(leaves), tree_leaves(new)):
            leaf.assign_(v)

    return device_ms(update, reps=5, launches_hint=400)


def profile_training(step_fn, state, pipeline, step0: int, step_ms: float, *,
                     steps: int = 3) -> dict:
    """Device time of ``steps`` train steps by torch.profiler (after the
    run: the steps change the weights), against the run's median
    unprofiled step: the busy share, the products (cuBLAS and CUTLASS
    kernels: names with gemm, xmma, nvjet or cutlass) split into the f32
    ones (f32f32 / sgemm in the name: the head and the attention einsums,
    TF32 off) and the tensor-core rest (the layers' bf16 products), and the
    largest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    batches = [pipeline.batch_at(step0 + i) for i in range(steps)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for batch in batches:
            state, _ = step_fn(state, batch)
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    per = {e.key: e.self_device_time_total / 1e3 / steps for e in kernels}
    gemm = {k: v for k, v in per.items()
            if any(w in k.lower() for w in ("gemm", "xmma", "nvjet", "cutlass"))}
    f32 = sum(v for k, v in gemm.items() if "f32f32" in k or "sgemm" in k)
    dev_ms = sum(per.values())
    top = sorted(per.items(), key=lambda kv: -kv[1])[:8]
    out = dict(steps=steps, device_ms_per_step=dev_ms, step_ms=step_ms, busy=dev_ms / step_ms,
               gemm_f32_ms=f32, gemm_tensor_core_ms=sum(gemm.values()) - f32,
               other_ms=dev_ms - sum(gemm.values()),
               launches_per_step=sum(e.count for e in kernels) / steps,
               top=[(k[:90], v) for k, v in top])
    log(f"[profile] training, {steps} profiled steps: device time {dev_ms:.1f} ms per step "
        f"against the run's median step of {step_ms:.1f} ms (busy {out['busy']:.1%}); f32 "
        f"products {f32:.1f} ms, tensor-core products {out['gemm_tensor_core_ms']:.1f} ms, "
        f"the rest {out['other_ms']:.1f} ms; {out['launches_per_step']:.0f} launches per "
        "step; top: " + "; ".join(f"{k[:60]} {v:.1f} ms" for k, v in out["top"]))
    return out


def qwen_training(dev, smi: str) -> dict:
    """Phase 19b: qwen2-0.5b at full width, its own configuration (f32
    params, bf16 compute, AdamW, ``remat="full"``), through ``Trainer.run``
    for 200 steps of ``TokenPipeline`` batches of 8 x 512 under the
    launcher's ``cosine_with_warmup(3e-4, 100, steps)``, checkpoints at steps
    100 and 200 (``keep=2``) in a temporary directory; then a fresh
    ``Trainer`` and model resume from step 200 and must hold the saved
    params and moments bit for bit."""
    import shutil
    import tempfile

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models.model import Model, param_bytes
    from repro_torch.optim import cosine_with_warmup, get_optimizer
    from repro_torch.train import trainer as trainer_mod
    from repro_torch.train.train_step import init_train_state, make_train_step
    from repro_torch.tree import tree_leaves

    cfg = get_config(TRAIN_ARCH)
    pipeline = TokenPipeline(DataConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                                        vocab_size=cfg.vocab_size))
    ckpt_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    timed = {"save": [], "restore": []}

    def timing(kind, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            timed[kind].append(time.perf_counter() - t0)
            return out
        return run

    real_save, real_restore = trainer_mod.save_checkpoint, trainer_mod.restore_latest
    trainer_mod.save_checkpoint = timing("save", real_save)
    trainer_mod.restore_latest = timing("restore", real_restore)
    try:
        model = Model(cfg, device=dev, seed=SEED)
        opt = get_optimizer(cfg.optimizer)
        step_fn = make_train_step(model, opt, cosine_with_warmup(3e-4, 100, TRAIN_STEPS))
        step_s = []

        def timed_step(state, batch):
            t0 = time.perf_counter()
            out = step_fn(state, batch)
            float(out[1]["loss"])
            step_s.append(time.perf_counter() - t0)
            return out

        tcfg = trainer_mod.TrainerConfig(total_steps=TRAIN_STEPS, ckpt_every=100,
                                         ckpt_dir=str(ckpt_dir), log_every=50,
                                         keep_checkpoints=2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, rep = trainer_mod.Trainer(timed_step, pipeline, tcfg).run(
            init_train_state(model, opt))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        losses = rep.losses
        require(len(losses) == TRAIN_STEPS and all(l == l and abs(l) < float("inf")
                                                   for l in losses),
                f"{TRAIN_ARCH} training: {len(losses)} steps, a loss not finite")
        first, last = statistics.mean(losses[:5]), statistics.mean(losses[-20:])
        require(last <= first - TRAIN_MIN_DROP, f"{TRAIN_ARCH}: the loss fell from {first:.3f} "
            f"(first 5) to {last:.3f} (last 20), less than {TRAIN_MIN_DROP} nats")
        kept = sorted(d.name for d in ckpt_dir.iterdir() if d.is_dir())
        require(kept == ["step_00000100", "step_00000200"], f"checkpoints kept: {kept}")
        ckpt_bytes = sum(f.stat().st_size for f in (ckpt_dir / kept[-1]).iterdir())

        saved = [t.value().clone() if hasattr(t, "value") else t.clone()
                 for t in tree_leaves(state)]
        del state, model, step_fn
        free_card()
        fresh = Model(cfg, device=dev, seed=SEED + 1)
        opt = get_optimizer(cfg.optimizer)
        step_fn = make_train_step(fresh, opt, cosine_with_warmup(3e-4, 100, TRAIN_STEPS))
        t0 = time.perf_counter()
        state2, rep2 = trainer_mod.Trainer(step_fn, pipeline, tcfg).run(
            init_train_state(fresh, opt))
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        require(rep2.resumed_from == TRAIN_STEPS and not rep2.losses,
                f"resume: from {rep2.resumed_from}, {len(rep2.losses)} steps run")
        now = [t.value() if hasattr(t, "value") else t for t in tree_leaves(state2)]
        require(len(now) == len(saved) and all(
            a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(now, saved)),
            "the resumed params and moments are not the saved ones bit for bit")
        del saved, now
        steady = step_s[5:]
        step_ms = statistics.median(steady) * 1e3
        prof = profile_training(step_fn, state2, pipeline, TRAIN_STEPS, step_ms)
        upd_ms = update_phase_ms(fresh, state2)
        pbytes = param_bytes(fresh)
        del state2, fresh, step_fn
        free_card()
    finally:
        trainer_mod.save_checkpoint, trainer_mod.restore_latest = real_save, real_restore
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    tok_s = TRAIN_BATCH * TRAIN_SEQ * len(steady) / sum(steady)
    out = dict(steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ, param_bytes=pbytes,
               loss_first5=first, loss_last20=last, loss_final=losses[-1],
               step_ms=step_ms, step_ms_first=step_s[0] * 1e3, tokens_per_s=tok_s,
               update_ms=upd_ms, update_share=upd_ms / step_ms, peak_bytes=peak,
               save_s=timed["save"], restore_s=timed["restore"], resume_s=resume_s,
               ckpt_bytes=ckpt_bytes, wall_s=rep.wall_time_s,
               stragglers=len(rep.straggler_events), losses=losses, profile=prof)
    log(f"[train] 19b: {TRAIN_ARCH} full width, {pbytes / 1e9:.2f} GB of f32 params, bf16 "
        f"compute, AdamW, remat full: {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} "
        f"tokens; loss {first:.3f} (mean of the first 5) -> {last:.3f} (last 20), final "
        f"{losses[-1]:.3f}; median step {step_ms:.1f} ms (first {step_s[0] * 1e3:.0f} ms), "
        f"{tok_s:,.0f} tokens/s; the update after the backward (leaf views, clip, AdamW, "
        f"write-back) {upd_ms:.1f} ms, {upd_ms / step_ms:.1%} of a step; peak "
        f"{peak / 1e9:.2f} GB allocated; checkpoints of {ckpt_bytes / 1e9:.2f} GB saved in "
        f"{', '.join(f'{s:.1f}' for s in timed['save'])} s, restored in "
        f"{', '.join(f'{s:.1f}' for s in timed['restore'])} s (resume {resume_s:.1f} s), "
        f"bit for bit; {len(rep.straggler_events)} straggler events ({smi})")
    return out


def deepseek_grads(dev, smi: str) -> dict:
    """Phase 19c: deepseek-v2-236b at its published widths, depth 3 (the
    dense first layer and 2 MoE layers, bf16 params), ``Model.loss`` on
    2 x 256 tokens and its gradients kept in bf16 (``grad_dtype`` of the
    train step for bf16 params): the loss equal to the cross-entropy
    recomputed from ``forward``'s logits, every gradient finite, the
    routers' non-zero; the capacity drops counted from the routing of the
    forward's MoE inputs.  No optimizer step: a full-width Adafactor step's
    f32 temporaries would not fit beside the weights and the gradients."""
    import torch

    from repro_torch.models import moe
    from repro_torch.models.model import Model, param_bytes

    cfg = family_config("deepseek-v2-236b", 3)
    free_card()
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, device=dev, seed=SEED)
    batch = train_batch(cfg, 2, 256, SEED + 21)
    inputs = []
    hooks = [mod.register_forward_pre_hook(lambda m, a: inputs.append((m, a[0])))
             for mod in model.modules() if isinstance(mod, moe.MoE)]
    try:
        logits, aux, _ = model.forward(batch["tokens"])
    finally:
        for h in hooks:
            h.remove()
    drops = 0
    for mod, x in inputs:
        top_e, _, _ = moe.route(x.reshape(-1, x.shape[-1]), mod.router, mod.m.top_k)
        cap = moe.capacity(top_e.shape[0], mod.m.top_k, mod.m.num_experts,
                           mod.m.capacity_factor)
        drops += int((moe.dispatch(top_e, mod.m.num_experts, cap)[2] < 0).sum())
    tgt = torch.as_tensor(batch["targets"]).to(dev, torch.int64)
    ce = (torch.logsumexp(logits, -1) - logits.gather(-1, tgt[..., None])[..., 0]).mean()
    want = float(ce + cfg.moe.router_aux_coef * aux["router_aux"]
                 + cfg.moe.router_z_coef * aux["router_z"])
    del logits, inputs
    t0 = time.perf_counter()
    loss, met = model.loss(batch)
    params = list(model.parameters())
    grads = [g.to(torch.bfloat16) for g in torch.autograd.grad(loss, params)]
    torch.cuda.synchronize()
    t_grad = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    got = float(loss.detach())
    require(got == got and abs(got) < float("inf"), f"deepseek-v2 loss {got}")
    require(abs(got - want) <= 1e-5 * abs(want),
            f"deepseek-v2 loss {got} against the forward's cross-entropy {want}")
    require(all(bool(torch.isfinite(g).all()) for g in grads), "deepseek-v2: a gradient not finite")
    by_param = dict(zip(params, grads))
    routers = [by_param[mod.router] for mod in model.modules() if isinstance(mod, moe.MoE)]
    require(len(routers) == cfg.num_layers - cfg.moe.first_dense
            and all(bool((g != 0).any()) for g in routers),
            "deepseek-v2: a router's gradient is zero")
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))
    pbytes = param_bytes(model)
    out = dict(layers=cfg.num_layers, param_bytes=pbytes, loss=got, forward_ce_loss=want,
               grad_norm=float(gnorm), drops=drops, assignments=2 * 2 * 256 * cfg.moe.top_k,
               peak_bytes=peak, loss_grad_s=t_grad, router_aux=float(met["router_aux"].detach()))
    del model, grads, params, loss, by_param, routers
    free_card()
    log(f"[train] 19c: deepseek-v2-236b published widths, depth 3 ({pbytes / 1e9:.2f} GB of "
        f"bf16 params), 2 x 256 tokens: loss {got:.4f} (forward's CE + router terms "
        f"{want:.4f}), router aux {out['router_aux']:.4f}; bf16 gradients all finite, global "
        f"norm {out['grad_norm']:.3f}, both routers' non-zero; {drops} of "
        f"{out['assignments']} assignments dropped at capacity; loss + gradients "
        f"{t_grad:.1f} s, peak {peak / 1e9:.2f} GB allocated ({smi})")
    return out


def training_phase(dev, smi: str) -> dict:
    """Phase 19: training on the card."""
    t0 = time.perf_counter()
    out = dict(smoke=step_card_vs_cpu(dev), qwen_f32=qwen_grads_card_vs_cpu(dev),
               qwen=qwen_training(dev, smi), deepseek=deepseek_grads(dev, smi))
    out["seconds"] = time.perf_counter() - t0
    log(f"[train] phase 19 {out['seconds']:.1f} s ({smi})")
    return out


# --------------------------------------------------------------------------
# phase 20: the launch tooling and MoE's expert-parallel islands
# --------------------------------------------------------------------------

ISLAND_SHAPES = ((1, 4), (2, 2))  # (data, model) over four islands of the card
MOE_HOLD_ATOL = 1e-4  # tests/test_moe_paths.py, scaled by the output's max |value|
MOE_CF = 4.0  # capacity factor of the holds: no drops on either side
QWEN3_BATCH, QWEN3_SEQ = 1, 576  # 4,608 assignments > 4,096: the all-to-all path
# (arch, shape, mesh): the first four on both production meshes; whisper's
# encoder-decoder, jamba's Mamba scan at 32k and rwkv6's WKV recurrence
# (both time loops folded by their trip counts) on the single-pod one
DRYRUN_CELLS = tuple((a, s, mk) for a, s in (("qwen2-0.5b", "train_4k"),
                                             ("qwen2-0.5b", "decode_32k"),
                                             ("deepseek-v2-236b", "train_4k"),
                                             ("deepseek-v2-236b", "decode_32k"))
                     for mk in ("single", "multi")) + (
    ("whisper-tiny", "train_4k", "single"), ("jamba-1.5-large-398b", "prefill_32k", "single"),
    ("rwkv6-3b", "train_4k", "single"))
DRYRUN_TIMEOUT = 600
DRYRUN_PEAK_RTOL = 0.10  # the (1, 1) dry-run's peak against the card's max_memory_allocated
# 20(c): the island run's logits rms from the single bf16 run's, at most this
# multiple of the single run's own rms from the f32-compute model (the
# families' noise factor: two bf16 runs that sum in other orders differ by
# about their own noise, and the split retrieval is held bit for bit apart)
ISLAND_LOGITS_TOL = 1.5


def island_mesh(dev, shape):
    from repro_torch.distributed.context import Mesh

    return Mesh([dev] * 4, shape=shape, axis_names=("data", "model"))


def _island_bytes(mod, mesh) -> int:
    """Bytes one island holds of the MoE's routed and shared weights (its
    E / tp experts and F / tp shared columns, its D / fsdp slice)."""
    tp, fsdp = mesh.shape["model"], mesh.shape["data"]
    routed = sum(getattr(mod, n).numel() * getattr(mod, n).element_size()
                 for n in ("w_in", "w_gate", "w_out")) // (tp * fsdp)
    shared = 0 if mod.shared is None else sum(
        p.numel() * p.element_size() for p in mod.shared.parameters()) // (tp * fsdp)
    return routed + shared


def moe_paths_phase(dev, smi: str) -> dict:
    """20(a): one MoE layer at deepseek-v2-236b's published widths (d 5,120,
    160 experts top-6, 2 shared, d_ff_expert 1,536; bf16 params, f32
    compute for the hold) on four islands of the card under (1, 4) and
    (2, 2): decode T = 8 (weight-stationary), T = 2 x 1,024 (token-sharded)
    and the same with moe_a2a (all-to-all), each held to the single-device
    layer on the same weights and tokens with equal drop counts."""
    import dataclasses

    import torch

    from repro_torch.distributed.context import use_mesh
    from repro_torch.models.moe import MoE

    base = family_config("deepseek-v2-236b", 1)
    cfg = base.replace(compute_dtype="float32",
                       moe=dataclasses.replace(base.moe, capacity_factor=MOE_CF))
    mod = MoE(cfg, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    mod.init_(g)
    mod.cast(torch.float32)
    wbytes = sum(getattr(mod, n).numel() * getattr(mod, n).element_size()
                 for n in ("w_in", "w_gate", "w_out"))
    log(f"[moe] 20(a): deepseek-v2 MoE layer, {wbytes / 1e9:.2f} GB of bf16 routed experts, "
        f"f32 compute, capacity factor {MOE_CF} ({smi})")
    out = {}
    for path, b, s, a2a in (("weight-stationary", 1, 8, False), ("token-sharded", 2, 1024, False),
                            ("all-to-all", 2, 1024, True)):
        mod.a2a = a2a
        x = torch.randn((b, s, cfg.d_model), generator=g, device=dev)
        with torch.no_grad():
            ref, _ = mod(x)
            ref_drops = int(mod.dropped)
            single_ms = device_ms(lambda: mod(x))
        row = dict(tokens=b * s, single_ms=single_ms, drops=ref_drops, meshes={})
        for shape in ISLAND_SHAPES:
            mesh = island_mesh(dev, shape)
            with torch.no_grad(), use_mesh(mesh):
                got, _ = mod(x)
                drops = int(mod.dropped)
                ms = device_ms(lambda: mod(x))
            scale = float(ref.abs().max())
            gap = float((got - ref).abs().max())
            require(drops == ref_drops, f"20(a) {path} {shape}: {drops} drops, single {ref_drops}")
            require(gap <= MOE_HOLD_ATOL * scale,
                    f"20(a) {path} {shape}: max |islands - single| {gap:.3e} > "
                    f"{MOE_HOLD_ATOL} x {scale:.3e}")
            row["meshes"][str(shape)] = dict(ms=ms, gap=gap, scale=scale,
                                             island_bytes=_island_bytes(mod, mesh))
            log(f"[moe] 20(a) {path} T={b * s} mesh {shape}: {ms:.3f} ms on islands vs "
                f"{single_ms:.3f} ms single; max gap {gap:.3e} (output max {scale:.3e}, "
                f"tol {MOE_HOLD_ATOL * scale:.3e}); drops {drops} = {ref_drops}; "
                f"{_island_bytes(mod, mesh) / 1e9:.3f} GB of bf16 weights an island ({smi})")
        out[path] = row
    del mod
    free_card()
    return out


def qwen3_island_step(dev, smi: str) -> dict:
    """20(b): qwen3-moe-235b-a22b at published widths, depth 2, f32: the loss
    and gradients of one train step under (1, 4) with moe_a2a against the
    single-device step on the same weights and batch (the single step's
    gradients held on the host meanwhile), with equal drop counts: the
    seeded router sends far more than its share to some experts, so the
    capacity factor is E / k, a buffer holds every token, and neither the
    single layer nor the all-to-all cells (a quarter of the tokens each)
    drop."""
    import dataclasses

    import torch

    from repro_torch.distributed.context import use_mesh
    from repro_torch.models.model import Model, param_bytes

    base = family_config("qwen3-moe-235b-a22b", 2)
    # capacity factor E / k: a buffer holds every token, so neither side drops
    cf = base.moe.num_experts / base.moe.top_k
    cfg = base.replace(param_dtype="float32", compute_dtype="float32", moe_a2a=True,
                       moe=dataclasses.replace(base.moe, capacity_factor=cf))
    model = Model(cfg, device=dev, seed=SEED)
    params = list(model.parameters())
    toks, _ = family_inputs(cfg, QWEN3_BATCH, QWEN3_SEQ + 1, SEED + 20, dev)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    moe_gb = sum(p.numel() * p.element_size() for n, p in model.named_parameters()
                 if ".moe.w_" in n) / 1e9
    log(f"[moe] 20(b): qwen3-moe-235b-a22b depth 2, {param_bytes(model) / 1e9:.2f} GB of f32 "
        f"params ({moe_gb:.2f} GB routed experts), batch {QWEN3_BATCH} x {QWEN3_SEQ}")

    moes = [m for m in model.modules() if hasattr(m, "dropped")]

    def step():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = model.loss(batch)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        torch.cuda.synchronize()
        return loss.detach(), grads, time.perf_counter() - t0

    step()  # warm-up, untimed: cuBLAS handles and the allocator
    loss_s, grads, t_single = step()
    drops_s = sum(int(m.dropped) for m in moes)
    host = [None if gr is None else gr.cpu() for gr in grads]
    del grads
    torch.cuda.reset_peak_memory_stats()
    with use_mesh(island_mesh(dev, (1, 4))):
        loss_m, grads, t_mesh = step()
    peak = torch.cuda.max_memory_allocated()
    drops_m = sum(int(m.dropped) for m in moes)
    require(drops_m == drops_s, f"20(b): {drops_m} drops on islands, {drops_s} single")
    loss_gap = abs(float(loss_m) - float(loss_s))
    require(loss_gap <= 1e-5 * abs(float(loss_s)),
            f"20(b): island loss {float(loss_m)} vs single {float(loss_s)}")
    worst = 0.0
    for (name, _), gm, gs in zip(model.named_parameters(), grads, host):
        if gs is None:
            require(gm is None, f"20(b): {name} has a gradient on islands only")
            continue
        gs = gs.to(dev)
        scale = float(gs.abs().max())
        rel = float((gm - gs).abs().max()) / scale if scale else 0.0
        require(bool(torch.isfinite(gm).all()), f"20(b): {name} gradient not finite")
        require(rel <= TRAIN_GRAD_ATOL, f"20(b): {name} gradient off by {rel:.2e} of its scale")
        worst = max(worst, rel)
    log(f"[moe] 20(b) loss {float(loss_m):.6f} on islands vs {float(loss_s):.6f} single "
        f"(gap {loss_gap:.2e}); drops {drops_m} = {drops_s}; worst gradient gap "
        f"{worst:.2e} of a leaf's scale; "
        f"loss+grad {t_single * 1e3:.1f} ms single, {t_mesh * 1e3:.1f} ms on (1, 4) islands; "
        f"peak {peak / 1e9:.2f} GB ({smi})")
    del model, params, grads, host
    free_card()
    return dict(loss_single=float(loss_s), loss_islands=float(loss_m), loss_gap=loss_gap,
                worst_grad_gap=worst, single_ms=t_single * 1e3, islands_ms=t_mesh * 1e3,
                peak_bytes=peak)


def _serve(model, ds, prompts):
    """Phase 18's request mix (16 prompts, 32 new tokens each, 8 slots; here
    ``prompts``) with the launch counts reset just before and read just
    after."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serve.engine import Request, ServeEngine

    eng = ServeEngine(model, num_slots=8, max_len=256, datastore=ds)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=32) for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    require(len(done) == len(reqs) and all(r.done and len(r.out_tokens) == 32 for r in reqs),
            "20(c): a request did not complete")
    toks = np.concatenate([r.out_tokens for r in reqs])
    return dict(steps=eng.steps, wall_s=wall, tok_per_s=toks.size / wall,
                launches=launches["knn_topk"], tokens=toks)


def _teacher_forced(model, ds, toks, steps: int = 8):
    """Prefill of toks[:, :8], then ``steps`` decode steps fed the next
    tokens: the logits of every step, (steps, B, V) f32."""
    import torch

    logits, cache = model.prefill(toks[:, :8], max_len=64)
    out = []
    for p in range(8, 8 + steps):
        out.append(model.decode_step(toks[:, p:p + 1], cache, p, datastore=ds).float())
    return torch.stack(out)


def deepseek_island_serving(dev, smi: str) -> dict:
    """20(c): deepseek-v2-236b depth 3 serving, phase 18's model and request
    mix on its flat f32 store, under a (1, 4) mesh: the MoE runs on islands
    and the store splits over them, K6 once per island per step.  The
    store's split and merge are exact by design (ties to the lower island
    and row), so the split top-k (d^2 and values) and p_knn equal the
    single scan's bit for bit at the decode batch.  The teacher-forced
    logits under the mesh are held to the single bf16 run's directly,
    within ``ISLAND_LOGITS_TOL`` x the single run's own gap to the
    f32-compute model, and to f32 within the families' noise band."""
    import torch

    from repro_torch.configs.base import RetrievalConfig
    from repro_torch.distributed.context import use_mesh
    from repro_torch.models.model import Model
    from repro_torch.serve.retrieval import _local_topk, _sharded_topk, knn_logits

    arch = "deepseek-v2-236b"
    rows = FAMILY_STORE_ROWS[arch]
    cfg = family_config(arch, 3).replace(retrieval=RetrievalConfig(
        enabled=True, k=SERVE_K, lam=0.25, datastore_size=rows))
    mesh = island_mesh(dev, (1, 4))
    store = family_store(dev, cfg, rows)["f32"]
    q = retrieval_problem(store.keys, 8, SEED + 22)
    with torch.no_grad():
        want_d, want_i = _local_topk(q, store, SERVE_K)
        got_d, got_v = _sharded_topk(q, store, SERVE_K, mesh)
        with use_mesh(mesh):
            p_split = knn_logits(q, store, cfg)
        p_one = knn_logits(q, store, cfg)
    require(torch.equal(got_d, want_d) and torch.equal(got_v, store.values[want_i.long()]),
            "20(c): the split store's top-k differs from one scan's")
    require(torch.equal(p_split, p_one), "20(c): the split store's p_knn differs from one scan's")
    toks, _ = family_inputs(cfg, 4, 16, SEED + 21, dev)
    with torch.no_grad():
        m32 = Model(cfg.replace(compute_dtype="float32"), device=dev, seed=SEED)
        ref = _teacher_forced(m32, store, toks)
        del m32
        free_card()
        model = Model(cfg, device=dev, seed=SEED)
        single = _teacher_forced(model, store, toks)
        with use_mesh(mesh):
            islands = _teacher_forced(model, store, toks)

    def rms(a):
        return float(torch.sqrt(torch.mean(torch.square(a))))

    sound = rms(single - ref)
    direct = rms(islands - single)
    band = 1.5 * sound + 1e-2 * rms(ref)
    gap = rms(islands - ref)
    require(direct <= ISLAND_LOGITS_TOL * sound,
            f"20(c): islands' logits rms {direct:.3e} from the single run's > "
            f"{ISLAND_LOGITS_TOL} x {sound:.3e}")
    require(gap <= band, f"20(c): islands' logits rms {gap:.3e} from f32 > band {band:.3e}")
    prompts = serve_prompts(cfg.vocab_size, 16, SEED)
    _serve(model, store, prompts[:2])  # warm-up, uncounted
    one = _serve(model, store, prompts)
    with use_mesh(mesh):
        _serve(model, store, prompts[:2])
        isl = _serve(model, store, prompts)
    require(one["launches"] == one["steps"], f"20(c): single K6 {one['launches']} launches")
    require(isl["launches"] == 4 * isl["steps"],
            f"20(c): K6 launched {isl['launches']} times on the islands, want 4 x {isl['steps']}")
    agree = float((one["tokens"] == isl["tokens"]).mean())
    k6 = _time_k6_island(store.keys[: rows // 4], smi)
    log(f"[moe] 20(c) deepseek-v2 depth 3 serving on (1, 4) islands: {isl['tok_per_s']:.1f} "
        f"tok/s vs {one['tok_per_s']:.1f} single; K6 {isl['launches']} launches in "
        f"{isl['steps']} steps; split top-k and p_knn bitwise equal to one scan at Q = 8; "
        f"teacher-forced logits rms {direct:.3e} from the single bf16 run (tol "
        f"{ISLAND_LOGITS_TOL} x its {sound:.3e} from f32), {gap:.3e} from f32 (band "
        f"{band:.3e}); greedy tokens equal {agree:.1%} ({smi})")
    del model, store
    free_card()
    return dict(tok_per_s=isl["tok_per_s"], single_tok_per_s=one["tok_per_s"],
                steps=isl["steps"], launches=isl["launches"], logits_rms=gap, band=band,
                logits_rms_single=direct, single_rms_f32=sound,
                token_agreement=agree, k6=k6)


def _time_k6_island(keys, smi: str) -> dict:
    """K6 on one island's quarter of 20(c)'s store at the decode batch (Q =
    8), beside its plain version, cdist + topk and the bound (each input
    read once, each output written once; 2QND + 2(Q+N)D f32 operations)."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.topk import knn_topk_cuda

    n, d = keys.shape
    q = retrieval_problem(keys, 8, SEED + 8)
    ms = device_ms(lambda: knn_topk_cuda(q, keys, SERVE_K), reps=21, launches_hint=K6_SLEEP)
    plain_ms = device_ms(lambda: ref.knn_topk_ref(q, keys, SERVE_K), reps=21,
                         launches_hint=K6_SLEEP)
    lib_ms = device_ms(lambda: torch.topk(torch.cdist(q, keys).square_(), SERVE_K, dim=1,
                                          largest=False), reps=21, launches_hint=K6_SLEEP)
    b_ms, by = bound(4 * (8 * d + n * d) + 8 * 8 * SERVE_K, 2.0 * 8 * n * d + 2.0 * (8 + n) * d)
    earlier = EARLIER_K6_MS.get((n, d))
    log(f"[time] knn_topk on one island's store (Q=8 N={n} D={d}): kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, cdist+topk {lib_ms:.3f} ms, bound {b_ms:.3f} ms by {by} "
        f"({b_ms / ms:.1%} of it)"
        + (f"; previous design (PERF.md) {earlier:.3f} ms" if earlier else "") + f" ({smi})")
    return dict(shape=f"Q=8 N={n} D={d} k={SERVE_K}", ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=b_ms, bound_by=by, earlier_ms=earlier)


def launcher_on_card(smi: str) -> dict:
    """20(d): the train launcher with --mesh auto on the card (phase 19's
    8 x 512 batches: the train_4k cell's 256 x 4,096 would hold ~100 GB of
    the smoke model's attention blocks for its backward), and the --mesh
    prod refusal."""
    import tempfile

    free_card()  # the child needs the card this process has cached
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with tempfile.TemporaryDirectory() as ck:
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch",
                              "smollm-135m", "--smoke-model", "--mesh", "auto", "--steps", "20",
                              "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
                              "--ckpt-dir", ck], env=env, capture_output=True, text=True,
                             timeout=600)
        auto_s = time.perf_counter() - t0
    require(run.returncode == 0, f"20(d) --mesh auto exited {run.returncode}: {run.stderr[-2000:]}")
    final = [ln for ln in run.stdout.splitlines() if ln.startswith("finished: 20 steps")]
    require(bool(final), f"20(d) --mesh auto: no final loss in {run.stdout[-1000:]}")
    prod = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--smoke-model",
                           "--mesh", "prod", "--steps", "1"], env=env, capture_output=True,
                          text=True, timeout=300)
    require(prod.returncode != 0 and "needs 256 devices" in prod.stderr,
            f"20(d) --mesh prod: exit {prod.returncode}, {prod.stderr[-500:]}")
    mesh_line = next((ln for ln in run.stdout.splitlines() if ln.startswith("mesh:")), "")
    log(f"[launch] 20(d) --mesh auto: {mesh_line}; {final[0]} in {auto_s:.1f} s; --mesh prod "
        f"refused: {prod.stderr.strip().splitlines()[-1]} ({smi})")
    return dict(auto_s=auto_s, final=final[0], prod_exit=prod.returncode)


DRYRUN_CHILD = r"""
import json, sys, time
from pathlib import Path
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed.context import Mesh
from repro_torch.launch import dryrun
out_dir = Path(sys.argv[1])
cells = json.loads(sys.argv[2])
recs = []
for arch, shape, mk in cells:
    t0 = time.perf_counter()
    rec = dryrun.run_cell(arch, shape, mk)
    rec["wall_s"] = time.perf_counter() - t0
    (out_dir / f"{arch}_{shape}_{mk}.json").write_text(json.dumps(rec, indent=1))
    recs.append(rec)
one = Mesh(shape=(1, 1), axis_names=("data", "model"))
rec = dryrun.run_cell("qwen2-0.5b", "train_4k", "single", mesh=one,
                      shape=ShapeConfig("train_4k", "train", int(sys.argv[4]), int(sys.argv[3])))
print("JSON" + json.dumps({"cells": recs, "one": rec}))
"""


class DryrunChild:
    """20(e)'s dry-run in a child process, started after phase 19: it needs
    no card (meta tensors, a fake process group of 256 / 512 ranks of its
    own), so it runs beside 20(a)-(d) on a host core of its own, and this
    process keeps the other cores until the child ends (no earlier phase
    shares the host with it)."""

    def __init__(self) -> None:
        import tempfile

        self.dir = tempfile.TemporaryDirectory()
        d = Path(self.dir.name)
        self.out, self.err = open(d / "out.txt", "w+"), open(d / "err.txt", "w+")
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
        self.cores = os.sched_getaffinity(0)
        own = {max(self.cores)} if len(self.cores) > 1 else set(self.cores)
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-c", DRYRUN_CHILD, str(d), json.dumps(DRYRUN_CELLS),
             str(TRAIN_BATCH), str(TRAIN_SEQ)], env=env, stdout=self.out, stderr=self.err,
            preexec_fn=lambda: os.sched_setaffinity(0, own))
        if len(self.cores) > 1:
            os.sched_setaffinity(0, self.cores - own)
        log(f"[dryrun] 20(e) child started on host core {sorted(own)}; this process on "
            f"{len(self.cores - own) or len(self.cores)} cores until it ends")

    def result(self) -> tuple[int, str, str, float]:
        """(exit code, stdout, stderr, seconds from its start to its end)."""
        try:
            code = self.proc.wait(timeout=DRYRUN_TIMEOUT)
        finally:
            os.sched_setaffinity(0, self.cores)
        waited = time.perf_counter() - self.t0
        self.out.seek(0)
        self.err.seek(0)
        return code, self.out.read(), self.err.read(), waited

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        os.sched_setaffinity(0, self.cores)
        self.out.close()
        self.err.close()
        self.dir.cleanup()


def dryrun_phase(dev, smi: str, train_peak: int, child: DryrunChild) -> dict:
    """20(e): the dry-run of the required cells in a child process (its fake
    process group of 256 / 512 ranks is per process), each record ok, with
    a peak, and rendered by benchmarks/roofline.py's fmt_table; then
    qwen2-0.5b's train step on a (1, 1) mesh at phase 19's 8 x 512 through
    the dry-run's cell builder, run on the card twice: the dry-run's peak
    within ``DRYRUN_PEAK_RTOL`` of the first run's
    ``torch.cuda.max_memory_allocated`` (what the step allocated beyond what
    the card held before it, plus its argument bytes), and its per-device
    FLOPs equal to FlopCounterMode's over the second."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    sys.path.insert(0, str(ROOT))
    from benchmarks.roofline import fmt_table
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.context import Mesh
    from repro_torch.launch import dryrun

    code, stdout, stderr, child_s = child.result()
    require(code == 0, f"20(e) dry-run child exited {code}: {stderr[-3000:]}")
    got = json.loads(next(ln for ln in stdout.splitlines() if ln.startswith("JSON"))[4:])
    for rec in got["cells"]:
        require(rec["status"] == "ok", f"20(e) {rec['arch']} {rec['shape']} {rec['mesh']}: "
                f"{rec.get('error')}")
        require(rec["memory"]["peak_bytes"] > 0, f"20(e) {rec['arch']} {rec['shape']}: no peak")
        r = rec["roofline"]
        log(f"[dryrun] {rec['arch']} {rec['shape']} {rec['mesh']}: {rec['wall_s']:.1f} s; "
            f"per device {rec['hlo_cost']['flops']:.3e} FLOPs, collectives "
            f"{rec['hlo_cost']['collective_bytes']:.3e} B, peak "
            f"{rec['memory']['peak_bytes']:.4e} B "
            f"(arguments {rec['memory']['argument_bytes']:.4e}), memory model "
            f"{rec['memory_model']['total']:.3e} B; roofline compute {r['compute_s']:.3e} s, "
            f"memory {r['memory_s']:.3e} s, collective {r['collective_s']:.3e} s "
            f"({r['dominant']}); trip counts {rec['hlo_cost']['trip_counts']}; "
            f"replicated ops {rec['replicated_ops']}")
    for mk in ("single", "multi"):
        table = fmt_table([r for r in got["cells"] if r["mesh"] == mk])
        n_mk = sum(c[2] == mk for c in DRYRUN_CELLS)
        require(table.count("| ok |") == n_mk, f"20(e) fmt_table {mk}: {table}")
        for line in table.splitlines():
            log(f"[dryrun] {mk} {line}")
    one = got["one"]
    cfg = dryrun.cell_config("qwen2-0.5b", "train_4k")
    shape = ShapeConfig("train_4k", "train", TRAIN_SEQ, TRAIN_BATCH)
    fn, args, _ = dryrun.build_cell(cfg, shape, Mesh(shape=(1, 1), axis_names=("data", "model")),
                                    device=dev)
    # the peak of the step as it runs, then its FLOPs (under
    # FlopCounterMode the step holds more at its peak: ~8 GB here)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = fn(*args)
    torch.cuda.synchronize()
    card_max = torch.cuda.max_memory_allocated()
    card_peak = card_max - before + one["memory"]["argument_bytes"]
    del out
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    torch.cuda.synchronize()
    card_flops = fc.get_total_flops()
    require(one["hlo_cost"]["flops"] == card_flops,
            f"20(e) (1, 1): dry-run {one['hlo_cost']['flops']} FLOPs, card {card_flops}")
    dry_peak = one["memory"]["peak_bytes"]
    log(f"[dryrun] 20(e) qwen2-0.5b train {TRAIN_BATCH} x {TRAIN_SEQ} on (1, 1): "
        f"{card_flops:.6e} FLOPs a step, dry-run = card's FlopCounterMode; peak: dry-run "
        f"{dry_peak / 1e9:.4f} GB, card {card_peak / 1e9:.4f} GB (max_memory_allocated "
        f"{card_max / 1e9:.4f} GB - {before / 1e9:.4f} GB held before "
        f"+ {one['memory']['argument_bytes'] / 1e9:.4f} GB of arguments), ratio "
        f"{dry_peak / card_peak:.4f}; memory model {one['memory_model']['total'] / 1e9:.2f} GB "
        f"of traffic; the child took {child_s:.1f} s ({smi})")
    require(abs(dry_peak - card_peak) <= DRYRUN_PEAK_RTOL * card_peak,
            f"20(e) (1, 1): dry-run peak {dry_peak} B, card {card_peak} B")
    del fn, args
    free_card()
    return dict(cells=got["cells"], one_flops=card_flops, child_s=child_s,
                memory_model_total=one["memory_model"]["total"],
                argument_bytes=one["memory"]["argument_bytes"], train_peak=train_peak,
                dry_peak=dry_peak, card_peak=card_peak)


def launch_phase(dev, smi: str, train_peak: int, child: DryrunChild) -> dict:
    """Phase 20: the launch tooling and MoE's expert-parallel islands on the
    card.  The K6 launches of 20(c)'s island serving are counted from zero
    just before it and read just after."""
    t0 = time.perf_counter()
    out = dict(moe=moe_paths_phase(dev, smi), qwen3=qwen3_island_step(dev, smi),
               serving=deepseek_island_serving(dev, smi), launcher=launcher_on_card(smi),
               dryrun=dryrun_phase(dev, smi, train_peak, child))
    out["seconds"] = time.perf_counter() - t0
    log(f"[launch] phase 20 {out['seconds']:.1f} s ({smi})")
    return out


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
    return run(args)


def run(args) -> int:
    import torch

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
    control_ms = library_control(store[0])
    eps_rows = time_eps(sl["built"], ov, smi, control_ms)
    prof_rows = profile_searches(sl["built"], sl["results"])
    model, sv = serve_phase(dev, gen, *store)
    stream = bench_stream_phase(dev, smi)
    ward_stream, ward_card = ward_stream_phase(
        dev, ov["builds"][("WARD", "vbm")]["idx"][False], smi)
    blob_obm = blob_obm_phase(dev, smi)
    forest_serve, serve_state = forest_serve_phase(dev, model, smi)
    persist_explain = persist_explain_phase(
        dev, ward_card, ov["builds"][("Tracking", "vbm")]["idx"][False],
        ov["builds"][("Blob", "vbm")]["idx"][False], smi)
    layout = layout_phase(dev, ward_card, ov["builds"][("Tracking", "vbm")]["idx"][False],
                          model, serve_state, store, smi)
    del store, serve_state, model
    torch.cuda.empty_cache()
    families = families_phase(dev, smi)
    training = training_phase(dev, smi)
    child = DryrunChild()
    try:
        launch = launch_phase(dev, smi, training["qwen"]["peak_bytes"], child)
    finally:
        child.close()

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
                      persist_explain=persist_explain, layout=layout, families=families,
                      training=training, launch=launch, nvcc_s=t_build, seconds=time.perf_counter() - t_start)
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
