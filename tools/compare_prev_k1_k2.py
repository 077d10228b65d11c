#!/usr/bin/env python3
"""K1 and K2 of the port against their per-step predecessors, on one card.

    mkdir -p _checkout/prev
    git show 052032e:src/repro_torch/csrc/bucket_scan.cu > _checkout/prev/bucket_scan.cu
    git show 052032e:src/repro_torch/csrc/pairwise_l2.cu > _checkout/prev/pairwise_l2.cu
    python3 tools/compare_prev_k1_k2.py --prev _checkout/prev [--json PATH]

Commit 052032e's K1 is one scan step (``bucket_scan_topk_f32`` /
``_i8``), driven here by the lockstep loop that ``core/knn._scan_phase``
ran then: one launch a step and a host sync to decide whether any query is
still active.  Its K2 stages D in chunks of 16 for every width.  Both are
built from the given directory with the port's own nvcc flags and loaded
beside the current kernels.

For the WARD-like 1,000,000 x 5 and Tracking-like 62,702 x 20 baselines of
``chip_smoke.py`` (f32 and int8 buckets, beam 1 and 4), the main phase's
operands go through both: top_d, top_i, visits, ndist, npad and the trip
count must be bit-identical.  K2's outputs at the bounds and routing shapes
must be bit-identical.  Times alternate earlier, now, now, earlier: K2 and
the new K1 by CUDA events, the earlier K1 loop by the host clock around a
synchronised run (its loop syncs every step).  Exits non-zero on any
difference.  Imports nothing of JAX or of ``repro``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

_P, _I = ctypes.c_void_p, ctypes.c_int


def build_prev(prev: Path) -> dict[str, ctypes.CDLL]:
    """Build the earlier sources with the port's flags; argtypes as commit
    052032e's wrappers set them."""
    from repro_torch.kernels import _build

    out = prev / "_build"
    out.mkdir(parents=True, exist_ok=True)
    procs = {n: subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                                  str(out / f"lib{n}.so"), str(prev / f"{n}.cu")])
             for n in ("bucket_scan", "pairwise_l2")}
    for n, p in procs.items():
        if p.wait() != 0:
            raise RuntimeError(f"nvcc failed for the earlier {n}.cu")
    libs = {n: ctypes.CDLL(str(out / f"lib{n}.so")) for n in procs}
    fns = [(libs["bucket_scan"].bucket_scan_topk_f32, [_P] * 9 + [_I] * 6 + [_P]),
           (libs["bucket_scan"].bucket_scan_topk_i8, [_P] * 10 + [_I] * 6 + [_P]),
           (libs["pairwise_l2"].pairwise_sq_l2_f32, [_P, _P, _P, _I, _I, _I, _P])]
    for fn, argtypes in fns:
        fn.argtypes, fn.restype = argtypes, _I
    return libs


def prev_k2(lib, q, x):
    import torch

    out = torch.empty((q.shape[0], x.shape[0]), device=q.device)
    err = lib.pairwise_sq_l2_f32(q.data_ptr(), x.data_ptr(), out.data_ptr(), q.shape[0],
                                 x.shape[0], q.shape[1], torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return out


def prev_phase(lib, args):
    """The earlier per-step K1 in the earlier lockstep loop."""
    import torch

    q, bx, ids, count, order, lb, beam, top_d, top_i, scale = args
    qn, kk = top_d.shape
    nb, cap, dim = bx.shape
    zeros = torch.zeros((qn,), dtype=torch.int32, device=q.device)
    visits, ndist, npad, t = zeros, zeros, zeros, 0
    stream = torch.cuda.current_stream().cuda_stream
    while t < order.shape[1] // beam:
        lo = t * beam
        kth = torch.sqrt(top_d[:, -1])
        act = lb[:, lo:lo + beam] <= kth[:, None]
        if not bool(act.any()):
            break
        bsel = order[:, lo:lo + beam].contiguous()
        actc = act.contiguous()
        out_d, out_i = torch.empty_like(top_d), torch.empty_like(top_i)
        common = (ids.data_ptr(), bsel.data_ptr(), actc.data_ptr(), top_d.data_ptr(),
                  top_i.data_ptr(), out_d.data_ptr(), out_i.data_ptr(), qn, nb, cap, dim,
                  beam, kk, stream)
        if scale is None:
            err = lib.bucket_scan_topk_f32(q.data_ptr(), bx.data_ptr(), *common)
        else:
            err = lib.bucket_scan_topk_i8(q.data_ptr(), bx.data_ptr(), scale.data_ptr(), *common)
        assert err == 0, err
        n_act = torch.sum(act, dim=1, dtype=torch.int32)
        visits = visits + n_act
        ndist = ndist + torch.sum(torch.where(act, count[bsel.long()], 0), dim=1,
                                  dtype=torch.int32)
        npad = npad + n_act * cap
        top_d, top_i, t = out_d, out_i, t + 1
    return top_d, top_i, visits, ndist, npad, t


def host_ms(fn, reps: int = 5) -> float:
    import statistics

    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--prev", required=True, type=Path,
                    help="directory holding the earlier bucket_scan.cu and pairwise_l2.cu")
    ap.add_argument("--json", help="also write the results to this JSON file")
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as cs
    from repro_torch.api import Config, IndexConfig, OverlapIndex, SearchConfig
    from repro_torch.kernels.bucket_scan import bucket_scan_phase_cuda
    from repro_torch.kernels.pairwise_l2 import pairwise_sq_l2_cuda
    from repro_torch.kernels.ref import no_tf32

    if not torch.cuda.is_available():
        print("compare_prev_k1_k2: needs a CUDA device", file=sys.stderr)
        return 2
    no_tf32()
    smi = cs.nvidia_smi()
    print(f"[card] {smi}", flush=True)
    libs = build_prev(args.prev)
    data = cs.make_data()
    rows = []
    ok = True
    for i, (name, _, _, c_max) in enumerate(cs.DATASETS):
        x = data[name]
        q = cs.make_queries(x, cs.SEED + i)  # the smoke's queries
        for quantize in (False, True):
            cfg = Config(index=IndexConfig(pivot_method="kmeans", c_max=c_max),
                         search=SearchConfig(quantize=quantize))
            ix = OverlapIndex.baseline(x, cfg, device="cuda")
            for beam in (1, 4):
                ops = cs.phase_operands(ix, q, beam)
                new = bucket_scan_phase_cuda(*ops)
                old = prev_phase(libs["bucket_scan"], ops)
                same = all(torch.equal(a, b) for a, b in zip(new[:5], old[:5]))
                same &= int(new[5].max()) == old[5]
                ok &= same
                t = [host_ms(lambda: prev_phase(libs["bucket_scan"], ops)),
                     cs.device_ms(lambda: bucket_scan_phase_cuda(*ops), reps=21),
                     cs.device_ms(lambda: bucket_scan_phase_cuda(*ops), reps=21),
                     host_ms(lambda: prev_phase(libs["bucket_scan"], ops))]
                kind = "int8" if quantize else "f32"
                rows.append(dict(kernel="K1", case=f"{name} {kind} beam={beam}",
                                 identical=same, steps=old[5], earlier_ms=[t[0], t[3]],
                                 now_ms=[t[1], t[2]]))
                print(f"[K1] {name} {kind} beam={beam}: identical={same}, steps {old[5]}; "
                      f"earlier loop (host, synchronised) {t[0]:.3f} / {t[3]:.3f} ms, "
                      f"phase kernel {t[1]:.4f} / {t[2]:.4f} ms", flush=True)
            if quantize:
                continue
            df = ix.device
            qt = torch.from_numpy(q).cuda()
            for what, xx in (("bounds", df.bucket_pivot), ("routing", df.index_centers)):
                new = pairwise_sq_l2_cuda(qt, xx)
                old = prev_k2(libs["pairwise_l2"], qt, xx)
                same = torch.equal(new, old)
                ok &= same
                t = [cs.device_ms(lambda: prev_k2(libs["pairwise_l2"], qt, xx), reps=21),
                     cs.device_ms(lambda: pairwise_sq_l2_cuda(qt, xx), reps=21),
                     cs.device_ms(lambda: pairwise_sq_l2_cuda(qt, xx), reps=21),
                     cs.device_ms(lambda: prev_k2(libs["pairwise_l2"], qt, xx), reps=21)]
                shape = f"{qt.shape[0]} x {xx.shape[0]} x {qt.shape[1]}"
                rows.append(dict(kernel="K2", case=f"{name} {what} {shape}", identical=same,
                                 earlier_ms=[t[0], t[3]], now_ms=[t[1], t[2]]))
                print(f"[K2] {name} {what} ({shape}): identical={same}; earlier "
                      f"{t[0] * 1e3:.2f} / {t[3] * 1e3:.2f} us, now {t[1] * 1e3:.2f} / "
                      f"{t[2] * 1e3:.2f} us", flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(dict(card=smi, rows=rows), indent=1))
    print(json.dumps({"identical": ok, "card": smi}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
