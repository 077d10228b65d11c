#!/usr/bin/env python3
"""K6 (knn_topk) against its three-pass predecessor, on one card.

    mkdir -p _checkout/prev_k6
    git show 38197a8:src/repro_torch/csrc/knn_topk.cu > _checkout/prev_k6/knn_topk.cu
    git show 38197a8:src/repro_torch/csrc/row_tile.cuh > _checkout/prev_k6/row_tile.cuh
    python3 tools/compare_prev_k6.py --prev _checkout/prev_k6 [--json PATH] [--quick]

Commit 38197a8's K6 is three launches a call (the query norms, a partial
top-k per chunk of rows, the merge), chunked by that commit's
``chunking``, copied below.  It is built from the given directory with the
port's own nvcc flags and loaded beside the current kernel.

Values and indices must be bit-identical on seeded random f32 rows (not
grid rows): at the decode and probe shapes of the serving paths (Q = 8 on
2^20 x 896, 2^18 x 5,120, 65,536 x 5,120, 65,536 x 2,560 and 65,536 x 384;
Q = 1,024 on 2^20 x 896), at Q in {1, 7, 9, 31, 32, 33, 64, 1030} (both
block shapes and their boundary) x k in {1, 8, 64} x D in {5, 20, 383,
896} on a ragged N, at N < k, and on an ``x`` offset by one float (the
4-byte copy path).  The serving shapes are timed earlier, now, now, earlier
by CUDA events, each behind ~0.5 ms of queued sleep so that the wrappers'
host side stays outside the interval.  Exits non-zero on any difference.
Imports nothing of JAX or of ``repro``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

_P, _I = ctypes.c_void_p, ctypes.c_int

# (Q, N, D) at k = 8: the serving paths' K6 shapes, timed
SERVING = [(8, 1 << 20, 896), (8, 1 << 18, 5120), (8, 65_536, 5120), (8, 65_536, 2560),
           (8, 65_536, 384), (1024, 1 << 20, 896)]
QS = (1, 7, 9, 31, 32, 33, 64, 1030)
KS = (1, 8, 64)
DS = (5, 20, 383, 896)
RAGGED_N = 70_001


def prev_chunking(nq: int, nx: int, sms: int) -> tuple[int, int]:
    """Commit 38197a8's ``kernels/topk.py::chunking``."""
    q_tiles = -(-nq // 8)
    tiles = -(-nx // 256)
    want = max(1, min(tiles, -(-2 * 5 * sms // q_tiles)))
    chunk_rows = -(-tiles // want) * 256
    return chunk_rows, -(-nx // chunk_rows)


def build_prev(prev: Path) -> tuple[ctypes.CDLL, str]:
    """The earlier knn_topk.cu with the port's flags; argtypes as commit
    38197a8's wrapper set them.  Returns the library and ptxas's report."""
    from repro_torch.kernels import _build

    out = prev / "_build"
    out.mkdir(parents=True, exist_ok=True)
    lib_path = out / "libknn_topk.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(prev), "-o",
                           str(lib_path), str(prev / "knn_topk.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the earlier knn_topk.cu:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    lib.knn_topk_f32.argtypes = [_P] * 7 + [_I] * 7 + [_P]
    lib.knn_topk_f32.restype = _I
    return lib, proc.stdout + proc.stderr


def prev_k6(lib, q, x, k: int):
    """The earlier three-pass K6 (its wrapper's allocation and chunking)."""
    import torch

    nq, dim = q.shape
    nx = x.shape[0]
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    chunk_rows, n_chunks = prev_chunking(nq, nx, sms)
    out_val = torch.empty((nq, k), dtype=torch.float32, device=q.device)
    out_idx = torch.empty((nq, k), dtype=torch.int32, device=q.device)
    qnorm = torch.empty((nq,), dtype=torch.float32, device=q.device)
    part_val = torch.empty((nq, n_chunks, k), dtype=torch.float32, device=q.device)
    part_idx = torch.empty((nq, n_chunks, k), dtype=torch.int32, device=q.device)
    vec = int(dim % 4 == 0 and x.data_ptr() % 16 == 0)
    err = lib.knn_topk_f32(q.data_ptr(), x.data_ptr(), qnorm.data_ptr(), part_val.data_ptr(),
                           part_idx.data_ptr(), out_val.data_ptr(), out_idx.data_ptr(), nq, nx,
                           dim, k, chunk_rows, n_chunks, vec,
                           torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"earlier knn_topk launch failed ({err})")
    return out_val, out_idx


def cases(quick: bool):
    """(what, Q, N, D, k, offset) of every bit-identity case."""
    out = [("serving", nq, n, d, 8, 0) for nq, n, d in SERVING]
    for d in DS[:2] if quick else DS:
        for nq in QS:
            for k in KS:
                out.append(("grid", nq, RAGGED_N, d, k, 0))
    for nq in (1, 8, 33, 64):
        for k in (8, 64):
            out.append(("N < k", nq, 5, 20, k, 0))
    for nq in (8, 33, 1030):
        out.append(("x offset by one float", nq, 65_539, 896, 8, 1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--prev", required=True, type=Path,
                    help="directory holding the earlier knn_topk.cu and row_tile.cuh")
    ap.add_argument("--json", help="also write the results to this JSON file")
    ap.add_argument("--quick", action="store_true", help="D in {5, 20} only for the grid")
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.topk import knn_topk_cuda, plan

    if not torch.cuda.is_available():
        print("compare_prev_k6: needs a CUDA device", file=sys.stderr)
        return 2
    smi = cs.nvidia_smi()
    print(f"[card] {smi}", flush=True)
    lib, prev_log = build_prev(args.prev)
    _build.build_all()
    print("[build] earlier knn_topk.cu:\n" + prev_log.strip(), flush=True)
    print("[build] knn_topk.cu now:\n" + _build.BUILD_LOG.get("knn_topk", "(cached)").strip(),
          flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device="cuda")
    g.manual_seed(cs.SEED)
    rows, ok = [], True
    for what, nq, n, d, k, off in cases(args.quick):
        buf = torch.randn((n * d + off,), generator=g, device="cuda")
        x = buf[off:].view(n, d)
        q = x[torch.randint(0, n, (nq,), generator=g, device="cuda")]
        q = q + 0.5 * torch.randn(q.shape, generator=g, device="cuda")
        nv, ni = knn_topk_cuda(q, x, k)
        ov, oi = prev_k6(lib, q, x, k)
        torch.cuda.synchronize()
        same = torch.equal(nv.view(torch.int32), ov.view(torch.int32)) and torch.equal(ni, oi)
        ok &= same
        p = plan(nq, n, k, sms)
        row = dict(case=what, q=nq, n=n, d=d, k=k, offset=off, identical=same,
                   regime=p.regime, ranges=p.ranges, q_tiles=p.q_tiles)
        text = ""
        if what == "serving":
            reps = 21 if nq == 8 else 3
            t = [cs.device_ms(lambda: prev_k6(lib, q, x, k), reps=reps, launches_hint=5),
                 cs.device_ms(lambda: knn_topk_cuda(q, x, k), reps=reps, launches_hint=5),
                 cs.device_ms(lambda: knn_topk_cuda(q, x, k), reps=reps, launches_hint=5),
                 cs.device_ms(lambda: prev_k6(lib, q, x, k), reps=reps, launches_hint=5)]
            b_ms, by = cs.bound(4 * (nq * d + n * d) + 8 * nq * k,
                                2.0 * nq * n * d + 2.0 * (nq + n) * d)
            row.update(earlier_ms=[t[0], t[3]], now_ms=[t[1], t[2]], bound_ms=b_ms, bound_by=by)
            text = (f"; earlier {t[0]:.4f} / {t[3]:.4f} ms, now {t[1]:.4f} / {t[2]:.4f} ms, "
                    f"bound {b_ms:.4f} ms by {by} ({b_ms / min(t[1], t[2]):.1%} of it)")
        rows.append(row)
        print(f"[K6] {what} Q={nq} N={n} D={d} k={k} offset={off} ({p.regime}, "
              f"{p.q_tiles} x {p.ranges} blocks): identical={same}{text}", flush=True)
        del buf, x, q
        torch.cuda.empty_cache()
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(dict(card=smi, rows=rows), indent=1))
    print(smi)
    print(json.dumps({"identical": ok, "cases": len(rows), "card": smi}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
