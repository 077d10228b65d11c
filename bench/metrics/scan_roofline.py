"""The bucket scan's share of its roofline: the least time for the work the
traced calls report, over the device time of the kernels that ``bench/layers``
marks as ``scan``.

Work: 4 D f32 operations a reported distance; bytes: each call reads the
forest's member rows and ids once and the queries once, and writes its
answers once (``bench/roofline.py``).  In a stream that writes, a call also
reads the live rows and ids of the delta buckets once each, as it reads the
main buckets' slots, and the forest's slots change with each rebuild: the
harness counts both before each traced search (``trace_slots``).  The least
time is the larger of the two bounds over the traced calls, at the H100
SXM's data-sheet rates."""
from bench import roofline


def read(ctx):
    tr = ctx.trace
    if tr is None or not ctx.trace_queries:
        return None
    scan_s = sum(sec for name, sec in tr.kernels if ctx.role(name) == "scan")
    if scan_s <= 0:
        return None
    dim = ctx.forest["dim"]
    per_call_q = ctx.trace_queries / tr.calls
    ops_ms, _ = roofline.bound(0.0, roofline.scan_work(ctx.trace_distances, dim))
    if ctx.trace_slots:
        nbytes = roofline.scan_bytes(slots=ctx.trace_slots, dim=dim, queries=ctx.trace_queries,
                                     k=int(ctx.mix["k"]))
    else:
        nbytes = roofline.scan_bytes(slots=ctx.forest["slots"], dim=dim, queries=per_call_q,
                                     k=int(ctx.mix["k"])) * tr.calls
    bytes_ms, _ = roofline.bound(nbytes, 0.0)
    return max(ops_ms, bytes_ms) / (scan_s * 1e3) * 100.0
