"""The port's search tracing on the profiler's clock and on its own device
phases (``repro_torch.obs.metrics``, ``repro_torch.obs.phases``), and the
benchmark's reader of the program's share of the device's idle time
(``bench/metrics/facade_idle_ms.py``).

Runs on the CPU, where a phase boundary is a host clock reading; the
``cuda`` case times the phases with CUDA events on the card and skips
elsewhere.
"""
from __future__ import annotations

import importlib.util
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bench.devtrace import DeviceTrace
from repro_torch.api import (
    Config,
    IndexConfig,
    LayoutConfig,
    ObsConfig,
    OverlapIndex,
    StreamConfig,
)
from repro_torch.core.knn import knn_search_impl
from repro_torch.obs import Registry, TraceContext, new_trace, use_trace
from repro_torch.obs.phases import PHASES, phase

ROOT = Path(__file__).resolve().parents[1]
BUILD = dict(method="vbm", eps=1.5, min_pts=8, xi_min=0.3, xi_max=0.7)
NEW_SPANS = ("search/device", "search/host_only", "search/host_transfer/wait",
             "search/host_transfer/copy") + tuple(f"search/device/{p}" for p in PHASES)


class Events:
    """An event log that keeps its records in memory."""

    def __init__(self) -> None:
        self.records: list[dict] = []

    def emit(self, rec: dict) -> None:
        self.records.append(rec)


def _build(x, *, layout: str = "single", device="cpu", **obs) -> OverlapIndex:
    cfg = Config(index=IndexConfig(**BUILD), stream=StreamConfig(capacity=64),
                 layout=LayoutConfig(kind=layout, shards=4 if layout != "single" else None),
                 obs=ObsConfig(**obs))
    return OverlapIndex.build(x, cfg, device=device if layout == "single" else [device] * 4)


def _queries(x, n=48, seed=3):
    g = np.random.default_rng(seed)
    return (x[g.choice(len(x), n)] + 0.1 * g.normal(size=(n, x.shape[1]))).astype(np.float32)


def _spans(ix) -> dict:
    return ix.metrics()["search"]["spans"]


def _range_events(prof) -> list:
    return [e for e in prof.profiler.kineto_results.events() if e.is_user_annotation()]


# -- registry spans as profiler ranges ----------------------------------------

def _nested(reg: Registry) -> None:
    for _ in range(3):
        with reg.span("search"):
            with reg.span("plan_lookup"):
                pass
            with reg.span("device_execute"):
                torch.ones(8).sum()


def test_span_is_a_profiler_range_only_while_a_profiler_records(monkeypatch):
    opened: list[str] = []
    real = torch.autograd.profiler.record_function

    def counting(name, *a, **kw):
        opened.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)
    plain = Registry()
    _nested(plain)
    assert opened == []
    profiled = Registry()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _nested(profiled)
    paths = ["search", "search/plan_lookup", "search/device_execute"]
    assert opened == paths * 3
    names = [e.name() for e in _range_events(prof)]
    assert sorted(names) == sorted(paths * 3)
    hp, hq = plain.snapshot()["histograms"], profiled.snapshot()["histograms"]
    assert set(hp) == set(hq) == set(paths)
    assert all(hp[p]["count"] == hq[p]["count"] == 3 for p in paths)


def test_a_span_record_starts_inside_its_profiler_range():
    log = Events()
    reg = Registry(events=log)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _nested(reg)
    ranges: dict[str, list[tuple[int, int]]] = {}
    for e in _range_events(prof):
        ranges.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    assert len(log.records) == 9
    for rec in log.records:
        s = rec["start_ns"]
        assert any(lo <= s <= hi for lo, hi in ranges[rec["span"]]), rec


def test_externally_timed_span_records_start_their_duration_ago():
    log = Events()
    reg = Registry(events=log)
    before = time.time_ns()
    reg.record_span("queue_wait", 0.25)
    reg.emit_trace_root(new_trace(), "request", 0.5)
    after = time.time_ns()
    for rec, dur_ns in zip(log.records, (250_000_000, 500_000_000)):
        assert before - dur_ns <= rec["start_ns"] <= after - dur_ns


# -- the device phases --------------------------------------------------------

def test_a_phase_is_one_shared_inert_object_when_nobody_looks():
    assert phase("scan") is phase("route")
    with use_trace(new_trace()):  # sampled, but no clock attached: still inert
        assert phase("scan") is phase("sort")
    with phase("scan") as p:
        assert p is None


def _search_sampled(ix, q, how: str):
    if how == "explicit":
        return ix.search(q, k=5, trace=new_trace())
    if how == "ambient":
        with use_trace(new_trace()):
            return ix.search(q, k=5)
    return ix.search(q, k=5)  # trace_sample 1.0


@pytest.mark.parametrize("how", ["explicit", "ambient", "trace_sample"])
@pytest.mark.parametrize("layout", ["single", "sharded", "routed"])
def test_a_sampled_search_times_every_phase(blob_data, how, layout):
    ix = _build(blob_data, layout=layout, trace_sample=1.0 if how == "trace_sample" else 0.0)
    q = _queries(blob_data)
    for _ in range(3):
        _search_sampled(ix, q, how)
    sp = _spans(ix)
    assert all(sp[name]["count"] == 3 for name in NEW_SPANS), sorted(sp)
    parts = sum(sp[f"search/device/{p}"]["sum"] for p in PHASES)
    assert parts == pytest.approx(sp["search/device"]["sum"], rel=1e-9)
    assert sp["search/device/scan"]["min"] > 0
    assert sp["search/host_only"]["min"] >= 0
    assert sp["search/device"]["sum"] + sp["search/host_only"]["sum"] <= sp["search"]["sum"]
    assert sp["search/host_transfer/wait"]["sum"] + sp["search/host_transfer/copy"]["sum"] \
        <= sp["search/host_transfer"]["sum"]


def test_the_delta_phase_is_timed_as_scan(blob_data):
    ix = _build(blob_data, trace_sample=1.0)
    q = _queries(blob_data)
    ix.search(q, k=5)
    ix.ingest(_queries(blob_data, n=40, seed=9))
    ix.search(q, k=5)
    sp = _spans(ix)
    assert sp["search/device/scan"]["count"] == 2
    assert sum(sp[f"search/device/{p}"]["sum"] for p in PHASES) == \
        pytest.approx(sp["search/device"]["sum"], rel=1e-9)


@pytest.mark.parametrize("trace", [None, TraceContext(sampled=False)], ids=["none", "unsampled"])
def test_an_unsampled_search_records_no_phase(blob_data, trace):
    ix = _build(blob_data)
    q = _queries(blob_data)
    for _ in range(3):
        ix.search(q, k=5, trace=trace)
    sp = _spans(ix)
    assert set(sp) == {"search", "search/plan_lookup", "search/device_execute",
                       "search/host_transfer"}
    assert sp["search"]["count"] == 3


@pytest.mark.parametrize("layout", ["single", "routed"])
def test_sampled_unsampled_and_metrics_off_answers_are_bitwise_equal(blob_data, layout):
    q = _queries(blob_data, n=64)
    runs = [_build(blob_data, layout=layout, trace_sample=1.0).search(q, k=7),
            _build(blob_data, layout=layout).search(q, k=7),
            _build(blob_data, layout=layout, enabled=False).search(q, k=7)]
    with profile(activities=[ProfilerActivity.CPU]):
        runs.append(_build(blob_data, layout=layout).search(q, k=7))
    for r in runs[1:]:
        np.testing.assert_array_equal(r.dists, runs[0].dists)
        np.testing.assert_array_equal(r.ids, runs[0].ids)
        for name, v in runs[0].stats.items():
            np.testing.assert_array_equal(r.stats[name], v)


@pytest.mark.parametrize("layout", ["single", "routed"])
def test_an_unsampled_search_without_an_event_log_emits_nothing(blob_data, layout, monkeypatch):
    emitted: list[dict] = []
    monkeypatch.setattr(Registry, "emit_event",
                        lambda self, event, **kw: emitted.append(event))
    ix = _build(blob_data, layout=layout)
    q = _queries(blob_data)
    ix.search(q, k=5)
    ix.search(q, k=5, trace=new_trace())  # sampled, but no event log
    assert emitted == []
    m = ix.metrics()
    assert len(m["islands"]) == ix.backend.shards
    assert sum(row["distances"] for row in m["islands"].values()) == m["search"]["distances"]
    if layout == "routed":
        assert m["router"]["queries"] == 2 * len(q)


@pytest.mark.parametrize("layout", ["single", "routed"])
def test_a_sampled_search_with_an_event_log_emits_its_point_events(blob_data, layout):
    ix = _build(blob_data, layout=layout)
    ix.obs.events = log = Events()
    q = _queries(blob_data)
    ix.search(q, k=5)
    assert not [r for r in log.records if r.get("event") != "span"]
    ix.search(q, k=5, trace=new_trace())
    points = [r["event"] for r in log.records if r.get("event") != "span"]
    want = ["island"] * ix.backend.shards + (["router"] if layout == "routed" else [])
    assert sorted(points) == sorted(want)


def test_a_profiled_search_nests_its_phases_in_its_spans(blob_data):
    ix = _build(blob_data)
    q = _queries(blob_data)
    ix.search(q, k=5)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ix.search(q, k=5)
    ranges = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
              for e in _range_events(prof)]
    names = {n for _, _, n in ranges}
    device = {f"search/device_execute/{p}" for p in ("upload", "route", "bounds", "sort",
                                                     "scan", "finish")}
    host = {"search/host_transfer/finish", "search/host_transfer/copy"}
    assert names == {"search", "search/plan_lookup", "search/device_execute",
                     "search/host_transfer"} | device | host
    (lo, hi, _), = [r for r in ranges if r[2] == "search"]
    for s, e, n in ranges:
        assert lo <= s and e <= hi, n
    # no phase is timed without a sampled search
    assert not any(k.startswith("search/device/") for k in _spans(ix))


def test_a_sampled_profiled_search_splits_its_copy_into_wait_and_copy_ranges(blob_data):
    ix = _build(blob_data, trace_sample=1.0)
    q = _queries(blob_data)
    ix.search(q, k=5)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ix.search(q, k=5)
    names = [e.name() for e in _range_events(prof)]
    assert names.count("search/host_transfer/wait") == 1
    assert names.count("search/host_transfer/copy") == 1


def test_phase_ranges_nest_under_the_caller_span_not_under_search(blob_data):
    """The executor run by another caller (the serving engine's decode step)
    puts its phases under that caller's span, and under no span bare."""
    ix = _build(blob_data)
    q = torch.from_numpy(_queries(blob_data))
    ops = ix.backend.search_operands(ix.device)
    reg = Registry()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with reg.span("serve.decode_step"):
            knn_search_impl(ops, q, k=5, kernel=False)
        knn_search_impl(ops, q, k=5, kernel=False)
    names = {e.name() for e in _range_events(prof)}
    inner = {"route", "bounds", "sort", "scan", "finish"}
    assert names == {"serve.decode_step"} | {f"serve.decode_step/{p}" for p in inner} | inner


def test_threads_sampling_one_index_keep_their_own_phases(blob_data):
    ix = _build(blob_data, trace_sample=1.0)
    q = _queries(blob_data)
    want = ix.search(q, k=5)
    threads, n, errors = 4, 6, []
    start = threading.Barrier(threads)

    def work():
        try:
            start.wait()
            for _ in range(n):
                got = ix.search(q, k=5)
                np.testing.assert_array_equal(got.ids, want.ids)
        except BaseException as exc:  # noqa: BLE001 - re-raised in the main thread
            errors.append(exc)

    pool = [threading.Thread(target=work) for _ in range(threads)]
    for t in pool:
        t.start()
    for t in pool:
        t.join()
    assert not errors, errors
    sp = _spans(ix)
    runs = 1 + threads * n
    assert all(sp[name]["count"] == runs for name in NEW_SPANS), sorted(sp)
    # each run's phases are its own marks: they sum to its device extent
    parts = sum(sp[f"search/device/{p}"]["sum"] for p in PHASES)
    assert parts == pytest.approx(sp["search/device"]["sum"], rel=1e-9)
    assert sp["search/host_only"]["min"] >= 0


def test_a_search_nested_in_other_spans_still_times_its_host_share(blob_data):
    ix = _build(blob_data, trace_sample=1.0)
    q = _queries(blob_data)
    with ix.obs.span("request"):
        ix.search(q, k=5)
    hist = ix.obs.snapshot()["histograms"]
    assert "request/search" in hist and "search" not in hist
    assert hist["search/host_only"]["count"] == 1
    assert 0 <= hist["search/host_only"]["sum"] <= hist["request/search"]["sum"]


# -- the rows K1 staged, on sampled searches ----------------------------------

def _rows_counters(ix) -> tuple[int, int]:
    return ix.obs.value("search.staged_rows"), ix.obs.value("search.capacity_rows")


@pytest.mark.parametrize("delta", [False, True])
def test_a_sampled_search_counts_the_rows_k1_staged(blob_data, delta):
    """The staged rows are the extents (one past each bucket's last live
    row) summed over the slots the plain phase visited, which are a prefix of
    each query's visit order; the capacity rows are the padded distances."""
    from repro_torch.core.knn import knn_search_explain_impl
    from repro_torch.kernels.ref import bucket_extent
    from repro_torch.stream.ingest import delta_view

    ix = _build(blob_data, trace_sample=1.0)
    if delta:
        ix.ingest(_queries(blob_data, n=40, seed=9))
    q = _queries(blob_data)
    res = ix.search(q, k=5)
    staged, capacity = _rows_counters(ix)
    assert capacity == int(res.stats["padded_distances"].sum())
    dv = delta_view(ix.device_delta) if delta else None
    key = res.plan.key
    _, _, _, rows = knn_search_explain_impl(ix.device, torch.from_numpy(q), k=key.k,
                                            mode=key.mode, beam=key.beam, kernel=False,
                                            delta=dv)

    def prefix_sum(order, visits, sizes):
        cols = torch.arange(order.shape[1])[None]
        return int(torch.where(cols < visits[:, None], sizes[order.long()], 0).sum())

    want = prefix_sum(rows.order, rows.visits[0], bucket_extent(ix.device.bucket_ids))
    if delta:
        assert int(rows.dvisits.sum()) > 0
        want += prefix_sum(rows.dorder, rows.dvisits[0], dv.mask.sum(1))
    assert staged == want
    assert int(res.stats["distances"].sum()) <= staged < capacity
    m = ix.metrics()
    assert m["search"]["staged_share"] == pytest.approx(staged / capacity)
    assert m["registry"]["gauges"]["search.staged_share"] == pytest.approx(staged / capacity)
    assert "search_staged_share" in ix.obs.to_prometheus()
    ix.search(q, k=5)  # the counters accumulate over sampled searches
    assert _rows_counters(ix) == (2 * staged, 2 * capacity)


@pytest.mark.parametrize("layout", ["single", "sharded", "routed"])
def test_staged_rows_are_counted_on_every_island(blob_data, layout):
    ix = _build(blob_data, layout=layout, trace_sample=1.0)
    res = ix.search(_queries(blob_data), k=5)
    staged, capacity = _rows_counters(ix)
    assert capacity == int(res.stats["padded_distances"].sum())
    assert int(res.stats["distances"].sum()) <= staged < capacity


@pytest.mark.parametrize("trace", [None, TraceContext(sampled=False)], ids=["none", "unsampled"])
def test_an_unsampled_search_counts_no_staged_rows(blob_data, trace):
    from repro_torch.api.executor import IslandStats
    from repro_torch.core.knn import SearchStats
    from repro_torch.distributed.knn_island import IslandStats as ShardIslandStats

    ix = _build(blob_data)
    res = ix.search(_queries(blob_data), k=5, trace=trace)
    m = ix.metrics()
    assert "staged_share" not in m["search"]
    assert not any("staged" in k or "capacity_rows" in k
                   for part in ("counters", "gauges") for k in m["registry"][part])
    # the counter rides in no result tuple
    assert SearchStats._fields == ("buckets_visited", "distances", "bound_distances",
                                   "padded_distances", "comparisons", "steps")
    assert IslandStats._fields == ShardIslandStats._fields == (
        "buckets_visited", "distances", "bound_distances")
    assert set(res.stats) == set(SearchStats._fields)


@pytest.mark.cuda
def test_sampled_search_phases_on_the_card(blob_data):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    ix = _build(blob_data, device="cuda", trace_sample=1.0)
    q = _queries(blob_data, n=4096)
    for _ in range(5):
        res = ix.search(q, k=10)
    sp = _spans(ix)
    assert all(sp[name]["count"] == 5 for name in NEW_SPANS), sorted(sp)
    assert sp["search/device/scan"]["min"] > 0
    parts = sum(sp[f"search/device/{p}"]["sum"] for p in PHASES)
    assert parts == pytest.approx(sp["search/device"]["sum"], rel=0.01)
    plain = _build(blob_data, device="cuda").search(q, k=10)
    np.testing.assert_array_equal(res.ids, plain.ids)
    np.testing.assert_array_equal(res.dists, plain.dists)
    staged, capacity = _rows_counters(ix)
    assert capacity == 5 * int(res.stats["padded_distances"].sum())
    assert 5 * int(res.stats["distances"].sum()) <= staged < capacity


# -- the benchmark's reader ---------------------------------------------------

def _reader():
    path = ROOT / "bench" / "metrics" / "facade_idle_ms.py"
    spec = importlib.util.spec_from_file_location("bench_metric_facade_idle_ms", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Ctx:
    def __init__(self, trace):
        self.trace = trace


def _trace(gaps, *, calls=10, window_s=1.0, busy_s=0.8):
    return DeviceTrace(calls=calls, window_s=window_s, busy_s=busy_s, kernels=[],
                       idle_gaps=dict(gaps))


def test_facade_idle_apportions_the_idle_time_to_the_program_spans():
    gaps = {"search/device_execute/route": 0.01, "search/host_transfer": 0.02,
            "search": 0.01, "bench.call": 0.03, "aten::copy_": 0.02,
            "searchlight": 0.01}  # a name that only starts with the word
    got = _reader().read(_Ctx(_trace(gaps)))
    # 0.2 s idle over 10 calls = 20 ms a call; 0.04 of 0.10 s of gaps are the program's
    assert got == pytest.approx(20.0 * 0.4)


@pytest.mark.parametrize("trace", [
    None,
    _trace({"search": 0.01}, busy_s=1.0),  # no idle
    _trace({"search": 0.01}, busy_s=0.0),  # no device operation seen
    _trace({}),  # no gap charged at all
    _trace({"bench.call": 0.01, "aten::copy_": 0.02}),  # a program with no spans
], ids=["no_trace", "no_idle", "no_device", "no_gaps", "no_program_span"])
def test_facade_idle_reads_nothing_where_there_is_nothing(trace):
    assert _reader().read(_Ctx(trace)) is None
