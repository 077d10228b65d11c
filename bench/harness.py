"""One run of one cell: set-up, the measured window, the traced stretch, the
metrics, the correctness check and the result line.

Set-up makes the configuration's rows, draws the mix's query pool from the
seed, builds the index through ``repro_torch.api.OverlapIndex.build`` and runs
the search's one shape three times.  The window then sends the pool's batches
one after another through ``OverlapIndex.search`` (a closed loop of one
client; each call returns host arrays, so it has finished on the device)
until ``seconds`` have passed and the whole pool has been sent once, and keeps
the answers of ``check_calls`` calls drawn from the seed by reservoir
sampling.  A traced run then profiles a stretch of about a second of the same
calls.  Once the program is freed, a plain reference judges the kept answers
by the configuration's ``check`` limits: where its search is ``mode="all"``,
against the brute force over every row (``reference/knn.py``); where it is
``mode="forest"`` (Alg. 2), against the brute force over each query's routed
rows (``reference/routed.py``), by a routing table worked out again from the
rows and the configuration's build parameters (``reference/forest.py``), and
the index of each row in the program's forest, copied before the index is
freed, against that table.

A mix that writes (``closed_loop_ingest``) replaces the time-bounded window
by a fixed stream, drawn before it: each of its ``calls`` calls writes a
batch through ``OverlapIndex.ingest``, runs ``maintain`` (the drift monitor
and any rebuild with its hot swap) and then searches, timed alone.  Set-up
warms the same calls up on writes of their own.  The answers of
``check_calls`` calls drawn from the seed, and of the first call after the
window's first rebuild swap, are judged read-your-writes by
``reference/stream.py``: exact over the build's rows and every batch
acknowledged up to that call, and every acknowledged row held once by the
index at the end of the run.
"""
from __future__ import annotations

import gc
import statistics
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable

import numpy as np

from bench import datasets, devtrace, traffic
from bench.catalog import Catalog, role_of
from bench.reference import knn as reference
from bench.reference import forest, routed
from bench.reference import stream as written

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
WARM_CALLS = 3
TRACE_SECONDS = 1.0
TRACE_CALLS = (8, 64)


class NoDevice(RuntimeError):
    pass


@dataclass
class Window:
    call_s: list[float]
    queries: int
    wall_s: float

    @property
    def calls(self) -> int:
        return len(self.call_s)


@dataclass
class Context:
    """What a metric reader reads (``metrics/<metric>.py``)."""

    config: dict[str, Any]
    mix: dict[str, Any]
    setup_s: float
    window: Window
    program: dict[str, float]  # the program's own spans and counters over the window
    forest: dict[str, int]  # slots (buckets x capacity), dim, buckets, indexes
    roles: list[tuple[str, str]]
    trace: devtrace.DeviceTrace | None = None
    trace_distances: int = 0  # distances the traced calls report
    trace_queries: int = 0
    trace_slots: int = 0  # a stream's main bucket slots and live delta rows over the traced calls

    def role(self, kernel: str) -> str | None:
        return role_of(kernel, self.roles)


@dataclass
class Checked:
    numbers: dict[str, float]
    limits: dict[str, float]
    wrong_queries: int
    queries: int = 0

    @property
    def correct(self) -> bool:
        return all(self.numbers[n] <= self.limits[n] for n in self.limits)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def pick_device(chips: int, device: str | None):
    import torch

    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell asks for {chips} cards, {torch.cuda.device_count()} found")
    return torch.device("cuda:0")


def routes(config: dict[str, Any]) -> bool:
    """Whether the configuration searches with routing (Alg. 2)."""
    return config["search"]["mode"] == "forest"


def writes(config: dict[str, Any]) -> bool:
    """Whether the configuration is a streaming deployment, written to
    between its searches."""
    return "stream" in config


def judge_of(config: dict[str, Any]):
    """The reference module whose comparison judges the configuration."""
    if writes(config):
        return written
    return routed if routes(config) else reference


def check_limits(config: dict[str, Any]) -> dict[str, float]:
    """The configuration's limit of each number its search's comparison
    reports; a name missing or left over is refused."""
    given = config["check"]
    names = judge_of(config).NUMBERS
    if set(given) != set(names):
        raise ValueError(f"the configuration's check names {sorted(given)}, "
                         f"its search's comparison {list(names)}")
    return {n: given[n] for n in names}


def build_index(x: np.ndarray, config: dict[str, Any], k: int, dev):
    from repro_torch.api import Config, IndexConfig, OverlapIndex, SearchConfig, StreamConfig

    cfg = Config(index=IndexConfig(**config["index"]),
                 search=SearchConfig(k=k, **config["search"]),
                 stream=StreamConfig(**config.get("stream", {})))
    return OverlapIndex.build(x, cfg, device=dev)


def program_owner(ix) -> np.ndarray:
    """The index that the program's forest puts each row in."""
    f = ix.forest
    return routed.owner_of_forest(f.bucket_ids, f.bucket_index, ix.n_total)


def program_held(ix) -> np.ndarray:
    """Every id the program's index holds, main buckets and delta."""
    d = ix.delta
    if d is None:
        return written.held(ix.forest.bucket_ids, np.zeros((0, 0)), np.zeros(0))
    return written.held(ix.forest.bucket_ids, d.ids.cpu().numpy(), d.count.cpu().numpy())


def stream_counters(ix) -> tuple[float, int]:
    """Seconds spent in rebuilds (the ``rebuild`` spans, from maintenance or
    from a write that found a delta bucket full) and indexes rebuilt."""
    hists = ix.obs.snapshot()["histograms"]
    rebuild_s = sum(h["sum"] for path, h in hists.items()
                    if path.rsplit("/", 1)[-1] == "rebuild")
    return rebuild_s, int(ix.obs.value("maintain.rebuilds"))


def search_counters(ix) -> tuple[int, int, int]:
    s = ix.metrics()["search"]
    return int(s["queries"]), int(s["distances"]), int(s["bound_distances"])


def run_window(search: Callable, pool: list[np.ndarray], seconds: float, keep: int,
               g: np.random.Generator) -> tuple[Window, list[tuple[int, Any]]]:
    """The closed loop, over ``seconds`` and at least one pass of the pool;
    returns the window and the kept (call, answer) pairs, a uniform sample of
    ``keep`` calls of the window (reservoir sampling)."""
    call_s: list[float] = []
    kept: list[tuple[int, Any]] = []
    n = len(pool)
    queries = 0
    gc.collect()
    gc.freeze()
    t_start = now = time.perf_counter()
    while now - t_start < seconds or len(call_s) < n:
        i = len(call_s)
        q = pool[i % n]
        t0 = time.perf_counter()
        res = search(q)
        now = time.perf_counter()
        call_s.append(now - t0)
        queries += len(q)
        if i < keep:
            kept.append((i, res))
        else:
            j = int(g.integers(0, i + 1))
            if j < keep:
                kept[j] = (i, res)
    gc.unfreeze()
    return Window(call_s=call_s, queries=queries, wall_s=now - t_start), kept


def judged_calls(mix: dict[str, Any], seed: int) -> set[int]:
    """The window calls of a stream whose answers are judged, drawn from the
    seed (besides the first call after a rebuild swap)."""
    g = datasets.sample_rng(seed, traffic.JUDGED)
    return {int(i) for i in g.choice(int(mix["calls"]), int(mix["check_calls"]), replace=False)}


@dataclass
class Streamed:
    """What a stream's calls leave for the check: every batch written, in
    order, with the ids each was acknowledged under, and the kept answers
    by the batch count their call had written."""

    writes: list[np.ndarray]
    acks: list[np.ndarray]
    kept: dict[int, tuple[np.ndarray, Any]]  # batches written -> (queries, answer)
    swap_call: int | None = None  # the window's first call after a rebuild swap

    def call(self, ix, search: Callable, rows: np.ndarray, q: np.ndarray):
        """One call: write, maintain, search; returns the answer and the
        search's seconds."""
        self.acks.append(ix.ingest(rows))
        self.writes.append(rows)
        ix.maintain()
        t0 = time.perf_counter()
        res = search(q)
        return res, time.perf_counter() - t0


def run_stream(ix, search: Callable, calls: traffic.Stream, judged: set[int],
               log: Streamed) -> Window:
    """The whole stream, each call timed from its write to its answer in
    the window's wall and its search alone in ``call_s``; keeps the answers
    of the ``judged`` calls and of the first call after a rebuild swap."""
    call_s: list[float] = []
    swaps = len(ix.rebuild_log)
    gc.collect()
    gc.freeze()
    t_start = time.perf_counter()
    for i, (rows, q) in enumerate(zip(*calls)):
        res, s = log.call(ix, search, rows, q)
        call_s.append(s)
        first_swap = log.swap_call is None and len(ix.rebuild_log) > swaps
        if first_swap:
            log.swap_call = i
        if first_swap or i in judged:
            log.kept[len(log.writes)] = (q, res)
    now = time.perf_counter()
    gc.unfreeze()
    return Window(call_s=call_s, queries=sum(len(q) for q in calls.queries),
                  wall_s=now - t_start)


def check_stream(x: np.ndarray, log: Streamed, held: np.ndarray, k: int,
                 limits: dict[str, float], dev) -> Checked:
    """Judge the kept answers against the brute force over the rows
    acknowledged up to their call, and the index's rows held at the end."""
    import torch

    readings, wrong, queries = [], 0, 0
    for n, (q, res) in sorted(log.kept.items()):
        xt = torch.as_tensor(written.rows_through(x, log.writes, n), device=dev)
        qt = torch.as_tensor(q, device=dev)
        truth = reference.exact_knn(xt, qt, k)
        r = reference.judge(xt, qt, res.dists, res.ids, truth, limits)
        wrong += r.pop("wrong_queries")
        queries += len(qt)
        readings.append(r)
        del xt
    numbers = reference.combine(readings)
    n_rows = len(x) + sum(len(w) for w in log.writes)
    numbers["lost_rows"] = float(written.lost_rows(held, n_rows)
                                 + written.misnumbered(log.acks, log.writes, len(x)))
    return Checked(numbers=numbers, limits=limits, wrong_queries=wrong, queries=queries)


def derived_routing(x: np.ndarray, config: dict[str, Any], dev) -> routed.Routing:
    """The routing table of the configuration's forest, worked out again
    from the rows by the plain reference."""
    import torch

    t0 = time.perf_counter()
    routing = forest.derive(torch.as_tensor(x, device=dev), config["index"])
    print(f"check: routing table derived in {time.perf_counter() - t0:.3f} s, "
          f"{len(routing.centers)} indexes", file=sys.stderr)
    return routing


def check(x: np.ndarray, pool: list[np.ndarray], kept: list[tuple[int, Any]], k: int,
          limits: dict[str, float], dev, routing: routed.Routing | None = None,
          owner: np.ndarray | None = None) -> Checked:
    """Judge the kept answers against the brute force over the same rows,
    or, where a derived ``routing`` table is given, over each query's routed
    rows, and the program's ``owner`` of each row against that table."""
    import torch

    xt = torch.as_tensor(x, device=dev)
    readings, wrong, queries = [], 0, 0
    for call, res in kept:
        qt = torch.as_tensor(pool[call % len(pool)], device=dev)
        if routing is None:
            truth = reference.exact_knn(xt, qt, k)
            r = reference.judge(xt, qt, res.dists, res.ids, truth, limits)
        else:
            r = routed.judge(xt, qt, res.dists, res.ids, k, routing, limits)
        wrong += r.pop("wrong_queries")
        queries += len(qt)
        readings.append(r)
    numbers = reference.combine(readings)
    if routing is not None:
        numbers["index_rows"] = float(routed.index_rows(owner, routing.owner.cpu().numpy()))
    return Checked(numbers=numbers, limits=limits, wrong_queries=wrong, queries=queries)


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, device: str | None = None,
             wrap: Callable | None = None) -> dict[str, Any]:
    """One run; returns the result line's object (``correct`` ... ``checks``).

    ``device`` names a device to run on without looking for a card (the CPU
    tests); ``wrap(ix, search)`` may replace the search the window drives (the
    tests plant faults under the harness with it)."""
    cat = Catalog(root)
    cell = cat.cell(workload)
    config = cat.config(cell["config"])
    mix = cat.mix(cell["traffic"])
    traffic.check_mix(mix)
    limits = check_limits(config)
    stream = traffic.streams(mix)
    if stream != writes(config):
        raise ValueError(f"cell {workload!r}: a mix that writes needs a configuration with a "
                         "stream entry, and such a configuration a mix that writes")
    dev = pick_device(int(cell["chips"]), device)
    import torch

    cuda = dev.type == "cuda"
    k = int(mix["k"])
    marks = [("start", t_start), ("imports", time.perf_counter())]
    x = datasets.make(config["dataset"])
    pool = traffic.query_pool(x, mix, seed)
    if stream:
        geo = datasets.geometry(config["dataset"])
        warm = traffic.stream(x, geo, mix, pool, seed, traffic.WARM, WARM_CALLS,
                              start=-WARM_CALLS)
        calls = traffic.stream(x, geo, mix, pool, seed, traffic.WINDOW, int(mix["calls"]))
        log = Streamed(writes=[], acks=[], kept={})
    marks.append(("data", time.perf_counter()))
    ix = build_index(x, config, k, dev)
    marks.append(("build", time.perf_counter()))
    search = ix.search if wrap is None else wrap(ix, ix.search)
    if stream:
        for rows, q in zip(*warm):
            log.call(ix, search, rows, q)
    else:
        for i in range(WARM_CALLS):
            search(pool[i % len(pool)])
    if cuda:
        torch.cuda.synchronize(dev)
    marks.append(("warm-up", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    print("set-up seconds: " + ", ".join(
        f"{name} {t - marks[i][1]:.3f}" for i, (name, t) in enumerate(marks[1:])),
        file=sys.stderr)

    q0, d0, b0 = search_counters(ix)
    if stream:
        r0, n0 = stream_counters(ix)
        window = run_stream(ix, search, calls, judged_calls(mix, seed), log)
        if window.wall_s < seconds:
            print(f"stream: the window of {window.calls} calls lasted {window.wall_s:.3f} s, "
                  f"under the {seconds:g} s asked for", file=sys.stderr)
    else:
        window, kept = run_window(search, pool, seconds, int(mix["check_calls"]),
                                  datasets.sample_rng(seed, 3))
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    q1, d1, b1 = search_counters(ix)
    spans = ix.metrics()["search"]["spans"]
    program = dict(queries=q1 - q0, distances=d1 - d0, bound_distances=b1 - b0,
                   device_execute_p50_s=spans["search/device_execute"]["p50"])
    if stream:
        r1, n1 = stream_counters(ix)
        program.update(calls=window.calls, rebuild_s=r1 - r0, rebuilds=n1 - n0,
                       ingest_p50_s=ix.obs.snapshot()["histograms"]["ingest"]["p50"])
    f = ix.forest
    ctx = Context(config=config, mix=mix, setup_s=setup_s, window=window, program=program,
                  forest=dict(slots=int(f.bucket_x.shape[0] * f.bucket_x.shape[1]),
                              dim=int(f.bucket_x.shape[2]), buckets=int(f.n_buckets),
                              indexes=int(f.n_indexes)),
                  roles=cat.roles())
    if trace:
        if stream:
            per_call = window.wall_s / window.calls
            n = int(min(TRACE_CALLS[1], max(TRACE_CALLS[0], TRACE_SECONDS / per_call)))
            n_host = max(TRACE_CALLS[0], n // 4)
            more = iter(zip(*traffic.stream(x, geo, mix, pool, seed, traffic.TRACE,
                                            n + n_host, start=window.calls)))
            slots: list[int] = []

            def call(i):
                res, _ = log.call(ix, search, *next(more))
                fb = ix.forest.bucket_x  # as the search found them
                slots.append(int(fb.shape[0] * fb.shape[1] + ix.delta.count.sum()))
                return res
            ctx.trace, results = devtrace.trace_calls(call, n, n_host, cuda=cuda)
            ctx.trace_slots = sum(slots[:n])
        else:
            per_call = statistics.median(window.call_s)
            n = int(min(TRACE_CALLS[1], max(TRACE_CALLS[0], TRACE_SECONDS / per_call)))
            ctx.trace, results = devtrace.trace_calls(
                lambda i: search(pool[i % len(pool)]), n, max(TRACE_CALLS[0], n // 4),
                cuda=cuda)
        ctx.trace_distances = int(sum(int(r.stats["distances"].sum()) for r in results))
        ctx.trace_queries = int(sum(len(r.ids) for r in results))
        del results

    metrics = {}
    for m in cat.metrics(workload, trace):
        value = cat.reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    owner = program_owner(ix) if routes(config) else None
    held = program_held(ix) if stream else None
    rebuilds = len(ix.rebuild_log)
    del search, ix
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    routing = derived_routing(x, config, dev) if owner is not None else None
    if stream:
        t0 = time.perf_counter()
        checked = check_stream(x, log, held, k, limits, dev)
        print(f"check: {len(log.kept)} calls judged in {time.perf_counter() - t0:.3f} s",
              file=sys.stderr)
    else:
        checked = check(x, pool, kept, k, limits, dev, routing, owner)
    result: dict[str, Any] = {
        "correct": checked.correct,
        "attempted": window.queries,
        "failed": checked.wrong_queries,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else dev.type,
            "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
            "count": int(cell["chips"]) if cuda else 1,
            "memory_peak_bytes": int(peak),
        },
    }
    if trace:
        tr = ctx.trace
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.top(tr.device_ops),
                               "idle_gaps": tr.top(tr.idle_gaps)}
    facts = dict(calls=window.calls, checked_queries=checked.queries, **ctx.forest)
    if stream:
        facts.update(wall_s=window.wall_s, rebuild_s=program["rebuild_s"],
                     indexes_rebuilt=program["rebuilds"], writes=len(log.writes),
                     rebuild_swaps=rebuilds, swap_call=log.swap_call, judged=sorted(log.kept))
    print("run: " + ", ".join(f"{k} {v}" for k, v in facts.items()), file=sys.stderr)
    result["checks"] = {name: {"value": checked.numbers[name], "limit": lim}
                        for name, lim in checked.limits.items()}
    return result
