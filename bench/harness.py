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


def check_limits(config: dict[str, Any]) -> dict[str, float]:
    """The configuration's limit of each number its search's comparison
    reports; a name missing or left over is refused."""
    given = config["check"]
    names = routed.NUMBERS if routes(config) else reference.NUMBERS
    if set(given) != set(names):
        raise ValueError(f"the configuration's check names {sorted(given)}, "
                         f"its search's comparison {list(names)}")
    return {n: given[n] for n in names}


def build_index(x: np.ndarray, config: dict[str, Any], k: int, dev):
    from repro_torch.api import Config, IndexConfig, OverlapIndex, SearchConfig

    cfg = Config(index=IndexConfig(**config["index"]),
                 search=SearchConfig(k=k, **config["search"]))
    return OverlapIndex.build(x, cfg, device=dev)


def program_owner(ix) -> np.ndarray:
    """The index that the program's forest puts each row in."""
    f = ix.forest
    return routed.owner_of_forest(f.bucket_ids, f.bucket_index, ix.n_total)


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
    dev = pick_device(int(cell["chips"]), device)
    import torch

    cuda = dev.type == "cuda"
    k = int(mix["k"])
    marks = [("start", t_start), ("imports", time.perf_counter())]
    x = datasets.make(config["dataset"])
    pool = traffic.query_pool(x, mix, seed)
    marks.append(("data", time.perf_counter()))
    ix = build_index(x, config, k, dev)
    marks.append(("build", time.perf_counter()))
    search = ix.search if wrap is None else wrap(ix, ix.search)
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
    window, kept = run_window(search, pool, seconds, int(mix["check_calls"]),
                              datasets.sample_rng(seed, 3))
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    q1, d1, b1 = search_counters(ix)
    spans = ix.metrics()["search"]["spans"]
    program = dict(queries=q1 - q0, distances=d1 - d0, bound_distances=b1 - b0,
                   device_execute_p50_s=spans["search/device_execute"]["p50"])
    f = ix.forest
    ctx = Context(config=config, mix=mix, setup_s=setup_s, window=window, program=program,
                  forest=dict(slots=int(f.bucket_x.shape[0] * f.bucket_x.shape[1]),
                              dim=int(f.bucket_x.shape[2]), buckets=int(f.n_buckets),
                              indexes=int(f.n_indexes)),
                  roles=cat.roles())
    if trace:
        per_call = statistics.median(window.call_s)
        n = int(min(TRACE_CALLS[1], max(TRACE_CALLS[0], TRACE_SECONDS / per_call)))
        ctx.trace, results = devtrace.trace_calls(
            lambda i: search(pool[i % len(pool)]), n, max(TRACE_CALLS[0], n // 4), cuda=cuda)
        ctx.trace_distances = int(sum(int(r.stats["distances"].sum()) for r in results))
        ctx.trace_queries = int(sum(len(r.ids) for r in results))
        del results

    metrics = {}
    for m in cat.metrics(workload, trace):
        value = cat.reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    owner = program_owner(ix) if routes(config) else None
    del search, ix
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    routing = derived_routing(x, config, dev) if owner is not None else None
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
    print("run: " + ", ".join(f"{k} {v}" for k, v in dict(
        calls=window.calls, checked_queries=checked.queries, **ctx.forest).items()),
        file=sys.stderr)
    result["checks"] = {name: {"value": checked.numbers[name], "limit": lim}
                        for name, lim in checked.limits.items()}
    return result
