"""The port's ``explain`` and telemetry against the JAX package, on the CPU.

``tests/test_trace_explain.py``'s explain and export cases on the port
(``device="cpu"``), and parity with the JAX package:

* ``attribute_visits``' hand case; conservation (contributing + wasted ==
  ``buckets_visited`` per query) and ``report.result`` bitwise equal to
  ``search()``; the separate explain plan; the ``overlap_health`` rollup;
  the measured-waste trigger; explain with no monitor and no delta;
* the prefix invariant the decode rests on: the plain scan phase, replayed
  on the search's operands, visits exactly the first ``visits`` entries of
  ``order`` (beam 1 and 4, main and delta phase);
* on a forest the JAX package built and saved and the port loaded (blob rows
  on a 1/8 grid): ``home``, ``contributing``, ``wasted``, ``visited_pair``
  and ``wasted_pair`` equal JAX ``explain()``'s exactly, and the same
  ``wasted`` triggers fire;
* telemetry: metrics on and off bitwise equal; ``metrics()`` with the JAX
  package's keys section by section; after the same search / ingest /
  maintain / explain sequence the registry counters equal the JAX
  package's name for name (the compile counts ``plan_cache.traces`` and the
  ingest ``traces`` are left out: the JAX package counts jit traces, the
  port the distinct operand shapes it ran); the Prometheus round trip, the
  export CLI, self-sampled and explicit traces, ``ServeEngine.reset_metrics``.
"""
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.api import (
    Config as JConfig,
    IndexConfig as JIndexConfig,
    OverlapIndex as JIndex,
    StreamConfig as JStreamConfig,
)
from repro_torch.api import (
    Config,
    IndexConfig,
    ObsConfig,
    OverlapIndex,
    PlanCache,
    PlanKey,
    StreamConfig,
)
from repro_torch.core.knn import (
    bucket_bounds,
    delta_bounds,
    knn_search_explain_impl,
    route_select,
)
from repro_torch.kernels import ref as kref
from repro_torch.obs import EventLog, Registry, Trace, new_trace
from repro_torch.obs import export as obs_export
from repro_torch.obs.attribution import attribute_visits
from repro_torch.stream.ingest import delta_view

BUILD = dict(method="vbm", eps=1.5, min_pts=8, xi_min=0.3, xi_max=0.7)
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


def _cfg(**kw) -> Config:
    obs_kw = {k: kw.pop(k) for k in list(kw)
              if k in ("trace_sample", "events_path", "enabled")}
    stream_kw = {"capacity": 64, **{k: kw.pop(k) for k in list(kw) if k == "wasted_rebuild"}}
    assert not kw, kw
    return Config(index=IndexConfig(**BUILD), stream=StreamConfig(**stream_kw),
                  obs=ObsConfig(**obs_kw))


def _build(x, **kw) -> OverlapIndex:
    return OverlapIndex.build(x, _cfg(**kw), device="cpu")


def _near(x, n, seed, *, grid=False):
    g = np.random.default_rng(seed)
    p = x[g.choice(len(x), n)] + 0.1 * g.normal(size=(n, x.shape[1]))
    return (np.round(p * 8) / 8 if grid else p).astype(np.float32)


def _far(n, d, seed, *, grid=False):
    """Queries spread over the whole box: they waste visits everywhere."""
    p = np.random.default_rng(seed).uniform(-15, 15, size=(n, d))
    return (np.round(p * 8) / 8 if grid else p).astype(np.float32)


# ---------------------------------------------------------------------------
# explain: attribution semantics
# ---------------------------------------------------------------------------


def test_attribute_visits_hand_case():
    # 2 indexes; buckets: row0 (idx 0) holds ids {0,1}, row1 (idx 1) holds
    # {2}, row2 (idx 1) holds {3}.  Query 0 visited rows [0, 2] and kept
    # ids {0, 1}: row0 contributed, row2 (owned by 1, home 0) was wasted.
    rep = attribute_visits(
        order=np.array([[0, 2, 1]]),
        visits=np.array([[2]]),
        dorder=None,
        dvisits=None,
        result_ids=np.array([[0, 1]]),
        home=np.array([0]),
        n_indexes=2,
        bucket_index=np.array([0, 1, 1]),
        bucket_ids=np.array([[0, 1], [2, -1], [3, -1]]),
        bucket_mask=np.array([[True, True], [True, False], [True, False]]),
        main_rows_per_shard=3,
        rates=np.array([[0.0, 0.4], [0.4, 0.0]]),
        method="vbm",
    )
    assert rep.contributing.tolist() == [1]
    assert rep.wasted.tolist() == [1]
    assert rep.wasted_pair[1, 0] == 1 and rep.wasted_pair.sum() == 1
    assert rep.visited_pair[0, 0] == 1 and rep.visited_pair[1, 0] == 1
    assert rep.wasted_fraction == 0.5
    assert rep.top_pairs()[0] == {"visited": 1, "home": 0, "wasted": 1, "visits": 1,
                                  "rate": 0.4}
    assert json.dumps(rep.to_dict())


@pytest.fixture(scope="module")
def explained(blob_data):
    """One index + queries + (search, explain) results, with a delta phase."""
    ix = _build(blob_data)
    ix.ingest(_near(blob_data, 48, seed=5))
    q = _near(blob_data, 24, seed=6)
    return ix, q, ix.search(q, k=6), ix.explain(q, k=6)


def test_explain_conservation_and_bitwise(explained):
    ix, q, res, rep = explained
    np.testing.assert_array_equal(rep.result.dists, res.dists)
    np.testing.assert_array_equal(rep.result.ids, res.ids)
    for name in ("buckets_visited", "distances", "bound_distances", "padded_distances",
                 "comparisons", "steps"):
        np.testing.assert_array_equal(rep.result.stats[name], res.stats[name])
    np.testing.assert_array_equal(rep.contributing + rep.wasted, res.stats["buckets_visited"])
    assert rep.queries == len(q)
    assert (rep.home >= 0).all() and (rep.home < ix.n_indexes).all()
    assert rep.visited_pair.sum() <= rep.total_visits
    assert rep.wasted_pair.sum() <= rep.wasted.sum()
    assert 0.0 <= rep.wasted_fraction <= 1.0
    assert rep.contributing.sum() > 0


def test_explain_separate_plan_leaves_search_plan_alone(explained):
    ix, q, res, rep = explained
    assert rep.result.plan.key.explain is True
    assert res.plan.key.explain is False
    assert rep.result.plan is not res.plan
    assert res.plan.key in ix.plans and rep.result.plan.key in ix.plans
    assert set(ix.plans.keys()) >= {res.plan.key, rep.result.plan.key}
    before = ix.plans.stats()["misses"]
    ix.search(q, k=6)
    ix.explain(q, k=6)
    assert ix.plans.stats()["misses"] == before


def test_explain_metrics_rollup(explained):
    ix, q, res, rep = explained
    oh = ix.metrics()["overlap_health"]
    assert oh["explained_queries"] >= len(q)
    assert oh["contributing"] >= int(rep.contributing.sum())
    assert oh["wasted"] >= int(rep.wasted.sum())
    assert 0.0 <= oh["wasted_fraction"] <= 1.0
    assert sum(oh["wasted_pairs"].values()) == sum(
        v for (n, _), v in ix.obs.counters().items() if n == "explain.wasted_pair")
    assert oh["monitor_wasted_share"] is not None
    assert json.dumps(oh)


def test_wasted_trigger_fires_and_resets(blob_data):
    ix = _build(blob_data, wasted_rebuild=0.05)
    ix.ingest(_near(blob_data, 32, seed=7))
    ix.explain(_far(32, blob_data.shape[1], seed=8), k=5)
    share = ix.monitor.wasted_share()
    fired = [i for i, why in ix.check().reasons.items() if "wasted" in why]
    expect = [i for i in range(ix.n_indexes)
              if ix.monitor.attr_visits[i] >= ix.monitor.WASTED_MIN_VISITS and share[i] >= 0.05]
    assert fired == expect and expect
    # a rebuild recreates the monitor: the evidence resets
    ix.maintain()
    assert ix.monitor.attr_visits.sum() == 0
    assert not any("wasted" in why for why in ix.check().reasons.values())


def test_explain_without_monitor_or_delta(blob_data):
    ix = _build(blob_data)
    q = np.asarray(blob_data[:8])
    rep = ix.explain(q, k=4)
    res = ix.search(q, k=4)
    np.testing.assert_array_equal(rep.result.ids, res.ids)
    np.testing.assert_array_equal(rep.contributing + rep.wasted, res.stats["buckets_visited"])
    assert rep.rates is not None and rep.rates.shape == (ix.n_indexes, ix.n_indexes)
    assert ix.metrics()["overlap_health"]["monitor_wasted_share"] is None


def _replay_visited(q, x, ids, count, bounds, beam, top_d, top_i):
    """The plain lockstep phase, step by step, keeping which (query, slot)
    it made active; returns (visited mask (Q, W), top_d, top_i)."""
    order, lb = bounds.order, bounds.lb_sorted
    visited = torch.zeros(order.shape, dtype=torch.bool)
    for t in range(order.shape[1] // beam):
        lo = t * beam
        act = lb[:, lo:lo + beam] <= torch.sqrt(top_d[:, -1])[:, None]
        if not bool(act.any()):
            break
        visited[:, lo:lo + beam] = act
        top_d, top_i = kref.bucket_scan_topk_ref(q, x, ids, order[:, lo:lo + beam], act,
                                                 top_d, top_i)
    return visited, top_d, top_i


@pytest.mark.parametrize("beam", [1, 4])
def test_explain_prefix_invariant(explained, beam):
    ix, q, _, _ = explained
    forest, qt = ix.device, torch.from_numpy(q)
    dv = delta_view(ix.device_delta)
    kk = 6
    _, _, _, rows = knn_search_explain_impl(forest, qt, k=kk, beam=beam, delta=dv)
    sel, _, _ = route_select(forest, qt)
    bounds = bucket_bounds(forest, qt, sel, beam=beam)
    np.testing.assert_array_equal(bounds.order.numpy(), rows.order.numpy())
    top_d = torch.full((len(q), kk), float("inf"))
    top_i = torch.full((len(q), kk), -1, dtype=torch.int32)
    count = forest.bucket_mask.sum(1, dtype=torch.int32)
    seen, top_d, top_i = _replay_visited(qt, forest.bucket_x, forest.bucket_ids, count,
                                         bounds, beam, top_d, top_i)
    w = seen.shape[1]
    assert torch.equal(seen, torch.arange(w)[None] < rows.visits[0][:, None])
    dbounds = delta_bounds(dv, qt, sel, beam=beam)
    dseen, _, _ = _replay_visited(qt, dv.x, dv.ids, dv.mask.sum(1, dtype=torch.int32),
                                  dbounds, beam, top_d, top_i)
    assert rows.dvisits[0].sum() > 0
    assert torch.equal(dseen, torch.arange(dseen.shape[1])[None] < rows.dvisits[0][:, None])


# ---------------------------------------------------------------------------
# parity with the JAX package, on a forest the JAX package built and saved
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_grid_snapshot(blob_data, tmp_path_factory):
    x = (np.round(blob_data * 8) / 8).astype(np.float32)
    jx = JIndex.build(x, JConfig(index=JIndexConfig(**BUILD),
                                 stream=JStreamConfig(capacity=64, wasted_rebuild=0.05)))
    jx.ingest(_near(x, 40, seed=9, grid=True))
    return x, jx.save(tmp_path_factory.mktemp("explain") / "grid")


def test_explain_matches_jax(jax_grid_snapshot):
    x, path = jax_grid_snapshot
    jx, tx = JIndex.load(path), OverlapIndex.load(path, device="cpu")
    q = np.concatenate([_near(x, 24, seed=10, grid=True), _far(24, x.shape[1], 11, grid=True)])
    for beam in (1, 4):
        rj, rt = jx.explain(q, k=5, beam=beam), tx.explain(q, k=5, beam=beam)
        np.testing.assert_array_equal(rt.result.ids, rj.result.ids)
        for name in ("home", "contributing", "wasted", "visited_pair", "wasted_pair"):
            np.testing.assert_array_equal(getattr(rt, name), getattr(rj, name), err_msg=name)
        np.testing.assert_array_equal(rt.rates, rj.rates)
        assert rt.top_pairs() == rj.top_pairs()
    np.testing.assert_array_equal(tx.monitor.attr_visits, jx.monitor.attr_visits)
    np.testing.assert_array_equal(tx.monitor.wasted_visits, jx.monitor.wasted_visits)
    wt = {i: w for i, w in tx.check().reasons.items() if "wasted" in w}
    wj = {i: w for i, w in jx.check().reasons.items() if "wasted" in w}
    assert wt == wj and wt


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------


def test_metrics_on_off_bitwise(blob_data):
    on, off = _build(blob_data), _build(blob_data, enabled=False)
    batch = _near(blob_data, 80, seed=12)
    q = _near(blob_data, 16, seed=13)
    for ix in (on, off):
        ix.ingest(batch)
        ix.maintain()
    for beam in (1, 4):
        a, b = on.search(q, k=5, beam=beam), off.search(q, k=5, beam=beam)
        np.testing.assert_array_equal(a.dists, b.dists)
        np.testing.assert_array_equal(a.ids, b.ids)
        ea, eb = on.explain(q, k=5, beam=beam), off.explain(q, k=5, beam=beam)
        np.testing.assert_array_equal(ea.result.dists, eb.result.dists)
        np.testing.assert_array_equal(ea.wasted_pair, eb.wasted_pair)
    m = off.metrics()
    assert m["enabled"] is False and m["registry"]["counters"] == {}
    assert m["plan_cache"]["misses"] == on.metrics()["plan_cache"]["misses"]
    assert on.metrics()["search"]["queries"] == 64


def _keys(d, depth=2):
    if not isinstance(d, dict) or depth == 0:
        return None
    return {k: _keys(v, depth - 1) for k, v in d.items()}


def test_metrics_and_counters_match_jax(jax_grid_snapshot):
    """The same calls on a JAX load and a port load of one snapshot."""
    x, path = jax_grid_snapshot
    jx, tx = JIndex.load(path), OverlapIndex.load(path, device="cpu")
    q = _near(x, 16, seed=14, grid=True)
    batch = _near(x, 200, seed=15, grid=True)
    for ix in (jx, tx):
        ix.search(q, k=5)
        ix.search(q, k=5, beam=4, mode="all")
        ix.ingest(batch)
        ix.maintain()
        ix.explain(q, k=5)
        ix.search(q, k=5)
    mj, mt = jx.metrics(), tx.metrics()
    assert _keys(mt) == _keys(mj)
    assert set(mt["search"]["spans"]) == set(mj["search"]["spans"])
    assert set(mt["registry"]["histograms"]) == set(mj["registry"]["histograms"])
    for section in ("maintenance", "islands", "router", "overlap_health"):
        assert mt[section] == mj[section], section
    for section in ("plan_cache", "ingest"):
        assert {k: v for k, v in mt[section].items() if k != "traces"} == \
            {k: v for k, v in mj[section].items() if k != "traces"}, section
    assert mt["registry"]["counters"] == mj["registry"]["counters"]
    assert mt["registry"]["gauges"] == mj["registry"]["gauges"]
    assert mt["maintenance"]["rebuilds"] > 0


def test_plan_cache_counters_and_traces(blob_data):
    reg = Registry()
    cache = PlanCache(max_plans=2, registry=reg)
    ix = _build(blob_data)
    keys = [PlanKey(k=k, mode="forest", beam=1, kernel=True, quantize=False) for k in (1, 2, 3)]
    for key in keys[:2] + keys[:1] + keys[2:]:
        cache.plan(key, ix.backend)
    assert cache.keys() == (keys[0], keys[2]) and keys[1] not in cache
    assert (reg.value("plan_cache.misses"), reg.value("plan_cache.hits"),
            reg.value("plan_cache.evictions")) == (3, 1, 1)
    q = _near(blob_data, 8, seed=16)
    plan = ix.plans.plan(keys[0], ix.backend)
    for n in (8, 8, 4):  # a new query-batch shape is a new specialization
        plan.executor(ix.device, torch.from_numpy(q[:n]), None)
    assert plan.traces == 2 and ix.plans.stats()["traces"] == 2


def test_ingest_stats_counts_padded_shapes(blob_data):
    ix = _build(blob_data)
    for n in (64, 40, 17):  # 40 pads to 64, 17 to 32
        ix.ingest(_near(blob_data, n, seed=n))
    assert ix.ingest_stats() == dict(traces=2, calls=3)
    assert ix.metrics()["ingest"]["points"] == 121


def test_prometheus_render_parse_roundtrip(blob_data):
    ix = _build(blob_data)
    q = np.asarray(blob_data[:8])
    ix.search(q, k=5)
    ix.explain(q, k=5)
    samples = obs_export.parse_prometheus(ix.obs.to_prometheus())
    by_name = {s["name"]: s for s in samples}
    assert by_name["search_queries"]["value"] == 16.0
    assert any(s["name"] == "search" and s["labels"].get("quantile") == "0.5"
               for s in samples)
    assert by_name["search_count"]["value"] >= 1
    island = [s for s in samples if s["name"].startswith("search_island_buckets_visited")]
    assert island and all("island" in s["labels"] for s in island)
    assert by_name["explain_queries"]["value"] == 8.0


def test_prometheus_parser_rejects_garbage():
    with pytest.raises(ValueError, match="line 1"):
        obs_export.parse_prometheus("not a metric line\n")


def test_prometheus_nonfinite_values():
    reg = Registry()
    reg.gauge("g").set(math.inf)
    reg.histogram("h")  # registered but never observed -> NaN percentiles
    samples = obs_export.parse_prometheus(reg.to_prometheus())
    assert [s["value"] for s in samples if s["name"] == "g"] == [math.inf]
    p50 = [s for s in samples if s["name"] == "h" and s["labels"].get("quantile") == "0.5"]
    assert p50 and math.isnan(p50[0]["value"])
    assert [s["value"] for s in samples if s["name"] == "h_count"] == [0.0]


def test_export_cli_check_and_snapshot(blob_data, tmp_path, capsys):
    p = str(tmp_path / "cli.jsonl")
    ix = _build(blob_data, events_path=p, trace_sample=1.0)
    ix.search(np.asarray(blob_data[:4]), k=3)
    snap_path = tmp_path / "metrics.json"
    snap_path.write_text(json.dumps(ix.metrics()))

    assert obs_export.main(["--events", p, "--check"]) == 0
    out = capsys.readouterr().out
    assert "prometheus render OK" in out and "search/device_execute" in out
    assert obs_export.main(["--snapshot", str(snap_path), "--format", "prometheus"]) == 0
    obs_export.parse_prometheus(capsys.readouterr().out)
    assert obs_export.main(["--events", p, "--traces"]) == 0
    tid = capsys.readouterr().out.strip().splitlines()[0]
    assert obs_export.main(["--events", p, "--trace", tid]) == 0
    assert "search" in capsys.readouterr().out
    assert obs_export.main(["--events", p, "--trace", "nope"]) == 1
    capsys.readouterr()
    # the module entry point, as a user runs it
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.export", "--snapshot", str(snap_path),
         "--check"], env=dict(os.environ, PYTHONPATH=SRC), capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0 and "prometheus render OK" in proc.stdout, proc.stderr


def test_export_cli_events_from_env(tmp_path, monkeypatch, capsys):
    p = str(tmp_path / "env.jsonl")
    with EventLog(p) as log:
        with Registry(events=log).span("phase"):
            pass
    monkeypatch.setenv("REPRO_OBS_EVENTS", p)
    assert obs_export.main(["--check"]) == 0
    assert "phase" in capsys.readouterr().out


def test_search_self_sampling_tracing(blob_data, tmp_path):
    p = str(tmp_path / "ix.jsonl")
    ix = _build(blob_data, trace_sample=0.5, events_path=p)
    for _ in range(6):
        ix.search(np.asarray(blob_data[:4]), k=3)
    tids = Trace.trace_ids(p)
    assert len(tids) == 3  # deterministic: every 2nd search
    t = Trace.reconstruct(p, tids[0])
    assert len(t.roots) == 1 and t.roots[0].name == "search"
    assert {"search", "search/plan_lookup", "search/device_execute",
            "search/host_transfer", "island"} <= t.span_names()
    unlinked = [r for r in EventLog.read(p) if r.get("span") == "search" and "trace_id" not in r]
    assert len(unlinked) == 3


def test_search_explicit_trace_and_tracing_off(blob_data, tmp_path):
    p = str(tmp_path / "joined.jsonl")
    ix = _build(blob_data, events_path=p)  # trace_sample 0.0
    ix.search(np.asarray(blob_data[:4]), k=3)
    assert Trace.trace_ids(p) == []
    ctx = new_trace()
    ix.search(np.asarray(blob_data[:4]), k=3, trace=ctx)
    t = Trace.reconstruct(p, ctx.trace_id)
    assert len(t.roots) == 1 and t.roots[0].record["parent_id"] == ctx.root_id
    assert "search/device_execute" in t.span_names()


def test_engine_reset_metrics():
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = get_smoke_config("smollm-135m")
    eng = ServeEngine(Model(cfg, device="cpu", seed=0), num_slots=1, max_len=16)
    eng.submit(Request(rid=0, prompt=np.arange(4, dtype=np.int32), max_new_tokens=2))
    eng.run()
    assert eng.obs.value("serve.completed") == 1
    old = eng.obs
    fresh = eng.reset_metrics()
    assert fresh is eng.obs and fresh is not old and fresh.value("serve.completed") == 0
    mine = Registry()
    assert eng.reset_metrics(mine) is mine and eng.obs is mine
    eng.submit(Request(rid=1, prompt=np.arange(4, dtype=np.int32), max_new_tokens=2))
    eng.run()
    assert mine.value("serve.completed") == 1 and old.value("serve.completed") == 1
