"""The port's routed layout (``LayoutConfig(kind="routed")``) on the CPU,
four islands on ``device=["cpu"] * 4``.

* within the port, as ``tests/test_routed_exec.py`` holds the JAX package:
  routed (every fanout) == sharded == single, bit for bit, f32 and int8,
  with a delta, after a rebuild swap (which refreshes the routing table)
  and after save -> re-route -> load; ``auto`` prunes on well-separated
  clusters and fans out on uniform data; the serving datastore and the
  engine's greedy tokens equal the single layout's;
* the routing tier alone against the JAX functions called directly (they
  need no mesh): ``build_routing_table`` array for array, bitwise, and
  ``host_eligibility`` / ``price_dispatch`` on the same inputs;
* against the JAX package's routed runs, from a child process with four
  JAX host devices (``tests/test_torch_sharded.py``'s ``run_jax_child``):
  ids, d^2 within 8 ulp of the norms, ``SearchStats``, ``IslandStats``,
  ``VisitRows`` and ``RouterStats`` (integers and bools exactly, the f32
  cost terms to 1e-6), and ``metrics()["router"]`` name for name; a JAX
  routed snapshot loads in the port with its routing config.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.forest import ForestArrays as JForestArrays
from repro.distributed.router import (
    build_routing_table as j_build_table,
    host_eligibility as j_host_eligibility,
    price_dispatch as j_price_dispatch,
)
from repro_torch.api import (
    Config,
    IndexConfig,
    LayoutConfig,
    ObsConfig,
    OverlapIndex,
    RoutingConfig,
    SearchConfig,
    StreamConfig,
    make_backend,
)
from repro_torch.configs import get_smoke_config
from repro_torch.data.synthetic import embedding_datastore
from repro_torch.distributed.router import (
    RoutingTable,
    build_routing_table,
    host_eligibility,
    price_dispatch,
)
from repro_torch.models.model import Model
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.retrieval import forest_knn

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_sharded import (  # noqa: E402
    SEARCHES,
    assert_matches_jax,
    port_record,
    run_jax_child,
)

ISLANDS = ["cpu"] * 4
ROUTED4 = LayoutConfig(kind="routed", shards=4)
SHARDED4 = LayoutConfig(kind="sharded", shards=4)
INDEX_KW = dict(method="vbm", eps=2.5, min_pts=8, xi_min=0.3, xi_max=0.7)


def _islands(seed: int = 0, n_per: int = 400, spread: float = 30.0) -> np.ndarray:
    """tests/test_routed_exec.py's well-separated clusters: most hosts
    provably cannot hold a near-cluster query's answer."""
    g = np.random.default_rng(seed)
    centers = g.normal(size=(4, 8)) * spread
    return np.concatenate([c + g.normal(size=(n_per, 8)) for c in centers]).astype(np.float32)


def _queries(x: np.ndarray, n: int = 24, seed: int = 3) -> np.ndarray:
    g = np.random.default_rng(seed)
    base = x[g.choice(len(x), n)]
    return (base + 0.05 * g.normal(size=base.shape)).astype(np.float32)


def _grid(a: np.ndarray) -> np.ndarray:
    return (np.round(a * 8) / 8).astype(np.float32)


def _cfg(*, quantize=False, capacity=64, layout=None, index_kw=None, **obs) -> Config:
    return Config(
        index=IndexConfig(**(index_kw or INDEX_KW)),
        search=SearchConfig(quantize=quantize),
        stream=StreamConfig(capacity=capacity),
        layout=layout or LayoutConfig(),
        obs=ObsConfig(**obs),
    )


def _routed(fanout="auto", shards=4):
    return LayoutConfig(kind="routed", shards=shards, routing=RoutingConfig(fanout=fanout))


def _assert_same_results(res, ref, what=""):
    np.testing.assert_array_equal(res.dists, ref.dists, err_msg=what)
    np.testing.assert_array_equal(res.ids, ref.ids, err_msg=what)


@pytest.fixture(scope="module")
def data():
    return _islands()


@pytest.fixture(scope="module")
def forest(data):
    """One port build over the island data; every layout wires it."""
    return OverlapIndex.build(data, _cfg(), device="cpu")


def _wire(base, layout, *, quantize=False, capacity=64, devices=ISLANDS):
    cfg = _cfg(quantize=quantize, capacity=capacity, layout=layout)
    return OverlapIndex._wire(base.x_all, base.forest, cfg, base.build_report,
                              "cpu" if layout.kind == "single" else devices)


def _trio(base, *, quantize=False, fanout="auto"):
    return tuple(_wire(base, lay, quantize=quantize)
                 for lay in (LayoutConfig(), SHARDED4, _routed(fanout)))


# --- within the port: routed == sharded == single -----------------------------


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
def test_routed_bitwise_across_layouts(forest, data, quantize):
    single, sharded, routed = _trio(forest, quantize=quantize)
    assert routed.backend.kind == "routed" and routed.backend.shards == 4
    q = _queries(data)
    for mode in ("forest", "all"):
        for beam in (1, 4):
            for k in (1, 9):
                ref = single.search(q, k=k, mode=mode, beam=beam)
                what = f"{mode}/beam{beam}/k{k}"
                _assert_same_results(sharded.search(q, k=k, mode=mode, beam=beam), ref, what)
                _assert_same_results(routed.search(q, k=k, mode=mode, beam=beam), ref, what)
    batch = _queries(data, 40, seed=9)
    for ix in (single, sharded, routed):
        ix.ingest(batch)
    for mode in ("forest", "all"):
        for beam in (1, 4):
            ref = single.search(q, k=9, mode=mode, beam=beam)
            _assert_same_results(routed.search(q, k=9, mode=mode, beam=beam), ref,
                                 f"delta/{mode}/beam{beam}")
    m = routed.metrics()["router"]
    assert m["fanout"]["targeted"] > 0 and m["pruned_hosts"] > 0


@pytest.mark.parametrize("fanout", ["targeted", "all"])
def test_forced_fanout_modes_stay_bitwise(forest, data, fanout):
    single, _, routed = _trio(forest, fanout=fanout)
    q = _queries(data)
    for mode in ("forest", "all"):
        _assert_same_results(routed.search(q, k=7, mode=mode), single.search(q, k=7, mode=mode))
    m = routed.metrics()["router"]
    if fanout == "all":
        assert m["pruned_hosts"] == 0 and m["fanout"]["targeted"] == 0
    else:
        assert m["fanout"]["all"] == 0 and m["pruned_hosts"] > 0


def test_auto_degenerates_to_fanall_on_uniform():
    x = np.random.default_rng(5).uniform(-3, 3, size=(1200, 8)).astype(np.float32)
    ix = OverlapIndex.build(x, _cfg(layout=ROUTED4, index_kw=dict(
        method="vbm", eps=1.8, min_pts=8, xi_min=0.3, xi_max=0.7)), device=ISLANDS)
    single = _wire(ix, LayoutConfig())
    q = _queries(x, 16)
    _assert_same_results(ix.search(q, k=8), single.search(q, k=8))
    m = ix.metrics()["router"]
    assert m["fanout"]["all"] == 16 and m["fanout"]["targeted"] == 0


def test_rebuild_swap_refreshes_table_and_stays_bitwise(forest, data):
    single, _, routed = _trio(forest)
    batch = _queries(data, 50, seed=5)
    single.ingest(batch)
    routed.ingest(batch)
    before = routed.backend.table.count_hi.numpy().copy()
    triggers = [0, single.forest.n_indexes - 1]
    single._rebuild(triggers)
    routed._rebuild(triggers)
    after = routed.backend.table.count_hi.numpy()
    assert after.sum() > before.sum()
    assert after.sum() == routed.forest.bucket_mask.sum()
    q = _queries(data)
    for mode in ("forest", "all"):
        _assert_same_results(routed.search(q, k=7, mode=mode), single.search(q, k=7, mode=mode),
                             f"post-rebuild/{mode}")


def test_persistence_reroute_roundtrip(forest, data, tmp_path):
    routing = RoutingConfig(fanout="targeted", overlap_method="dbm")
    ix = _wire(forest, LayoutConfig(kind="routed", shards=4, routing=routing))
    ix.ingest(_queries(data, 30, seed=4))
    path = ix.save(tmp_path / "routed.npz")
    q = _queries(data)
    ref = ix.search(q, k=9)
    as_saved = OverlapIndex.load(path, device=ISLANDS)
    assert as_saved.backend.kind == "routed"
    assert as_saved.cfg.layout.routing == routing
    assert as_saved.backend.routing.fanout == "targeted"
    _assert_same_results(as_saved.search(q, k=9), ref, "saved")
    assert int(as_saved.backend.table.host_counts.sum()) == int(as_saved.forest.bucket_mask.sum())
    as_single = OverlapIndex.load(path, layout=LayoutConfig(), device="cpu")
    as_sharded = OverlapIndex.load(path, layout=SHARDED4, device=ISLANDS)
    _assert_same_results(as_single.search(q, k=9), ref, "to-single")
    _assert_same_results(as_sharded.search(q, k=9), ref, "to-sharded")


def test_load_clamp_rebuilds_routing_table(forest, data, tmp_path):
    """A snapshot saved routed x4 and loaded with two islands re-shards and
    rebuilds the table for two hosts."""
    ix = _wire(forest, ROUTED4)
    path = ix.save(tmp_path / "clamp.npz")
    q = _queries(data)
    ref = ix.search(q, k=9)
    with pytest.warns(UserWarning, match="re-sharding to 2"):
        clamped = OverlapIndex.load(path, device=["cpu"] * 2)
    assert clamped.backend.kind == "routed" and clamped.backend.shards == 2
    _assert_same_results(clamped.search(q, k=9), ref, "clamped")
    assert clamped.backend.table.host_counts.shape == (2,)
    assert int(clamped.backend.table.host_counts.sum()) == ix.n_total
    assert clamped.metrics()["router"]["table"]["hosts"] == 2


def test_serving_datastore_rides_routed_layout(forest, data):
    single, _, routed = _trio(forest)
    vals = np.arange(single.n_total) % 97
    ds_s = single.to_datastore(vals, stream_capacity=128)
    ds_r = routed.to_datastore(vals, stream_capacity=128)
    assert ds_r.shards == 4 and ds_r.router_table is not None and ds_r.fanout == "auto"
    q = torch.from_numpy(_queries(data, 12))
    d_s, v_s = forest_knn(q, ds_s, k=5)
    d_r, v_r = forest_knn(q, ds_r, k=5)
    assert torch.equal(d_r, d_s) and torch.equal(v_r, v_s)


def test_routed_engine_tokens_equal_single():
    """smollm-135m (smoke config) serving from a routed forest datastore
    gives the single layout's greedy tokens."""
    cfg = get_smoke_config("smollm-135m")
    model = Model(cfg, device="cpu", seed=0)
    keys, values = embedding_datastore(512, cfg.d_model, seed=6)
    base = OverlapIndex.build(keys, Config(index=IndexConfig(
        method="vbm", eps=float(np.median(np.linalg.norm(keys - keys.mean(0), axis=1))) / 4,
        min_pts=8)), device="cpu")
    vals = values % cfg.vocab_size
    out = {}
    for name, lay in (("single", LayoutConfig()), ("routed", ROUTED4)):
        ix = OverlapIndex._wire(keys, base.forest, Config(index=base.cfg.index, layout=lay),
                                base.build_report, "cpu" if name == "single" else ISLANDS)
        eng = ServeEngine(model, num_slots=2, max_len=24, datastore=ix.to_datastore(vals))
        g = np.random.default_rng(1)
        reqs = [Request(rid=i, prompt=g.integers(0, cfg.vocab_size, 3 + i).astype(np.int32),
                        max_new_tokens=5) for i in range(3)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        out[name] = [list(r.out_tokens) for r in reqs]
    assert out["routed"] == out["single"]
    assert all(len(t) == 5 for t in out["single"])


def test_plan_keys_carry_fanout(forest, data):
    _, sharded, routed = _trio(forest)
    q = _queries(data, 4)
    rr, rs = routed.search(q, k=3), sharded.search(q, k=3)
    assert rr.plan.key.fanout == "auto" and rs.plan.key.fanout is None
    assert rr.plan.key.shards == rs.plan.key.shards == 4
    assert rr.plan.key != rs.plan.key
    assert "routedx4" in repr(routed)


def test_routed_explain_bitwise_with_router_stats(forest, data):
    single, _, routed = _trio(forest)
    q = _queries(data, 8)
    ref = single.search(q, k=5)
    rep = routed.explain(q, k=5)
    np.testing.assert_array_equal(rep.result.dists, ref.dists)
    np.testing.assert_array_equal(rep.result.ids, ref.ids)
    np.testing.assert_array_equal(rep.contributing + rep.wasted,
                                  rep.result.stats["buckets_visited"])
    assert routed.metrics()["router"]["queries"] == 8


def test_routed_single_shard_degenerates():
    assert make_backend(_routed(shards=1), devices=ISLANDS).kind == "single"
    assert make_backend(ROUTED4, devices=["cpu"] * 4).kind == "routed"


# --- the routing tier alone, against the JAX functions ------------------------


def _j_forest(f) -> JForestArrays:
    return JForestArrays(**{fl.name: getattr(f, fl.name) for fl in dataclasses.fields(f)})


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("method", ["dbm", "vbm", "obm"])
def test_routing_table_matches_jax(forest, method, quantize, shards):
    """Every array the host numpy build makes (f64, then f32) bit for bit.
    ``host_rates`` is the registered overlap method's rate matrix (torch
    here, jnp there, on the same f32 centers and radii), held to the rates'
    standing tolerance of ``tests/test_torch_build.py`` (a log-volume sum
    rounds a few ulp apart in the two packages)."""
    got = build_routing_table(forest.forest, shards, method=method, quantize=quantize)
    want = j_build_table(_j_forest(forest.forest), shards, method=method, quantize=quantize)
    for name in RoutingTable._fields:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if name == "host_rates":
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_eligibility_and_pricing_match_jax(forest, data):
    """``host_eligibility`` and ``price_dispatch`` on the same inputs: the
    same eligible hosts and upper bounds, the costs to 1e-6."""
    f = forest.forest
    g = np.random.default_rng(8)
    q = _queries(data, 32, seed=8)
    n_idx = f.n_indexes
    tab = build_routing_table(f, 4)
    jtab = j_build_table(_j_forest(f), 4)
    d_center = np.sqrt(((q[:, None, :] - f.index_centers[None]) ** 2).sum(-1)).astype(np.float32)
    d_host = np.sqrt(((q[:, None, :] - tab.host_centers.numpy()[None]) ** 2).sum(-1)
                     ).astype(np.float32)
    # half the queries select their nearest index only (hosts get pruned),
    # half a random set
    sel = g.random((32, n_idx)) < 0.6
    sel[:16] = np.arange(n_idx)[None, :] == d_center[:16].argmin(1)[:, None]
    d_delta = (d_center + g.uniform(0, 2, size=d_center.shape)).astype(np.float32)
    radius = g.uniform(0, 3, size=n_idx).astype(np.float32)
    count = g.integers(0, 5, size=n_idx).astype(np.int32)
    eligs = []
    for kk, with_delta in ((10, True), (10, False), (5000, False)):
        kw = dict(d_delta=d_delta, delta_radius=radius, delta_count=count) if with_delta else {}
        t = {k: torch.from_numpy(v) for k, v in kw.items()}
        j = {k: jnp.asarray(v) for k, v in kw.items()}
        elig, ub = host_eligibility(tab, torch.from_numpy(d_center), torch.from_numpy(d_host),
                                    torch.from_numpy(sel), kk, **t)
        je, ju = j_host_eligibility(jtab, jnp.asarray(d_center), jnp.asarray(d_host),
                                    jnp.asarray(sel), kk, **j)
        np.testing.assert_array_equal(elig.numpy(), np.asarray(je))
        eligs.append(elig.numpy())
        np.testing.assert_array_equal(ub.numpy(), np.asarray(ju))
        cost = price_dispatch(tab, elig, torch.from_numpy(sel), kk, n_dim=q.shape[1])
        jc = j_price_dispatch(jtab, je, jnp.asarray(sel), kk, n_dim=q.shape[1])
        for name in cost._fields:
            np.testing.assert_allclose(getattr(cost, name).numpy(),
                                       np.asarray(getattr(jc, name)), rtol=1e-6, err_msg=name)
    # kk = 10 prunes some hosts; kk above the member count prunes none
    assert eligs[0].any() and not eligs[0].all() and eligs[2].all()


# --- against the JAX package's routed runs (child process) -------------------


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory, blob_data):
    out = tmp_path_factory.mktemp("jax_routed")
    data, spec = {}, {"datasets": {}, "searches": SEARCHES, "metrics": True}
    blob_kw = dict(method="vbm", eps=1.5, min_pts=8, xi_min=0.3, xi_max=0.7)
    for name, x, kw, fanout in (("islands", _grid(_islands()), INDEX_KW, "auto"),
                                ("islands_t", _grid(_islands()), INDEX_KW, "targeted"),
                                ("blobs", _grid(blob_data), blob_kw, "auto")):
        data[name + "/x"] = x
        data[name + "/q"] = _grid(_queries(x))
        data[name + "/batch"] = _grid(_queries(x, 40, seed=9))
        spec["datasets"][name] = {"kw": kw, "layout": {
            "kind": "routed", "shards": 4, "routing": {"fanout": fanout}}}
    ref = run_jax_child(out, spec, data)
    return dict(ref=ref, data=data, out=out)


@pytest.mark.parametrize("name", ["islands", "islands_t", "blobs"])
def test_matches_jax_routed_runs(jax_ref, name):
    """The port on the JAX routed snapshot against the JAX package's routed
    executor, f32 and int8, before and after an ingest: results, counters,
    island rows, visit rows and RouterStats; then ``metrics()["router"]``
    after the same f32 sequence."""
    import json

    ref, data, out = jax_ref["ref"], jax_ref["data"], jax_ref["out"]
    x, q, batch = data[name + "/x"], data[name + "/q"], data[name + "/batch"]
    base = OverlapIndex.load(out / f"jax_{name}_pre.npz", device=ISLANDS)
    assert base.backend.kind == "routed"
    for qz in (False, True):
        ix = OverlapIndex._wire(
            x, base.forest, dataclasses.replace(base.cfg, search=SearchConfig(quantize=qz)),
            base.build_report, ISLANDS)
        for phase in ("main", "delta"):
            if phase == "delta":
                ix.ingest(batch)
            for mode, beam in SEARCHES:
                tag = f"{name}/{int(qz)}/{phase}/{mode}/{beam}"
                assert_matches_jax(port_record(ix, q, 10, mode, beam), ref, tag, q, ix.x_all)
        if not qz:
            # the child's metrics() after its f32 sequence: its searches
            # went through the explain plan's executor directly, so only the
            # ingest ran through the facade; repeat that here
            want = json.loads(str(ref[name + "/metrics_json"]))
            assert ix.metrics()["router"] == want


def test_router_metrics_match_jax_names_and_values(jax_ref):
    """The same facade searches on both sides give the same router section:
    the child's record after ``search`` calls is replayed here through
    ``search`` on the port."""
    ref, data, out = jax_ref["ref"], jax_ref["data"], jax_ref["out"]
    ix = OverlapIndex.load(out / "jax_islands_post.npz", device=ISLANDS)
    q = data["islands/q"]
    res = ix.search(q, k=10)
    np.testing.assert_array_equal(res.ids, ref["islands/0/delta/forest/1/i"])
    m = ix.metrics()["router"]
    assert set(m) == {"queries", "eligible_hosts", "pruned_hosts", "fanout", "est_bytes",
                      "table"}
    tag = "islands/0/delta/forest/1/router/"
    assert m["queries"] == len(q)
    assert m["eligible_hosts"] == int(ref[tag + "eligible_hosts"].sum())
    assert m["pruned_hosts"] == int(ref[tag + "pruned_hosts"].sum())
    mode = "targeted" if bool(ref[tag + "targeted"]) else "all"
    assert m["fanout"][mode] == len(q)
    assert m["est_bytes"] == {"targeted": int(ref[tag + "wire_targeted"]),
                              "all": int(ref[tag + "wire_fanall"])}
    assert ix.cfg.layout == LayoutConfig(kind="routed", shards=4,
                                         routing=RoutingConfig(fanout="auto"))
