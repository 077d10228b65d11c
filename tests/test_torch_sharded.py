"""The port's sharded layout (``LayoutConfig(kind="sharded")``) on the CPU,
four islands on ``device=["cpu"] * 4``.

* within the port, as ``tests/test_sharded_exec.py`` holds the JAX package:
  the sharded search equals the single layout's bit for bit (distances and
  ids) on the blob and track data, f32 and int8, ``forest`` and ``all``,
  beam 1 and 4, with and without a delta; the islands' ingest walks the
  single layout's path (capacity rejects and retries included); a forced
  rebuild swap, save -> load under each layout, the serving datastore and
  the flat datastore's sharded ``knn_logits`` stay equal;
* against the JAX package's own sharded runs: its sharded executor needs
  four devices, and this process has initialised JAX with one, so a child
  process with ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` builds
  the reference on rows rounded to a 1/8 grid, saves it, and records the
  search results, ``SearchStats``, ``IslandStats`` and ``VisitRows`` of the
  same searches; the port loads the JAX snapshot and must give the same ids,
  d^2 within 8 ulp of the norms, and equal counters, island rows and visit
  rows.  A port snapshot loads in the JAX package under its layout (in the
  child) and clamped to one device (here);
* K1's ``qmask``: the plain phase with a mask against the JAX package's
  ``scan_sorted(qmask=)``;
* no fallback: a sharded build with no device and no CUDA refuses, and more
  islands than devices refuse a build and clamp a load.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.api import OverlapIndex as JIndex
from repro.core.knn import (
    bucket_bounds as j_bucket_bounds,
    device_forest as j_device_forest,
    scan_sorted as j_scan_sorted,
)
from repro_torch.api import (
    Config,
    ConfigError,
    IndexConfig,
    LayoutConfig,
    ObsConfig,
    OverlapIndex,
    SearchConfig,
    StreamConfig,
    make_backend,
)
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import RetrievalConfig
from repro_torch.core.forest import FOREST_FIELDS
from repro_torch.core.knn import device_forest_from_numpy
from repro_torch.distributed import Mesh, use_mesh
from repro_torch.kernels import ref as tref
from repro_torch.serve.retrieval import build_flat_datastore, forest_knn, ingest_keys, knn_logits

ROOT = Path(__file__).resolve().parent.parent
ISLANDS = ["cpu"] * 4
SHARDED4 = LayoutConfig(kind="sharded", shards=4)
D2_RTOL = 8 * float(np.finfo(np.float32).eps)
STAT_KEYS = ("buckets_visited", "distances", "bound_distances",
             "padded_distances", "comparisons")
# the cross-package searches (mode, beam), f32 and int8, each before and
# after an ingest
SEARCHES = (("forest", 1), ("forest", 4), ("all", 1))
CHILD_TIMEOUT = 900


def _tracks() -> np.ndarray:
    """tests/test_sharded_exec.py's 3-d trajectory-like clusters."""
    g = np.random.default_rng(21)
    centers = g.normal(size=(6, 3)) * 9.0
    parts = [c + 0.6 * g.normal(size=(300, 3)) for c in centers]
    parts.append(g.uniform(-12, 12, size=(60, 3)))
    return np.concatenate(parts).astype(np.float32)


def _queries(x: np.ndarray, n: int = 24, seed: int = 3) -> np.ndarray:
    g = np.random.default_rng(seed)
    base = x[g.choice(len(x), n)]
    return (base + 0.1 * x.std() * g.normal(size=base.shape)).astype(np.float32)


def _grid(a: np.ndarray) -> np.ndarray:
    return (np.round(a * 8) / 8).astype(np.float32)


def _cfg(index_kw: dict, *, quantize=False, capacity=64, layout=None, **obs) -> Config:
    return Config(
        index=IndexConfig(**index_kw),
        search=SearchConfig(quantize=quantize),
        stream=StreamConfig(capacity=capacity),
        layout=layout or LayoutConfig(),
        obs=ObsConfig(**obs),
    )


BLOB_KW = dict(method="vbm", eps=1.5, min_pts=8, xi_min=0.3, xi_max=0.7)
TRACK_KW = dict(method="vbm", eps=0.8, min_pts=8, xi_min=0.4, xi_max=0.8)
# chip_smoke.py's Tracking configuration on 5,000 tracking_like rows: 24
# small indexes, so a query's routed indexes often live on one island and
# the others' scans start underfilled (the island spill, see below)
SPILL_KW = dict(method="vbm", eps=6.0, min_pts=16, xi_min=0.4, xi_max=0.8, c_max=250)


def _spill_rows() -> np.ndarray:
    from repro_torch.data.synthetic import tracking_like

    return _grid(tracking_like(5_000))


@pytest.fixture(scope="module")
def datasets(blob_data):
    return {"blobs": (blob_data, BLOB_KW), "tracks": (_tracks(), TRACK_KW)}


@pytest.fixture(scope="module")
def pair(datasets):
    """Factory for a (single, 4-island) index pair over one dataset;
    ``fresh=True`` for tests that change the indexes."""
    cache = {}

    def get(name, *, quantize=False, capacity=64, fresh=False):
        key = (name, quantize, capacity)
        if fresh or key not in cache:
            x, kw = datasets[name]
            single = OverlapIndex.build(x, _cfg(kw, quantize=quantize, capacity=capacity),
                                        device="cpu")
            # the same forest under the sharded layout (the build is the same
            # on every layout: it runs on the first island's device)
            sharded = OverlapIndex._wire(
                x, single.forest, _cfg(kw, quantize=quantize, capacity=capacity,
                                       layout=SHARDED4),
                single.build_report, ISLANDS)
            if fresh:
                return single, sharded
            cache[key] = (single, sharded)
        return cache[key]

    return get


def _assert_same_results(res, ref, what=""):
    np.testing.assert_array_equal(res.dists, ref.dists, err_msg=what)
    np.testing.assert_array_equal(res.ids, ref.ids, err_msg=what)
    # eligibility-derived counters agree too (visits may not: each island's
    # scan ends on its own bound order)
    np.testing.assert_array_equal(res.stats["bound_distances"], ref.stats["bound_distances"],
                                  err_msg=what)


# --- within the port: sharded == single --------------------------------------


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("name", ["blobs", "tracks"])
def test_search_bitwise_across_layouts(pair, datasets, name, quantize):
    single, sharded = pair(name, quantize=quantize, fresh=True)
    assert sharded.backend.kind == "sharded" and sharded.backend.shards == 4
    x, _ = datasets[name]
    q = _queries(x)
    for mode in ("forest", "all"):
        for beam in (1, 4):
            for k in (1, 5, 17):
                _assert_same_results(sharded.search(q, k=k, mode=mode, beam=beam),
                                     single.search(q, k=k, mode=mode, beam=beam),
                                     what=f"{name}/{mode}/beam{beam}/k{k}/no-delta")
    batch = _queries(x, 40, seed=9)
    np.testing.assert_array_equal(single.ingest(batch), sharded.ingest(batch))
    assert int(sharded.delta.count.sum()) == len(batch)
    for mode in ("forest", "all"):
        for beam in (1, 4):
            _assert_same_results(sharded.search(q, k=9, mode=mode, beam=beam),
                                 single.search(q, k=9, mode=mode, beam=beam),
                                 what=f"{name}/{mode}/beam{beam}/delta")


def test_sharded_ingest_matches_single_with_capacity_rejects(pair, datasets):
    """Capacity 16 and batches up to 64: ragged padding, chunking and the
    capacity reject -> forced rebuild -> retry loop all fire, on the same
    path in both layouts."""
    single, sharded = pair("blobs", capacity=16, fresh=True)
    x, _ = datasets["blobs"]
    for seed, n in enumerate((16, 7, 33, 64)):
        batch = _queries(x, n, seed=seed)
        np.testing.assert_array_equal(single.ingest(batch), sharded.ingest(batch))
        for field, a, b in zip(single.delta._fields, single.delta, sharded.delta):
            np.testing.assert_array_equal(a.numpy(), b.numpy(),
                                          err_msg=f"delta.{field} after n={n}")
    assert single.ingest_stats() == sharded.ingest_stats()
    assert single.rebuild_log and len(single.rebuild_log) == len(sharded.rebuild_log)
    q = _queries(x)
    _assert_same_results(sharded.search(q, k=8), single.search(q, k=8))


def test_forced_rebuild_hot_swap_stays_bitwise(pair, datasets):
    single, sharded = pair("blobs", fresh=True)
    x, _ = datasets["blobs"]
    batch = _queries(x, 50, seed=5)
    single.ingest(batch)
    sharded.ingest(batch)
    triggers = [0, single.forest.n_indexes - 1]
    single._rebuild(triggers)
    sharded._rebuild(triggers)
    assert single.forest.n_indexes == sharded.forest.n_indexes
    np.testing.assert_array_equal(single.delta.count.numpy(), sharded.delta.count.numpy())
    q = _queries(x)
    for mode in ("forest", "all"):
        _assert_same_results(sharded.search(q, k=7, mode=mode),
                             single.search(q, k=7, mode=mode), what=f"post-rebuild/{mode}")
    more = _queries(x, 20, seed=6)
    np.testing.assert_array_equal(single.ingest(more), sharded.ingest(more))
    _assert_same_results(sharded.search(q, k=7), single.search(q, k=7))


def test_persistence_reshard_roundtrip(datasets, tmp_path):
    x, kw = datasets["blobs"]
    ix = OverlapIndex.build(x, _cfg(kw, layout=SHARDED4), device=ISLANDS)
    ix.ingest(_queries(x, 30, seed=4))
    path = ix.save(tmp_path / "sharded.npz")
    q = _queries(x)
    ref = ix.search(q, k=9)
    as_saved = OverlapIndex.load(path, device=ISLANDS)
    as_single = OverlapIndex.load(path, layout=LayoutConfig(), device="cpu")
    as_two = OverlapIndex.load(path, layout=LayoutConfig(kind="sharded", shards=2),
                               device=["cpu"] * 2)
    assert as_saved.backend.kind == "sharded" and as_saved.backend.shards == 4
    assert as_single.backend.kind == "single"
    assert as_two.backend.shards == 2
    for tag, other in (("saved", as_saved), ("single", as_single), ("two", as_two)):
        res = other.search(q, k=9)
        np.testing.assert_array_equal(res.dists, ref.dists, err_msg=tag)
        np.testing.assert_array_equal(res.ids, ref.ids, err_msg=tag)
        np.testing.assert_array_equal(other.delta.ids.numpy(), ix.delta.ids.numpy(), err_msg=tag)
        np.testing.assert_array_equal(other.delta.count.numpy(), ix.delta.count.numpy(),
                                      err_msg=tag)


def test_serving_datastore_rides_sharded_layout(pair, datasets):
    single, sharded = pair("blobs", fresh=True)
    x, _ = datasets["blobs"]
    vals = np.arange(single.n_total) % 97
    ds_s = single.to_datastore(vals, stream_capacity=128)
    ds_h = sharded.to_datastore(vals, stream_capacity=128)
    assert ds_h.shards == 4 and ds_h.router_table is None and ds_h.fanout is None
    q = torch.from_numpy(_queries(x, 12))
    d_s, v_s = forest_knn(q, ds_s, k=5)
    d_h, v_h = forest_knn(q, ds_h, k=5)
    assert torch.equal(d_h, d_s) and torch.equal(v_h, v_s)
    keys = _queries(x, 50, seed=8)
    toks = np.arange(50) % 97
    ds_s2, acc_s = ingest_keys(ds_s, keys, toks)
    ds_h2, acc_h = ingest_keys(ds_h, keys, toks)
    assert acc_s == acc_h > 0
    assert torch.equal(ds_h2.values, ds_s2.values)
    d_s3, v_s3 = forest_knn(q, ds_s2, k=5)
    d_h3, v_h3 = forest_knn(q, ds_h2, k=5)
    assert torch.equal(d_h3, d_s3) and torch.equal(v_h3, v_s3)


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_flat_knn_logits_sharded_equals_single(quantized):
    """The flat datastore split over four islands under ``use_mesh``: the
    same top-k (d^2 and values, ties to the lower row) and so the same
    p_knn as one scan of all rows."""
    cfg = get_smoke_config("smollm-135m").replace(
        retrieval=RetrievalConfig(enabled=True, k=8, lam=0.5, temperature=1.0,
                                  datastore_size=256))
    g = np.random.default_rng(12)
    keys = _grid(g.normal(size=(256, cfg.d_model)))
    keys[37] = keys[200]  # an exact tie across islands 0 and 3
    values = g.integers(0, cfg.vocab_size, 256)
    ds = build_flat_datastore(keys, values, quantized=quantized, device="cpu")
    hidden = torch.from_numpy(np.concatenate([keys[[200, 5]], _grid(g.normal(size=(6, cfg.d_model)))]))
    want = knn_logits(hidden, ds, cfg)
    with use_mesh(Mesh(ISLANDS)):
        got = knn_logits(hidden, ds, cfg)
    assert torch.equal(got, want)


def test_plan_keys_distinguish_layouts(pair, datasets):
    single, sharded = pair("blobs")
    q = _queries(datasets["blobs"][0], 4)
    rs, rh = single.search(q, k=3), sharded.search(q, k=3)
    assert rs.plan.key.shards == 1 and rh.plan.key.shards == 4
    assert rs.plan.key.fanout is None and rh.plan.key.fanout is None
    assert rs.plan.key != rh.plan.key
    assert "shardedx4" in repr(sharded)


def test_island_counters_sum_to_fleet_totals(datasets):
    x, kw = datasets["blobs"]
    ix = OverlapIndex.build(x, _cfg(kw, layout=SHARDED4), device=ISLANDS)
    q = _queries(x)
    ix.search(q, k=5, mode="forest")
    ix.ingest(_queries(x, 40, seed=9))
    ix.search(q, k=9, mode="forest")
    m = ix.metrics()
    assert set(m["islands"]) == {0, 1, 2, 3}
    for name in ("buckets_visited", "distances"):
        assert m["search"][name] > 0
        assert sum(isl[name] for isl in m["islands"].values()) == m["search"][name], name
    # every island routes the queries itself: the island rows count routing
    # (S - 1) times more than the fleet total
    summed = sum(isl["bound_distances"] for isl in m["islands"].values())
    assert summed == m["search"]["bound_distances"] + 3 * m["search"]["queries"] * ix.n_indexes
    assert m["router"]["table"] is None


def test_sharded_metrics_on_off_and_explain_bitwise(datasets):
    x, kw = datasets["blobs"]
    on = OverlapIndex.build(x, _cfg(kw, layout=SHARDED4), device=ISLANDS)
    off = OverlapIndex._wire(x, on.forest, _cfg(kw, layout=SHARDED4, enabled=False),
                             on.build_report, ISLANDS)
    single = OverlapIndex._wire(x, on.forest, _cfg(kw), on.build_report, "cpu")
    q = _queries(x)
    for ix in (on, off, single):
        ix.ingest(_queries(x, 30, seed=2))
    for beam in (1, 4):
        a, b = on.search(q, k=6, beam=beam), off.search(q, k=6, beam=beam)
        np.testing.assert_array_equal(a.dists, b.dists)
        np.testing.assert_array_equal(a.ids, b.ids)
        for key in STAT_KEYS:
            np.testing.assert_array_equal(a.stats[key], b.stats[key])
        rep = on.explain(q, k=6, beam=beam)
        np.testing.assert_array_equal(rep.result.dists, a.dists)
        np.testing.assert_array_equal(rep.result.ids, a.ids)
        np.testing.assert_array_equal(rep.contributing + rep.wasted,
                                      rep.result.stats["buckets_visited"])
        ref = single.search(q, k=6, beam=beam)
        np.testing.assert_array_equal(rep.result.ids, ref.ids)
    assert off.metrics()["islands"] == {}


# --- against the JAX package's sharded runs (child process) ------------------

CHILD = r'''
import json, sys
from dataclasses import replace
import numpy as np
import jax, jax.numpy as jnp
from repro.api import (Config, IndexConfig, LayoutConfig, OverlapIndex, RoutingConfig,
                       SearchConfig, StreamConfig)
from repro.stream.ingest import delta_view

assert jax.device_count() >= 4, jax.device_count()
out_dir = sys.argv[1]
spec = json.loads(open(out_dir + "/spec.json").read())
data = np.load(out_dir + "/data.npz")
res = {}


def record(ix, q, tag, k, mode, beam):
    key = ix._plan_key(k, mode, beam, None)._replace(explain=True)
    plan = ix.plans.plan(key, ix.backend)
    delta = None if ix._delta is None else delta_view(ix._delta)
    outs = jax.device_get(plan.executor(ix.backend.search_operands(ix.device),
                                        jnp.asarray(q), delta))
    d, i, s, isl, rows = outs[:5]
    res[tag + "/d"], res[tag + "/i"] = d, i
    for f in s._fields:
        res[tag + "/stats/" + f] = np.asarray(getattr(s, f))
    for f in isl._fields:
        res[tag + "/isl/" + f] = np.asarray(getattr(isl, f))
    for f in rows._fields:
        if getattr(rows, f) is not None:
            res[tag + "/rows/" + f] = np.asarray(getattr(rows, f))
    if len(outs) > 5:
        for f in outs[5]._fields:
            res[tag + "/router/" + f] = np.asarray(getattr(outs[5], f))


for name, d in spec["datasets"].items():
    x, q, batch = data[name + "/x"], data[name + "/q"], data[name + "/batch"]
    lay = LayoutConfig(**{**d["layout"],
                          "routing": RoutingConfig(**d["layout"].get("routing", {}))})
    cfg = Config(index=IndexConfig(**d["kw"]), stream=StreamConfig(capacity=64), layout=lay)
    ix = OverlapIndex.build(x, cfg)
    assert ix.backend.shards == 4, ix.backend
    ix.save(out_dir + "/jax_" + name + "_pre.npz")
    for qz in (False, True):
        iq = OverlapIndex._wire(x, ix.forest, replace(cfg, search=SearchConfig(quantize=qz)),
                                ix.build_report)
        for phase in ("main", "delta"):
            if phase == "delta":
                iq.ingest(batch)
                if not qz:
                    iq.save(out_dir + "/jax_" + name + "_post.npz")
            for mode, beam in spec["searches"]:
                record(iq, q, f"{name}/{int(qz)}/{phase}/{mode}/{beam}", 10, mode, beam)
        if not qz and "metrics" in spec:
            res[name + "/metrics_json"] = np.array(json.dumps(iq.metrics()["router"]))
for name, path in spec.get("port_snapshots", {}).items():
    ix = OverlapIndex.load(path)
    res[name + "/kind"] = np.array(ix.backend.kind)
    res[name + "/shards"] = np.int64(ix.backend.shards)
    r = ix.search(data[name + "/q"], k=10)
    res[name + "/d"], res[name + "/i"] = r.dists, r.ids
np.savez(out_dir + "/ref.npz", **res)
print("child ok", len(res))
'''


def run_jax_child(out_dir: Path, spec: dict, data: dict) -> dict:
    """Run ``CHILD`` in a process with four JAX host devices; return its
    recorded arrays.  A failure of the child fails the caller."""
    import json

    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "spec.json").write_text(json.dumps(spec))
    np.savez(out_dir / "data.npz", **data)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run([sys.executable, "-c", CHILD, str(out_dir)], env=env,
                          capture_output=True, text=True, timeout=CHILD_TIMEOUT)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-8000:]
    with np.load(out_dir / "ref.npz") as z:
        return {k: z[k] for k in z.files}


def port_record(ix, q, k, mode, beam) -> dict:
    """The port's twin of the child's ``record``: one explain-plan run
    through the executor, the raw device outputs as numpy."""
    key = ix._plan_key(k, mode, beam, None)._replace(explain=True)
    plan = ix.plans.plan(key, ix.backend)
    delta = None if ix._delta is None else ix.backend.delta_view(ix._delta)
    d, i, s, rows, *tail = plan.executor(ix.backend.search_operands(ix.device),
                                         torch.from_numpy(q), delta)
    out = {"d": d.numpy(), "i": i.numpy()}
    out.update({"stats/" + f: getattr(s, f).numpy() for f in s._fields})
    out.update({"isl/" + f: getattr(tail[0], f).numpy() for f in tail[0]._fields})
    out.update({"rows/" + f: getattr(rows, f).numpy() for f in rows._fields
                if getattr(rows, f) is not None})
    if len(tail) > 1:
        out.update({"router/" + f: getattr(tail[1], f).numpy() for f in tail[1]._fields})
    return out


def assert_matches_jax(got: dict, ref: dict, tag: str, q, x_rows) -> None:
    """ids equal, d^2 within 8 ulp of the norms, every counter, island row
    and visit row equal; RouterStats integers exact and costs to 1e-6."""
    np.testing.assert_array_equal(got["i"], ref[tag + "/i"], err_msg=tag)
    tol = D2_RTOL * ((q.astype(np.float64) ** 2).sum(1)
                     + (x_rows.astype(np.float64) ** 2).sum(1).max())[:, None]
    d2g = got["d"].astype(np.float64) ** 2
    d2w = ref[tag + "/d"].astype(np.float64) ** 2
    assert (np.abs(d2g - d2w) <= tol).all(), (tag, np.abs(d2g - d2w).max())
    for key in got:
        if key in ("d", "i"):
            continue
        want = ref[tag + "/" + key]
        if key.startswith("router/") and want.dtype.kind == "f":
            np.testing.assert_allclose(got[key], want, rtol=1e-6, err_msg=f"{tag} {key}")
        else:
            np.testing.assert_array_equal(got[key], want, err_msg=f"{tag} {key}")
    assert sorted(k for k in ref if k.startswith(tag + "/")) == sorted(
        tag + "/" + k for k in got), tag


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory, blob_data):
    """The child's records, the datasets (grid rows) and the paths of the
    snapshots both sides wrote."""
    out = tmp_path_factory.mktemp("jax_sharded")
    data, spec = {}, {"datasets": {}, "searches": SEARCHES, "port_snapshots": {}}
    for name, x, kw in (("blobs", _grid(blob_data), BLOB_KW), ("tracks", _grid(_tracks()), TRACK_KW),
                        ("spill", _spill_rows(), SPILL_KW)):
        data[name + "/x"] = x
        data[name + "/q"] = _grid(_queries(x))
        data[name + "/batch"] = _grid(_queries(x, 40, seed=9))
        spec["datasets"][name] = {"kw": kw, "layout": {"kind": "sharded", "shards": 4}}
    # a port snapshot for the child to load under its layout
    x = data["blobs/x"]
    port = OverlapIndex.build(x, _cfg(BLOB_KW, layout=SHARDED4), device=ISLANDS)
    port.ingest(data["blobs/batch"])
    path = port.save(out / "port_sharded.npz")
    spec["port_snapshots"]["port_sharded"] = path
    data["port_sharded/q"] = data["blobs/q"]
    ref = run_jax_child(out, spec, data)
    return dict(ref=ref, data=data, out=out, port=port, port_path=path)


@pytest.mark.parametrize("name", ["blobs", "tracks", "spill"])
def test_matches_jax_sharded_runs(jax_ref, name):
    """The port on the JAX snapshot, under the sharded layout, against the
    JAX package's sharded executor: ids, d^2, SearchStats (steps summed over
    the islands), IslandStats rows and VisitRows."""
    ref, data, out = jax_ref["ref"], jax_ref["data"], jax_ref["out"]
    x, q, batch = data[name + "/x"], data[name + "/q"], data[name + "/batch"]
    base = OverlapIndex.load(out / f"jax_{name}_pre.npz", device=ISLANDS)
    assert base.backend.kind == "sharded" and base.backend.shards == 4
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


def test_island_spill_diverges_from_single_as_jax_does(jax_ref):
    """A fault of the sharded design, in both packages: in ``mode="forest"``
    an island whose eligible rows hold fewer than k members scans past them
    into other indexes' rows (their +inf bounds are active while its own
    carry is unfilled), although the merged carry would be full.  Where such
    a spill finds rows closer than the routed indexes' k-th, the sharded
    result differs from the single layout's (it is closer, never farther).
    The port does exactly what the JAX package's sharded layout does
    (``test_matches_jax_sharded_runs[spill]``); ``mode="all"`` is unaffected."""
    ref, data, out = jax_ref["ref"], jax_ref["data"], jax_ref["out"]
    q = data["spill/q"]
    sharded = OverlapIndex.load(out / "jax_spill_pre.npz", device=ISLANDS)
    single = OverlapIndex.load(out / "jax_spill_pre.npz", layout=LayoutConfig(), device="cpu")
    rh, rs = sharded.search(q, k=10), single.search(q, k=10)
    np.testing.assert_array_equal(rh.ids, ref["spill/0/main/forest/1/i"])
    differ = ~((rh.dists == rs.dists).all(1) & (rh.ids == rs.ids).all(1))
    assert differ.any()
    assert (rh.dists[differ, -1] < rs.dists[differ, -1]).all()
    _assert_same_results(sharded.search(q, k=10, mode="all"), single.search(q, k=10, mode="all"))


def test_jax_snapshot_loads_sharded(jax_ref):
    """A JAX sharded snapshot (with a streamed delta) loads in the port under
    its layout and searches as the writer did."""
    ref, data, out = jax_ref["ref"], jax_ref["data"], jax_ref["out"]
    ix = OverlapIndex.load(out / "jax_blobs_post.npz", device=ISLANDS)
    assert ix.cfg.layout == SHARDED4 and ix.backend.kind == "sharded"
    q = data["blobs/q"]
    for mode, beam in (("forest", 1), ("all", 1)):
        tag = f"blobs/0/delta/{mode}/{beam}"
        assert_matches_jax(port_record(ix, q, 10, mode, beam), ref, tag, q, ix.x_all)


def test_port_snapshot_loads_in_jax(jax_ref):
    """A port sharded snapshot loads in the JAX package under its layout (the
    child, four devices) and, in this one-device process, clamped to one
    device with a warning, as the JAX package's clamp does; both search as
    the port does."""
    ref, data = jax_ref["ref"], jax_ref["data"]
    q = data["port_sharded/q"]
    want = jax_ref["port"].search(q, k=10)
    assert str(ref["port_sharded/kind"]) == "sharded" and int(ref["port_sharded/shards"]) == 4
    np.testing.assert_array_equal(ref["port_sharded/i"], want.ids)
    with pytest.warns(UserWarning, match="re-sharding to 1"):
        jx = JIndex.load(jax_ref["port_path"])
    assert jx.backend.kind == "single"
    assert jx.cfg.layout.kind == "sharded" and jx.cfg.layout.shards == 4
    got = jx.search(q, k=10)
    np.testing.assert_array_equal(got.ids, want.ids)
    d2_tol = D2_RTOL * ((q.astype(np.float64) ** 2).sum(1)[:, None]
                        + (jx.x_all.astype(np.float64) ** 2).sum(1).max())
    assert (np.abs(got.dists.astype(np.float64) ** 2 - want.dists.astype(np.float64) ** 2)
            <= d2_tol).all()


# --- K1 with qmask -----------------------------------------------------------


def _grid_rows(g, n, d):
    """Clustered rows on a 1/8 grid with a constant feature 15.875 that makes
    every row's int8 scale exactly 1/8: every sum of the expansion is exact
    in f32, whatever its order (tests/test_torch_search.py's rows)."""
    centers = g.uniform(-10, 10, size=(6, d))
    x = centers[g.integers(0, 6, n)] + 2.0 * g.normal(size=(n, d))
    x = np.clip(np.round(x * 8) / 8, -15.875, 15.875)
    return np.concatenate([x, np.full((n, 1), 15.875)], axis=1).astype(np.float32)


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("beam", [1, 4])
def test_qmask_phase_matches_jax_scan_sorted(quantize, beam):
    """The plain K1 phase with a ``qmask`` (half the queries masked) over the
    JAX package's own bounds equals ``scan_sorted(..., qmask=)`` bit for bit;
    a masked query keeps its carry with zero counters; an all-true mask
    equals no mask."""
    from repro.api import Config as JConfig, IndexConfig as JIndexConfig

    g = np.random.default_rng(70 + beam)
    x = _grid_rows(g, 600, 6)
    qn, kk = 24, 10
    q = x[g.choice(len(x), qn)].copy()
    q[:, :-1] += np.round(g.normal(size=(qn, 6)) * 4) / 8
    jx = JIndex.baseline(x, JConfig(index=JIndexConfig(pivot_method="kmeans", c_max=32)))
    jf = j_device_forest(jx.forest, quantize=quantize)
    jq = jnp.asarray(q)
    qmask = g.random(qn) < 0.5
    sel = jnp.ones((qn, jf.index_centers.shape[0]), bool)
    jb = j_bucket_bounds(jf, jq, sel, beam=beam, kernel=False)
    want = j_scan_sorted(jf, jq, jb, kk=kk, beam=beam, kernel=False, qmask=jnp.asarray(qmask))

    tf = device_forest_from_numpy({n: np.asarray(getattr(jx.forest, n)) for n in FOREST_FIELDS},
                                  device="cpu", quantize=quantize)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    args = (t(q), tf.bucket_x, tf.bucket_ids, torch.sum(tf.bucket_mask, 1, dtype=torch.int32),
            t(jb.order), t(jb.lb_sorted), beam, torch.full((qn, kk), float("inf")),
            torch.full((qn, kk), -1, dtype=torch.int32), tf.bucket_scale)
    got = tref.bucket_scan_phase_ref(*args, qmask=torch.from_numpy(qmask))
    np.testing.assert_array_equal(got[0].numpy().view(np.int32),
                                  np.asarray(want.top_d).view(np.int32))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want.top_i))
    for j, name in ((2, "visits"), (3, "ndist"), (4, "npad")):
        np.testing.assert_array_equal(got[j].numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert int(got[5].max()) == int(want.steps)
    off = ~qmask
    assert off.any() and qmask.any()
    assert np.isinf(got[0].numpy()[off]).all() and (got[1].numpy()[off] == -1).all()
    for j in (2, 3, 4, 5):
        assert (got[j].numpy()[off] == 0).all()
    full = tref.bucket_scan_phase_ref(*args, qmask=torch.ones(qn, dtype=torch.bool))
    plain = tref.bucket_scan_phase_ref(*args)
    for a, b in zip(full, plain):
        assert torch.equal(a, b)


# --- no fallback -------------------------------------------------------------


def test_sharded_build_without_device_refuses_cpu(monkeypatch, blob_data):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OverlapIndex.build(blob_data[:200], _cfg(BLOB_KW, layout=SHARDED4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_backend(SHARDED4)


def test_more_islands_than_devices(datasets, tmp_path):
    """shards above the devices given refuse a build and clamp a load (with
    a warning); one effective island collapses to the single layout."""
    x, kw = datasets["blobs"]
    with pytest.raises(ConfigError, match="one device per island"):
        OverlapIndex.build(x, _cfg(kw, layout=SHARDED4), device=["cpu"] * 2)
    ix = OverlapIndex.build(x, _cfg(kw, layout=SHARDED4), device=ISLANDS)
    path = ix.save(tmp_path / "four.npz")
    q = _queries(x)
    with pytest.warns(UserWarning, match="re-sharding to 2"):
        two = OverlapIndex.load(path, device=["cpu"] * 2)
    assert two.backend.shards == 2 and two.cfg.layout == SHARDED4
    with pytest.warns(UserWarning, match="re-sharding to 1"):
        one = OverlapIndex.load(path, device="cpu")
    assert one.backend.kind == "single"
    ref = ix.search(q, k=8)
    for other in (two, one):
        res = other.search(q, k=8)
        np.testing.assert_array_equal(res.dists, ref.dists)
        np.testing.assert_array_equal(res.ids, ref.ids)
    assert make_backend(LayoutConfig(kind="sharded", shards=1), devices=ISLANDS).kind == "single"
    assert make_backend(LayoutConfig(kind="sharded"), devices=ISLANDS).shards == 4
