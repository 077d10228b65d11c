"""The port's streaming forest datastore and the engine's ingest path against
the JAX package, on the CPU.

* ``build_forest_datastore``: the chunked eps heuristic is bit-equal to the
  reference's one-array formula, and both packages build the same forest;
* ``ingest_keys``: the same accepted counts call by call (capacity rejects
  and the values tail included), never an id past the tail, the probe
  leaves the datastore as it was;
* ``forest_knn`` and ``knn_logits`` over forest + delta: the same values,
  d^2 within 8 ulp of the norms;
* the engine: interleaved decodes and inserts give the JAX engine's tokens
  and accepted counts; the ingest drain is bounded and fair; an insert
  into a datastore that takes none fails that request only.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Config as JConfig, IndexConfig as JIndexConfig
from repro.api import OverlapIndex as JIndex
from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import RetrievalConfig as JRetrievalConfig
from repro.models.model import Model as JModel
from repro.serve import retrieval as jret
from repro.serve.engine import IngestRequest as JIngestRequest
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.api import Config, IndexConfig, OverlapIndex
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import RetrievalConfig
from repro_torch.data.synthetic import embedding_datastore
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model
from repro_torch.serve.engine import IngestRequest, Request, ServeEngine
from repro_torch.serve.retrieval import (
    ForestDatastore,
    build_flat_datastore,
    build_forest_datastore,
    eps_heuristic,
    forest_knn,
    ingest_keys,
    knn_logits,
)

D2_RTOL = 8 * float(np.finfo(np.float32).eps)


def _retrieval(**kw):
    base = dict(enabled=True, k=4, lam=0.5, temperature=1.0, datastore_size=512)
    base.update(kw)
    return RetrievalConfig(**base), JRetrievalConfig(**base)


@pytest.fixture(scope="module")
def cfgs():
    tr, jr = _retrieval()
    return (get_smoke_config("qwen2-0.5b").replace(retrieval=tr),
            j_smoke("qwen2-0.5b").replace(retrieval=jr))


@pytest.fixture(scope="module")
def stores(cfgs):
    """The same keys and tokens as a streaming forest datastore in each
    package."""
    cfg, _ = cfgs
    keys, values = embedding_datastore(256, cfg.d_model, seed=4)
    values = values % cfg.vocab_size
    tds = build_forest_datastore(keys, values, stream_capacity=64, device="cpu")
    jds = jret.build_forest_datastore(keys, values, stream_capacity=64)
    return keys, values, tds, jds


def _assert_delta_equal(dt, dj):
    for name in ("x", "ids", "count", "dropped", "pivot"):
        np.testing.assert_array_equal(getattr(dt, name).numpy(), np.asarray(getattr(dj, name)),
                                      err_msg=name)
    for name in ("radius", "sum_x"):
        a, b = getattr(dt, name).numpy(), np.asarray(getattr(dj, name))
        fin = np.isfinite(b)
        assert (np.abs(a[fin] - b[fin]) <= 2 * np.spacing(np.abs(b[fin]))).all(), name


def _assert_knn_equal(hidden, keys, d2t, vt, d2j, vj):
    """Token values equal and d^2 within 8 ulp of the norms (the queries
    sit far from every tie here)."""
    np.testing.assert_array_equal(vt, vj)
    tol = D2_RTOL * ((hidden.astype(np.float64) ** 2).sum(1)
                     + (keys.astype(np.float64) ** 2).sum(1).max())[:, None]
    fin = np.isfinite(d2j)
    assert np.array_equal(np.isfinite(d2t), fin)
    assert (np.abs(d2t[fin] - d2j[fin]) <= np.broadcast_to(tol, d2j.shape)[fin]).all()


@pytest.mark.parametrize("n,d", [(300, 64), (256, 896), (3000, 8)])
def test_eps_heuristic_bitwise(n, d):
    """Row chunks give the reference's eps bit for bit: each squared
    distance is the same sum over the last axis."""
    g = np.random.default_rng(n + d)
    keys = (g.normal(size=(n, d)) * 3).astype(np.float32)
    rng = np.random.default_rng(0)
    sample = keys[rng.choice(len(keys), min(2048, len(keys)), replace=False)]
    d2 = ((sample[:, None, :] - sample[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    want = 2.0 * float(np.sqrt(np.median(d2.min(axis=1))))
    assert eps_heuristic(keys) == want
    assert eps_heuristic(keys, chunk=7) == want


def test_forest_datastore_builds_the_jax_forest(stores):
    keys, values, tds, jds = stores
    assert isinstance(tds, ForestDatastore)
    for name in ("index_centers", "neighbors", "bucket_ids", "bucket_mask", "bucket_x",
                 "bucket_pivot", "bucket_radius", "bucket_index"):
        np.testing.assert_array_equal(getattr(tds.forest, name).numpy(),
                                      np.asarray(getattr(jds.forest, name)), err_msg=name)
    np.testing.assert_array_equal(tds.values.numpy(), np.asarray(jds.values))
    assert (tds.n_main, tds.next_id) == (jds.n_main, int(jds.next_id)) == (256, 256)
    _assert_delta_equal(tds.delta, jds.delta)
    assert tds.values.shape[0] == 256 + 64


def test_ingest_keys_matches_jax(stores, cfgs):
    """Calls until the buffers reject and the tail runs out: the same
    accepted count every call, the same buffers, ids never past the tail,
    and a probe that changes nothing."""
    keys, values, tds, jds = stores
    cfg, jcfg = cfgs
    g = np.random.default_rng(9)
    before = [t.clone() for t in tds.delta]
    counts = []
    for r in range(5):
        base = keys[g.choice(len(keys), 24)]
        kb = (base + 0.2 * g.normal(size=base.shape)).astype(np.float32)
        vb = ((np.arange(24) + 24 * r) % cfg.vocab_size).astype(np.int32)
        tds2, at = ingest_keys(tds, kb, vb)
        jds, aj = jret.ingest_keys(jds, jnp.asarray(kb), jnp.asarray(vb))
        if r == 0:  # ingest_keys returns a new datastore; the old one stays
            for name, a, b in zip(tds.delta._fields, tds.delta, before):
                assert torch.equal(a, b), name
            assert tds.next_id == 256
        tds = tds2
        assert at == aj
        counts.append(at)
        assert tds.next_id == int(jds.next_id) <= tds.values.shape[0]
        np.testing.assert_array_equal(tds.values.numpy(), np.asarray(jds.values))
        _assert_delta_equal(tds.delta, jds.delta)
    assert sum(counts) == 64 and counts[-1] == 0  # the tail ran out
    assert int(tds.delta.dropped.sum()) > 0 or min(counts[:-1]) < 24
    hidden = keys[:10] + 0.05
    d2t, vt = forest_knn(torch.from_numpy(hidden), tds, 4)
    d2j, vj = jret.forest_knn(jnp.asarray(hidden), jds, 4)
    _assert_knn_equal(hidden, keys, d2t.numpy(), vt.numpy(), np.asarray(d2j), np.asarray(vj))
    # p_knn = softmax(-d / T) over the k neighbours, summed per token: a
    # weight moves by at most k / (4 T) times the largest change of a d,
    # and d moves as far as d^2's 8-ulp band allows
    pt = knn_logits(torch.from_numpy(hidden), tds, cfg).numpy()
    pj = np.asarray(jret.knn_logits(jnp.asarray(hidden), jds, jcfg))
    d2 = np.asarray(d2j, np.float64)
    tol = D2_RTOL * ((hidden.astype(np.float64) ** 2).sum(1)
                     + (keys.astype(np.float64) ** 2).sum(1).max())[:, None]
    dd = np.sqrt(d2 + tol) - np.sqrt(np.maximum(d2 - tol, 0.0))
    r = cfg.retrieval
    bound = r.k / (4 * r.temperature) * dd.max(1, keepdims=True)
    np.testing.assert_array_equal(pt > 0, pj > 0)
    assert (np.abs(pt - pj) <= bound + 1e-6).all()


def test_ingest_keys_never_outruns_values_tail(cfgs):
    """Ids come from the datastore's own high-water mark and stop at the
    preallocated tail: every accepted key retrieves its own token."""
    cfg, jcfg = cfgs
    keys, values = embedding_datastore(256, cfg.d_model, seed=6)
    ds = build_forest_datastore(keys, values % cfg.vocab_size, stream_capacity=8,
                                device="cpu")
    jds = jret.build_forest_datastore(keys, values % cfg.vocab_size, stream_capacity=8)
    new_keys = (-keys[:16] + 40.0).astype(np.float32)
    new_vals = (np.arange(16) + 100).astype(np.int32)
    ds, acc1 = ingest_keys(ds, new_keys, new_vals)
    jds, jacc1 = jret.ingest_keys(jds, new_keys, new_vals)
    assert acc1 == jacc1 == 8
    ds, acc2 = ingest_keys(ds, new_keys[8:], new_vals[8:])
    assert acc2 == 0 and ds.next_id == ds.n_main + 8
    p = knn_logits(torch.from_numpy(new_keys[:8]), ds, cfg)
    np.testing.assert_array_equal(torch.argmax(p, -1).numpy(), new_vals[:8])
    with pytest.raises(ValueError, match="stream_capacity"):
        ingest_keys(dataclasses.replace(ds, delta=None), new_keys, new_vals)


def test_to_datastore_carries_live_delta(blob_data):
    """A live delta rides along: streamed points keep their tokens; the
    value count is checked."""
    cfg = Config(index=IndexConfig(method="vbm", eps=1.5, min_pts=8))
    ix = OverlapIndex.build(blob_data, cfg, device="cpu")
    with pytest.raises(ValueError, match="one value per indexed object"):
        ix.to_datastore(np.zeros(3, np.int32))
    g = np.random.default_rng(7)
    xs = (blob_data[g.choice(len(blob_data), 8)] + 0.3 * g.normal(size=(8, 8))
          ).astype(np.float32)
    ids = ix.ingest(xs)
    vals = (np.arange(ix.n_total) % 97).astype(np.int32)
    ds = ix.to_datastore(vals)
    assert ds.delta is ix.device_delta and ds.values.shape[0] == ix.n_total
    _, got = forest_knn(torch.from_numpy(xs), ds, 1)
    np.testing.assert_array_equal(got.numpy()[:, 0], vals[ids])
    jx = JIndex.build(blob_data, JConfig(index=JIndexConfig(method="vbm", eps=1.5, min_pts=8)))
    jx.ingest(xs)
    jds = jx.to_datastore(vals, stream_capacity=16)
    tds = ix.to_datastore(vals, stream_capacity=16)
    assert tds.values.shape[0] == ix.n_total + 16
    d2t, vt = forest_knn(torch.from_numpy(xs + 0.1), tds, 5)
    d2j, vj = jret.forest_knn(jnp.asarray(xs + 0.1), jds, 5)
    _assert_knn_equal(xs + 0.1, ix.x_all, d2t.numpy(), vt.numpy(), np.asarray(d2j),
                      np.asarray(vj))


# --------------------------------------------------------------------------
# the engine's ingest path
# --------------------------------------------------------------------------


def test_engine_mixed_traffic_matches_the_jax_engine(cfgs):
    """Interleaved decodes and inserts on a forest datastore: the port's
    engine gives the JAX engine's tokens and accepted counts (f32 compute,
    the same weights), and the streamed pairs are retrievable through the
    engine's own datastore."""
    tr, jr = _retrieval(k=4, lam=0.5, temperature=1.0)
    cfg = get_smoke_config("qwen2-0.5b").replace(compute_dtype="float32", retrieval=tr)
    jcfg = j_smoke("qwen2-0.5b").replace(compute_dtype="float32", retrieval=jr)
    jm = JModel(jcfg)
    params = jm.init(jax.random.key(2))
    tm = params_from_jax(jax.tree.map(np.asarray, params), cfg, device="cpu")
    keys, values = embedding_datastore(256, cfg.d_model, seed=4)
    values = values % cfg.vocab_size
    teng = ServeEngine(tm, num_slots=2, max_len=32, datastore=build_forest_datastore(
        keys, values, stream_capacity=64, device="cpu"))
    jeng = JServeEngine(jm, params, num_slots=2, max_len=32,
                        datastore=jret.build_forest_datastore(keys, values, stream_capacity=64))
    new_keys = (-keys[:12] + 40.0).astype(np.float32)  # far from the main keys
    new_vals = np.full(12, 9, np.int32)
    g = np.random.default_rng(5)
    for rid in range(4):
        prompt = g.integers(0, cfg.vocab_size, 6).astype(np.int32)
        kb, vb = new_keys[rid * 3:(rid + 1) * 3], new_vals[rid * 3:(rid + 1) * 3]
        teng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=4))
        jeng.submit(JRequest(rid=rid, prompt=prompt, max_new_tokens=4))
        assert teng.submit(IngestRequest(rid=100 + rid, keys=kb, values=vb))
        jeng.submit(JIngestRequest(rid=100 + rid, keys=kb, values=vb))
    tdone, jdone = teng.run(), jeng.run()
    assert [(type(r).__name__, r.rid) for r in tdone] == [
        (type(r).__name__, r.rid) for r in jdone]
    for a, b in zip(tdone, jdone):
        if isinstance(a, Request):
            assert a.out_tokens == b.out_tokens
        else:
            assert a.done and a.accepted == b.accepted and not a.error
    assert sum(r.accepted for r in tdone if isinstance(r, IngestRequest)) == 12
    assert int(teng.datastore.delta.count.sum()) == 12
    assert teng.obs.value("serve.ingested_keys") == 12
    assert teng.metrics()["histograms"]["serve.ingest_latency_s"]["count"] == 4
    p = knn_logits(torch.from_numpy(new_keys[:4]), teng.datastore, cfg)
    assert (torch.argmax(p, -1).numpy() == 9).all()


@pytest.fixture(scope="module")
def lm():
    cfg = get_smoke_config("smollm-135m")
    return cfg, Model(cfg, device="cpu", seed=0)


def test_ingest_drain_is_bounded_and_fair(lm):
    """A saturating ingest backlog does not starve a queued query: at most
    ``max_ingest_per_step`` batches apply a step, the deferral is counted,
    and the query retires before the last ingest ack."""
    cfg, model = lm
    keys, values = embedding_datastore(256, cfg.d_model, seed=5)
    ds = build_forest_datastore(keys, values % cfg.vocab_size, stream_capacity=128,
                                device="cpu")
    engine = ServeEngine(model, num_slots=1, max_len=24, datastore=ds, max_ingest_per_step=1)
    new_keys = (-keys[:24] + 40.0).astype(np.float32)
    for i in range(12):
        engine.submit(IngestRequest(rid=100 + i, keys=new_keys[i * 2:(i + 1) * 2],
                                    values=np.full(2, 9, np.int32)))
    assert engine.busy
    g = np.random.default_rng(0)
    q = Request(rid=0, prompt=g.integers(0, cfg.vocab_size, 5).astype(np.int32),
                max_new_tokens=4)
    engine.submit(q)
    finished = engine.run()
    ingests = [r for r in finished if isinstance(r, IngestRequest)]
    assert len(ingests) == 12 and all(r.done for r in ingests)
    assert q.done
    assert finished.index(q) < finished.index(ingests[-1])
    assert engine.obs.value("serve.ingest_deferred") >= 3
    assert sum(r.accepted for r in ingests) == 24
    reg = engine.obs
    assert reg.value("serve.submitted") == reg.value("serve.completed") == 1
    assert not engine.busy


def test_max_ingest_per_step_validated(lm):
    _, model = lm
    with pytest.raises(ValueError, match="max_ingest_per_step"):
        ServeEngine(model, max_ingest_per_step=0)


def test_engine_fails_single_ingest_not_the_run_loop(lm):
    """An insert into a flat datastore fails with an error ack; the decode
    request in flight completes."""
    cfg, model = lm
    keys, values = embedding_datastore(64, cfg.d_model, seed=1)
    ds = build_flat_datastore(keys, values % cfg.vocab_size, device="cpu")
    engine = ServeEngine(model, num_slots=1, max_len=24, datastore=ds)
    g = np.random.default_rng(3)
    engine.submit(Request(rid=0, prompt=g.integers(0, cfg.vocab_size, 4).astype(np.int32),
                          max_new_tokens=3))
    engine.submit(IngestRequest(rid=1, keys=np.zeros((2, cfg.d_model), np.float32),
                                values=np.zeros(2, np.int32)))
    finished = engine.run()
    ing = next(r for r in finished if isinstance(r, IngestRequest))
    dec = next(r for r in finished if isinstance(r, Request))
    assert ing.done and ing.accepted == 0 and ing.error
    assert engine.obs.value("serve.ingest_errors") == 1
    assert len(dec.out_tokens) >= 3
