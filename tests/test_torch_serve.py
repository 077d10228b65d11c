"""kNN-LM serving of the port (``repro_torch.serve``) against the JAX package.

* ``knn_logits`` / ``knn_interpolate`` on flat f32 and int8 datastores, on
  the same numpy keys and hidden states: to 1e-6 / 1e-5 where the distance
  expansion is exact (keys on a grid), and at the scale of
  ``tests/test_retrieval_serving.py`` to the band its f32 rounding allows
  (stated in the test);
* the engine: the port's ``ServeEngine`` gives the JAX engine's tokens for
  the same prompts and weights (f32 compute, retrieval on), a 2-slot engine
  a 1-slot engine's tokens;
* the serving front's invariants as ``tests/test_serve_front.py`` states
  them, on the port's engine.  ``step_time_hint_s`` makes the admission
  decisions the same on every run.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import RetrievalConfig as JRetrievalConfig
from repro.data.synthetic import embedding_datastore as j_embedding_datastore
from repro.models.model import Model as JModel
from repro.serve import retrieval as jret
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import RetrievalConfig
from repro_torch.data.synthetic import embedding_datastore
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model
from repro_torch.serve.engine import (
    SHED_EARLY,
    SHED_EXPIRED_FLIGHT,
    SHED_EXPIRED_QUEUE,
    SHED_REJECTED,
    IngestRequest,
    Request,
    ServeEngine,
)
from repro_torch.serve.retrieval import build_flat_datastore, knn_interpolate, knn_logits

TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _retrieval(**kw):
    base = dict(enabled=True, k=4, lam=0.5, temperature=1.0, datastore_size=512)
    base.update(kw)
    return RetrievalConfig(**base), JRetrievalConfig(**base)


@pytest.fixture(scope="module")
def cfgs():
    tr, jr = _retrieval()
    return (get_smoke_config("qwen2-0.5b").replace(retrieval=tr),
            j_smoke("qwen2-0.5b").replace(retrieval=jr))


def test_embedding_datastore_is_the_jax_packages():
    k, v = embedding_datastore(300, 16, seed=4)
    jk, jv = j_embedding_datastore(300, 16, seed=4)
    np.testing.assert_array_equal(k, jk)
    np.testing.assert_array_equal(v, jv)


def _exact_datastore(n, d, seed):
    """Keys on a 1/64 grid with one element of +-127/64 per row: the int8
    scale is exactly 1/64, the dequantized rows equal the f32 rows, and every
    product and partial sum of the expansion is exact in f32, so the port and
    the JAX package compute the same distances bit for bit."""
    g = np.random.default_rng(seed)
    ints = g.integers(-127, 128, size=(n, d))
    ints[np.arange(n), g.integers(0, d, n)] = 127
    keys = (ints / 64).astype(np.float32)
    hidden = ((ints[: n // 2] + g.integers(-3, 4, size=(n // 2, d))) / 64).astype(np.float32)
    return keys, g.integers(0, 256, n).astype(np.int32), hidden


@pytest.mark.parametrize("quantized", [False, True])
def test_knn_logits_match(cfgs, quantized):
    """Exact distances (``_exact_datastore``): p_knn equal to the JAX
    package's up to the softmax's own rounding (1e-6)."""
    cfg, jcfg = cfgs
    keys, values, hidden = _exact_datastore(96, cfg.d_model, seed=0)
    ds = build_flat_datastore(keys, values, quantized=quantized, device="cpu")
    jds = jret.build_flat_datastore(keys, values, quantized=quantized)
    if quantized:
        np.testing.assert_array_equal(ds.keys.numpy(), np.asarray(jds.keys))
        np.testing.assert_array_equal(ds.scale.numpy(), 1 / 64)
    p = knn_logits(_t(hidden), ds, cfg)
    jp = np.asarray(jret.knn_logits(jnp.asarray(hidden), jds, jcfg))
    assert p.shape == (len(hidden), cfg.padded_vocab)
    np.testing.assert_allclose(p.numpy(), jp, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(p.sum(-1).numpy(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("quantized", [False, True])
def test_knn_logits_match_at_embedding_scale(cfgs, quantized):
    """The case of ``tests/test_retrieval_serving.py``: keys ~ N(0, 4^2) per
    feature, queries 0.01 from a key.  The expansion's f32 rounding is a few
    ulp of ||q||^2 + ||x||^2 ~ 10^3, i.e. ~1e-4 absolute in d2 against a
    nearest d2 of ~6e-3, so the weights exp(-sqrt(d2)/T) of the two packages
    differ by up to ~1e-3; the neighbours are the same."""
    cfg, jcfg = cfgs
    keys, values = embedding_datastore(512, cfg.d_model, seed=0)
    values = values % cfg.vocab_size
    hidden = keys[:6] + 0.01 * np.random.default_rng(0).normal(size=(6, cfg.d_model))
    hidden = hidden.astype(np.float32)
    ds = build_flat_datastore(keys, values, quantized=quantized, device="cpu")
    jds = jret.build_flat_datastore(keys, values, quantized=quantized)
    p = knn_logits(_t(hidden), ds, cfg)
    jp = np.asarray(jret.knn_logits(jnp.asarray(hidden), jds, jcfg))
    np.testing.assert_array_equal(p.numpy() > 0, jp > 0)
    np.testing.assert_allclose(p.numpy(), jp, rtol=0, atol=2e-3)
    assert (p.argmax(-1).numpy() == values[:6]).mean() >= 0.5


@pytest.mark.parametrize("quantized", [False, True])
def test_knn_interpolate_match(cfgs, quantized):
    cfg, jcfg = cfgs
    rng = np.random.default_rng(11)
    keys, values, hidden = _exact_datastore(64, cfg.d_model, seed=1)
    ds = build_flat_datastore(keys, values, quantized=quantized, device="cpu")
    jds = jret.build_flat_datastore(keys, values, quantized=quantized)
    logits = rng.normal(size=(len(hidden), cfg.padded_vocab)).astype(np.float32)
    out = knn_interpolate(_t(logits), _t(hidden), ds, cfg)
    jout = np.asarray(jret.knn_interpolate(jnp.asarray(logits), jnp.asarray(hidden), jds, jcfg))
    np.testing.assert_allclose(out.numpy(), jout, rtol=TOL, atol=TOL)
    # lam = 0 is the LM distribution
    tr0, _ = _retrieval(lam=0.0)
    out0 = knn_interpolate(_t(logits), _t(hidden), ds, cfg.replace(retrieval=tr0))
    np.testing.assert_allclose(out0.numpy(), torch.log_softmax(_t(logits), -1).numpy(),
                               atol=5e-6)


def test_duplicate_tokens_accumulate():
    """Neighbours with one token add their weights (``.at[].add``), and an
    id of -1 past a datastore of fewer than k rows adds weight 0."""
    tr, _ = _retrieval(k=4)
    cfg = get_smoke_config("smollm-135m").replace(retrieval=tr)
    g = np.random.default_rng(2)
    keys = g.normal(size=(3, cfg.d_model)).astype(np.float32)
    for quantized in (False, True):
        ds = build_flat_datastore(keys, np.array([7, 7, 9], np.int32), quantized=quantized,
                                  device="cpu")
        p = knn_logits(_t(keys[:2]), ds, cfg)
        w = p[:, 7] + p[:, 9]
        np.testing.assert_allclose(w.numpy(), 1.0, rtol=1e-6)
        assert (p[:, 7] > 0.5).all()  # two of three neighbours carry token 7
        assert int((p > 0).sum()) == 4  # tokens 7 and 9 on each row, nothing else


# --------------------------------------------------------------------------
# the engine against the JAX engine
# --------------------------------------------------------------------------

PROMPT_LENS = [5, 9, 5, 9, 12]


def _prompts(vocab):
    g = np.random.default_rng(3)
    return [g.integers(0, vocab, n).astype(np.int32) for n in PROMPT_LENS]


@pytest.fixture(scope="module")
def served():
    """A JAX smoke model with f32 compute and retrieval on, and the port's
    model and datastore holding the same weights and keys."""
    tr, jr = _retrieval(k=4, lam=0.25, temperature=10.0)
    cfg = get_smoke_config("qwen2-0.5b").replace(compute_dtype="float32", retrieval=tr)
    jcfg = j_smoke("qwen2-0.5b").replace(compute_dtype="float32", retrieval=jr)
    jm = JModel(jcfg)
    params = jm.init(jax.random.key(5))
    tm = params_from_jax(jax.tree.map(np.asarray, params), cfg, device="cpu")
    keys, values = embedding_datastore(384, cfg.d_model, seed=7)
    values = values % cfg.vocab_size
    return cfg, jm, params, tm, keys, values


@pytest.mark.parametrize("quantized", [False, True])
def test_engine_tokens_match_the_jax_engine(served, quantized):
    cfg, jm, params, tm, keys, values = served
    prompts = _prompts(cfg.vocab_size)
    jeng = JServeEngine(jm, params, num_slots=2, max_len=32,
                        datastore=jret.build_flat_datastore(keys, values, quantized=quantized))
    teng = ServeEngine(tm, num_slots=2, max_len=32,
                       datastore=build_flat_datastore(keys, values, quantized=quantized,
                                                      device="cpu"))
    for rid, p in enumerate(prompts):
        jeng.submit(JRequest(rid=rid, prompt=p, max_new_tokens=6))
        teng.submit(Request(rid=rid, prompt=p, max_new_tokens=6))
    jout = {r.rid: r.out_tokens for r in jeng.run()}
    tout = {r.rid: r.out_tokens for r in teng.run()}
    assert tout == jout
    assert teng.steps == jeng.steps


def test_two_slots_give_one_slots_tokens():
    """Continuous batching with mid-flight refills at other positions does
    not change any request's greedy tokens (default bf16 compute)."""
    tr, _ = _retrieval(k=4, lam=0.25, temperature=10.0)
    cfg = get_smoke_config("smollm-135m").replace(retrieval=tr)
    model = Model(cfg, device="cpu", seed=4)
    keys, values = embedding_datastore(256, cfg.d_model, seed=3)
    ds = build_flat_datastore(keys, values % cfg.vocab_size, device="cpu")
    prompts = _prompts(cfg.vocab_size)
    out = {}
    for slots in (1, 2):
        eng = ServeEngine(model, num_slots=slots, max_len=32, datastore=ds)
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=p, max_new_tokens=5))
        out[slots] = {r.rid: r.out_tokens for r in eng.run()}
        assert all(len(t) == 5 for t in out[slots].values())
    assert out[2] == out[1]


def test_engine_refuses_ingest():
    cfg = get_smoke_config("smollm-135m")
    eng = ServeEngine(Model(cfg, device="cpu"), num_slots=1, max_len=16)
    with pytest.raises(NotImplementedError, match="streaming slice"):
        eng.submit(IngestRequest(rid=0, keys=np.zeros((2, cfg.d_model), np.float32),
                                 values=np.zeros(2, np.int32)))
    assert eng.obs.value("serve.submitted") == 0 and not eng.busy


# --------------------------------------------------------------------------
# the serving front (tests/test_serve_front.py on the port's engine)
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lm():
    cfg = get_smoke_config("smollm-135m")
    return cfg, Model(cfg, device="cpu", seed=0)


def _req(cfg, rid, *, tokens=4, deadline=None, seed=0):
    g = np.random.default_rng(seed + rid)
    return Request(rid=rid, prompt=g.integers(0, cfg.vocab_size, 5).astype(np.int32),
                   max_new_tokens=tokens, deadline_s=deadline)


def _shed_total(reg):
    return sum(reg.value("serve.shed", reason=r)
               for r in (SHED_REJECTED, SHED_EXPIRED_QUEUE, SHED_EXPIRED_FLIGHT, SHED_EARLY))


def _assert_conserved(engine):
    """submitted == completed + shed + in-flight, at any step boundary."""
    reg = engine.obs
    in_flight = len(engine.queue) + sum(1 for r in engine.slot_req if r is not None)
    assert reg.value("serve.submitted") == (
        reg.value("serve.completed") + _shed_total(reg) + in_flight)


def test_reject_on_submit_accounting(lm):
    cfg, model = lm
    engine = ServeEngine(model, num_slots=1, max_len=24, step_time_hint_s=10.0)
    a = _req(cfg, 0, tokens=3)
    b = _req(cfg, 1, tokens=3, deadline=0.5)
    assert engine.submit(a) is True
    assert engine.submit(b) is False  # projected 30 s >> 0.5 s budget
    assert b.shed and b.shed_reason == SHED_REJECTED and b.state == "shed"
    assert not b.done and b.out_tokens == []
    assert engine.obs.value("serve.shed", reason=SHED_REJECTED) == 1
    _assert_conserved(engine)
    assert engine.run() == [a] and a.done and len(a.out_tokens) >= 3
    _assert_conserved(engine)
    assert engine.metrics()["gauges"]["serve.projected_wait_s"] > 0.5


def test_deadline_expires_while_queued(lm):
    cfg, model = lm
    engine = ServeEngine(model, num_slots=1, max_len=24)
    a = _req(cfg, 0, tokens=4)
    b = _req(cfg, 1, tokens=4, deadline=1e-3)  # cold engine admits it
    assert engine.submit(a) and engine.submit(b)
    time.sleep(5e-3)
    finished = engine.run()
    assert set(map(id, finished)) == {id(a), id(b)}
    assert a.done and b.shed and b.shed_reason == SHED_EXPIRED_QUEUE
    assert b.out_tokens == [] and b.latency_s >= 1e-3
    _assert_conserved(engine)


def test_deadline_expires_mid_flight(lm):
    """A request that cannot finish in its budget is evicted mid-flight
    (``early`` once the measured step time says so, else
    ``expired_flight``), its partial tokens kept and its slot freed."""
    cfg, model = lm
    engine = ServeEngine(model, num_slots=1, max_len=128)
    engine.submit(_req(cfg, 99, tokens=2))  # warm: measured step times
    engine.run()
    r = _req(cfg, 0, tokens=10_000, deadline=0.05)
    assert engine.submit(r) is True
    assert engine.run() == [r]
    assert r.shed and r.shed_reason in (SHED_EXPIRED_FLIGHT, SHED_EARLY) and not r.done
    assert 1 <= len(r.out_tokens) < 10_000
    assert all(s is None for s in engine.slot_req)
    _assert_conserved(engine)


def test_speculative_early_expiry(lm):
    cfg, model = lm
    engine = ServeEngine(model, num_slots=1, max_len=64, step_time_hint_s=10.0)
    r = _req(cfg, 0, tokens=50, deadline=5.0)
    t0 = time.perf_counter()
    assert engine.submit(r) is True
    assert engine.run() == [r]
    assert r.shed and r.shed_reason == SHED_EARLY and r.state == "shed"
    assert time.perf_counter() - t0 < 5.0 and len(r.out_tokens) < 50
    assert engine.obs.value("serve.shed", reason=SHED_EARLY) == 1
    _assert_conserved(engine)


def test_conservation_holds_mid_run(lm):
    cfg, model = lm
    engine = ServeEngine(model, num_slots=1, max_len=24)
    for i in range(3):
        engine.submit(_req(cfg, i, tokens=3))
    _assert_conserved(engine)
    seen = []
    while engine.busy:
        seen.extend(engine.step())
        _assert_conserved(engine)
    assert engine.obs.value("serve.completed") == 3 and _shed_total(engine.obs) == 0
    assert [r.rid for r in seen] == [0, 1, 2]  # FCFS through one slot


def test_shed_requests_stay_out_of_latency_percentiles(lm):
    cfg, model = lm
    engine = ServeEngine(model, num_slots=1, max_len=24, step_time_hint_s=10.0)
    engine.submit(_req(cfg, 0, tokens=3))
    engine.submit(_req(cfg, 1, tokens=3, deadline=0.1))  # rejected
    engine.run()
    hists = engine.metrics()["histograms"]
    assert hists["serve.request_latency_s"]["count"] == 1
    assert hists["serve.shed_wait_s"]["count"] == 1


def test_no_deadline_requests_never_shed(lm):
    cfg, model = lm
    engine = ServeEngine(model, num_slots=1, max_len=24, step_time_hint_s=100.0)
    reqs = [_req(cfg, i, tokens=2) for i in range(3)]
    assert all(engine.submit(r) for r in reqs)
    assert len(engine.run()) == 3 and all(r.done and not r.shed for r in reqs)
    assert _shed_total(engine.obs) == 0


def test_step_time_estimate_updates_from_measurement(lm):
    cfg, model = lm
    engine = ServeEngine(model, num_slots=1, max_len=24, step_time_hint_s=50.0)
    assert engine.step_time_s() == 50.0
    engine.submit(_req(cfg, 0, tokens=6))
    engine.run()
    assert engine.step_time_s() < 50.0
