"""Production serving front of the port: continuous batching, per-request
deadlines with admission control + load shedding — with kNN-LM retrieval
(a flat datastore) fused into every decode step.  The port of the JAX
package's ``repro/serve/engine.py``; it runs eagerly (no ``jit``: each step
launches its kernels, the retrieval kernels K6/K7 among them, directly).

The traffic model:

* **continuous batching** — a fixed decode batch of ``num_slots``;
  finished/expired/empty slots are refilled from the request queue between
  steps.  Per-slot cache positions make mid-flight refill safe: one step
  advances every slot at ITS own position (position-masked attention), so
  a freshly admitted request decodes from its own prompt length while its
  neighbours are deep into generation;
* **deadlines + load shedding** — ``Request.deadline_s`` is a latency
  budget relative to submit.  Admission control rejects at ``submit()``
  when the *projected* queue wait (measured decode-step time x backlog
  work / slots) already exceeds the budget; queued requests whose budget
  expires are shed before they waste a prefill; a mid-flight request whose
  budget expires — or provably cannot be met (``"early"``) — is evicted
  from its slot before the next step.  Every shed is terminal
  (``req.shed``/``req.shed_reason``) and counted under
  ``serve.shed{reason=...}``, and ``submitted == completed + shed +
  in_flight`` holds at every step boundary;
* **query/ingest fairness** — mixed read+write traffic shares the engine;
  ``_drain_ingest`` applies at most ``max_ingest_per_step`` ingest batches
  between decode steps, so a sustained ingest stream cannot starve queued
  queries (each deferral increments ``serve.ingest_deferred``);
* **retrieval** — the datastore is handed to every decode step; an ingest
  replaces it with the datastore ``ingest_keys`` returns, and the next step
  searches that one;
* **telemetry** (``repro_torch.obs``): request and ingest latency
  histograms with serving percentiles, queue-depth / slot-occupancy gauges,
  shed and fairness counters,
  prefill/decode-step span timings — ``engine.metrics()`` snapshots them
  all, and sampled requests emit a linked span tree (queue wait -> prefill
  -> completion root) for ``Trace.reconstruct``.

``run()`` drives the queues to completion; ``step()`` is one scheduler
iteration, for an open-loop driver that interleaves arrivals with service.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from repro_torch.models.model import Cache, Model
from repro_torch.obs import Registry, TraceContext, TraceSampler, use_trace
from repro_torch.serve.retrieval import Datastore, ForestDatastore, ingest_keys

# shed reasons (Request.shed_reason / serve.shed{reason=...} counter labels)
SHED_REJECTED = "rejected"  # admission control refused at submit()
SHED_EXPIRED_QUEUE = "expired_queue"  # deadline passed while waiting in queue
SHED_EXPIRED_FLIGHT = "expired_flight"  # deadline passed while decoding
# speculative early expiry: the deadline has NOT lapsed yet, but the tokens
# still owed x the measured step time already overrun it — shedding now
# returns the slot instead of burning doomed decode steps
SHED_EARLY = "early"


@dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int = 16
    # latency budget in seconds, relative to submit(); None = no deadline
    deadline_s: float | None = None
    out_tokens: list[int] = field(default_factory=list)
    done: bool = False  # completed normally (terminal)
    shed: bool = False  # load-shed (terminal; never set together with done)
    shed_reason: str = ""  # one of the SHED_* constants when shed
    # submit -> terminal state, queue wait included (completed OR shed)
    latency_s: float = 0.0
    # tracing: assigned at submit() by the engine's sampler (or preset)
    trace: TraceContext | None = None
    _t0: float = 0.0  # perf_counter at slot admission
    _t_submit: float = 0.0  # perf_counter at submit
    _t_deadline: float = 0.0  # absolute perf_counter deadline (0 = none)

    @property
    def state(self) -> str:
        """Terminal: ``"done"`` / ``"shed"``; live: ``"running"`` (owns a
        slot) / ``"queued"`` (submitted) / ``"new"`` (never submitted)."""
        if self.shed:
            return "shed"
        if self.done:
            return "done"
        if self._t0 > 0.0:
            return "running"
        return "queued" if self._t_submit > 0.0 else "new"


@dataclass
class IngestRequest:
    """Insert (key, next-token) pairs into the serving datastore's delta.

    Needs a ``ForestDatastore`` built with ``stream_capacity > 0``.
    ``accepted`` reports how many pairs fit the destination buffers (the
    rest were capacity-rejected; clients submit them again later)."""

    rid: int
    keys: np.ndarray  # (B, Dk) f32
    values: np.ndarray  # (B,) i32 token ids
    accepted: int = 0
    done: bool = False
    latency_s: float = 0.0
    error: str = ""  # non-empty when the engine could not ingest at all


class ServeEngine:
    def __init__(
        self,
        model: Model,
        *,
        num_slots: int = 4,
        max_len: int = 256,
        datastore: Datastore | ForestDatastore | None = None,
        registry: Registry | None = None,
        trace_sample: float = 0.0,
        max_ingest_per_step: int = 8,
        step_time_hint_s: float | None = None,
    ):
        self.model = model
        self.device = model.device
        self.num_slots = num_slots
        self.max_len = max_len
        self.datastore = datastore
        self.cache: Cache = model.init_cache(num_slots, max_len)
        self.slot_req: list[Request | None] = [None] * num_slots
        self.slot_pos = np.zeros(num_slots, np.int32)
        self.queue: list[Request] = []
        self.ingest_queue: list[IngestRequest] = []
        self.steps = 0
        # query/ingest fairness: at most this many ingest batches apply per
        # scheduler step, so a saturating write stream cannot starve reads
        if max_ingest_per_step < 1:
            raise ValueError(
                f"max_ingest_per_step={max_ingest_per_step} must be >= 1 "
                "(ingest batches applied between decode steps)"
            )
        self.max_ingest_per_step = max_ingest_per_step
        # admission control's service-time model: median of recent decode
        # step wall times; ``step_time_hint_s`` seeds it for deterministic
        # admission before the first measured step
        self._step_times: deque[float] = deque(maxlen=32)
        if step_time_hint_s is not None:
            self._step_times.append(float(step_time_hint_s))
        self.obs = registry if registry is not None else Registry()
        self._tracer = TraceSampler(trace_sample)

    def metrics(self) -> dict[str, Any]:
        """One snapshot of the engine's registry: ``serve.*`` latency
        histograms (seconds, p50/p95/p99), queue/slot gauges, shed and
        fairness counters, and step/token counters."""
        return self.obs.snapshot()

    @property
    def busy(self) -> bool:
        """True while any work remains (live slots, queued decodes, or an
        ingest backlog)."""
        return (
            any(r is not None for r in self.slot_req)
            or bool(self.queue)
            or bool(self.ingest_queue)
        )

    # --- admission control --------------------------------------------------
    def step_time_s(self) -> float | None:
        """Current decode-step service-time estimate (median of recent
        measured steps), or None before any step ran."""
        if not self._step_times:
            return None
        return float(np.median(self._step_times))

    def projected_wait_s(self) -> float:
        """Projected queue wait for a request submitted now: the tokens still
        owed to live slots plus every queued request's budget, drained
        through ``num_slots`` servers at the measured step time (FCFS).  0.0
        on a cold engine."""
        step_s = self.step_time_s()
        if step_s is None:
            return 0.0
        inflight = sum(
            max(r.max_new_tokens - len(r.out_tokens), 0)
            for r in self.slot_req if r is not None
        )
        queued = sum(r.max_new_tokens for r in self.queue)
        return step_s * (inflight + queued) / self.num_slots

    def _shed(self, req: Request, reason: str, now: float) -> None:
        """Terminal shed: mark, count, observe the wasted wait, and — for a
        sampled request — close its trace tree with a shed root."""
        req.shed = True
        req.shed_reason = reason
        req.latency_s = now - req._t_submit if req._t_submit else 0.0
        self.obs.counter("serve.shed", reason=reason).inc()
        self.obs.emit_trace_root(req.trace, "serve.shed_wait_s", req.latency_s)

    # --- one step over all slots ----------------------------------------------
    def _decode_step(self, tokens: np.ndarray, pos: np.ndarray) -> np.ndarray:
        logits = self.model.decode_step(
            torch.from_numpy(tokens).to(self.device), self.cache,
            torch.from_numpy(pos).to(self.device), datastore=self.datastore,
        )
        return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()

    # --- slot refill: prefill + merge into the slot's cache lane ---------------
    def _prefill_merge(self, prompt: np.ndarray, slot: int) -> int:
        logits, one = self.model.prefill(
            torch.from_numpy(prompt[None, :]).to(self.device), max_len=self.max_len
        )
        for lane, new in zip(self.cache, one):  # batch is axis 0 of every leaf
            for name, leaf in lane.items():
                leaf[slot] = new[name][0]
        return int(torch.argmax(logits[0, -1]))

    # --- slot management ---------------------------------------------------
    def submit(self, req: Request | IngestRequest) -> bool:
        """Enqueue a request.  Returns False when admission control shed a
        decode request on the spot (``req.shed``/``req.shed_reason`` are set;
        the request never enters the queue and is not returned by
        ``run()``/``step()``).  An ``IngestRequest`` always queues."""
        if isinstance(req, IngestRequest):
            self.ingest_queue.append(req)
            return True
        now = time.perf_counter()
        req._t_submit = now
        self.obs.counter("serve.submitted").inc()
        if req.deadline_s is not None:
            req._t_deadline = now + req.deadline_s
            projected = self.projected_wait_s()
            self.obs.gauge("serve.projected_wait_s").set(projected)
            if projected > req.deadline_s:
                self._shed(req, SHED_REJECTED, now)
                return False
        if req.trace is None:
            req.trace = self._tracer.maybe_trace()
        self.queue.append(req)
        return True

    def _drain_ingest(self) -> list[IngestRequest]:
        """Apply queued inserts to the datastore, between decode steps.

        At most ``max_ingest_per_step`` batches a call, so a sustained ingest
        stream yields to queued queries every step (a bounded stop with work
        left counts once under ``serve.ingest_deferred``)."""
        done: list[IngestRequest] = []
        streamable = (
            isinstance(self.datastore, ForestDatastore)
            and self.datastore.delta is not None
        )
        budget = self.max_ingest_per_step
        while self.ingest_queue and budget > 0:
            budget -= 1
            req = self.ingest_queue.pop(0)
            t0 = time.perf_counter()
            if not streamable:
                # fail this request, not the run loop: in-flight decode
                # requests must survive a misdirected insert
                req.accepted = 0
                req.error = "datastore does not accept streaming inserts"
                self.obs.counter("serve.ingest_errors").inc()
            else:
                with self.obs.span("serve.ingest"):
                    self.datastore, n_acc = ingest_keys(
                        self.datastore, np.asarray(req.keys, np.float32),
                        np.asarray(req.values, np.int32),
                    )
                req.accepted = n_acc
                self.obs.counter("serve.ingested_keys").inc(n_acc)
            req.done = True
            req.latency_s = time.perf_counter() - t0
            self.obs.histogram("serve.ingest_latency_s").observe(req.latency_s)
            done.append(req)
        if self.ingest_queue:
            self.obs.counter("serve.ingest_deferred").inc()
        return done

    def _expire_queue(self) -> list[Request]:
        """Shed queued requests whose deadline passed before they reached a
        slot — cheaper than admitting them into a doomed prefill."""
        now = time.perf_counter()
        expired = [r for r in self.queue if r._t_deadline and now > r._t_deadline]
        if expired:
            self.queue = [
                r for r in self.queue if not (r._t_deadline and now > r._t_deadline)
            ]
            for r in expired:
                self._shed(r, SHED_EXPIRED_QUEUE, now)
        return expired

    def _expire_slots(self) -> list[Request]:
        """Evict mid-flight requests whose deadline passed — and,
        speculatively, those that cannot finish in time (tokens still owed x
        measured step time overrun the budget: reason ``"early"``).  Partial
        ``out_tokens`` stay on the request."""
        now = time.perf_counter()
        step_s = self.step_time_s()
        evicted: list[Request] = []
        for s in range(self.num_slots):
            req = self.slot_req[s]
            if req is None or not req._t_deadline:
                continue
            if now > req._t_deadline:
                self._shed(req, SHED_EXPIRED_FLIGHT, now)
            elif step_s is not None:
                remaining = min(
                    req.max_new_tokens - len(req.out_tokens),
                    self.max_len - 1 - int(self.slot_pos[s]),
                )
                if now + remaining * step_s <= req._t_deadline:
                    continue
                self._shed(req, SHED_EARLY, now)
            else:
                continue
            self.slot_req[s] = None
            self.slot_pos[s] = 0
            evicted.append(req)
        return evicted

    def _fill_slots(self) -> None:
        for slot in range(self.num_slots):
            if self.slot_req[slot] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            req._t0 = time.perf_counter()
            with use_trace(req.trace):
                self.obs.record_span("serve.queue_wait", req._t0 - req._t_submit)
                with self.obs.span("serve.prefill"):
                    # int() of the first token waits for the device: the
                    # refill's real wall time
                    first = self._prefill_merge(np.asarray(req.prompt, np.int32), slot)
            req.out_tokens.append(first)
            self.slot_req[slot] = req
            self.slot_pos[slot] = len(req.prompt)

    # --- scheduler ----------------------------------------------------------
    def step(self) -> list[Request | IngestRequest]:
        """One scheduler iteration: bounded ingest drain -> queue/slot
        deadline expiry -> slot refill (continuous batching) -> one batched
        decode step -> retire.  Returns every request that reached a
        terminal state during the iteration (completed and shed decodes,
        ingest acks)."""
        finished: list[Request | IngestRequest] = []
        finished.extend(self._drain_ingest())
        finished.extend(self._expire_queue())
        finished.extend(self._expire_slots())
        self._fill_slots()
        live = [s for s in range(self.num_slots) if self.slot_req[s] is not None]
        self.obs.gauge("serve.queue_depth").set(len(self.queue))
        self.obs.gauge("serve.ingest_queue_depth").set(len(self.ingest_queue))
        self.obs.gauge("serve.slot_occupancy").set(len(live) / self.num_slots)
        if not live:
            return finished
        # per-slot positions: a refilled slot keeps decoding at ITS cache
        # position; empty slots step at their stale position, ignored
        tokens = np.zeros((self.num_slots, 1), np.int32)
        for s in live:
            tokens[s, 0] = self.slot_req[s].out_tokens[-1]
        t_step = time.perf_counter()
        with self.obs.span("serve.decode_step"):
            nxt = self._decode_step(tokens, self.slot_pos)  # host copy: waits
        self._step_times.append(time.perf_counter() - t_step)
        self.steps += 1
        self.obs.counter("serve.steps").inc()
        self.obs.counter("serve.tokens").inc(len(live))
        for s in live:
            req = self.slot_req[s]
            req.out_tokens.append(int(nxt[s]))
            self.slot_pos[s] += 1
            if len(req.out_tokens) >= req.max_new_tokens \
                    or self.slot_pos[s] >= self.max_len - 1:
                req.done = True
                self.obs.counter("serve.completed").inc()
                req.latency_s = time.perf_counter() - req._t_submit
                self.obs.emit_trace_root(
                    req.trace, "serve.request_latency_s", req.latency_s
                )
                finished.append(req)
                self.slot_req[s] = None
                self.slot_pos[s] = 0
        return finished

    def run(self, *, max_steps: int = 10_000) -> list[Request | IngestRequest]:
        """Process the queues to completion; returns finished requests
        (completed and shed decodes, ingest acks, in completion order).
        ``max_steps`` bounds decode steps; an ingest backlog always drains."""
        finished: list[Request | IngestRequest] = []
        while self.busy and self.steps < max_steps:
            finished.extend(self.step())
        return finished
