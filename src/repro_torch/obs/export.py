"""Metrics export surface: Prometheus text rendering + the events CLI (the
port's own copy of the JAX package's ``repro/obs/export.py``).

``render_prometheus(snapshot)`` turns a ``Registry.snapshot()`` dict into
the Prometheus text exposition format — counters and gauges verbatim,
histograms as summaries (``{quantile="0.5"}`` samples plus ``_sum`` /
``_count`` / ``_min`` / ``_max``).  Metric names sanitize dots and span
slashes to underscores (``search/plan_lookup`` -> ``search_plan_lookup``);
label values are quoted and escaped.  ``parse_prometheus`` is the inverse
reader the ``--check`` gate round-trips through — rendering that does not
parse is a bug worth failing CI over.

The CLI summarizes runs:

    python -m repro_torch.obs.export --events obs.jsonl            # span table
    python -m repro_torch.obs.export --events obs.jsonl --format prometheus
    python -m repro_torch.obs.export --events obs.jsonl --check    # CI gate
    python -m repro_torch.obs.export --events obs.jsonl --traces   # list ids
    python -m repro_torch.obs.export --events obs.jsonl --trace ID # one tree
    python -m repro_torch.obs.export --snapshot metrics.json --format prometheus

``--events`` reads a span JSONL (rotations included), aggregates every
span path into a latency histogram, and prints a per-span table
(count / total / mean / p50 / p95 / p99 / max).  ``--snapshot`` renders a
saved ``Registry.snapshot()`` (or an ``OverlapIndex.metrics()`` dump — its
``registry`` section is detected) without needing the live process.
"""
from __future__ import annotations

import argparse
import json
import math
import re
import sys
from typing import Any, Iterable

from repro_torch.obs.events import EventLog, events_path_from_env

__all__ = [
    "render_prometheus",
    "parse_prometheus",
    "span_table",
    "render_span_table",
    "main",
]

_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")
_SAMPLE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^{}]*)\})?"
    r"\s+(?P<value>[^\s]+)$"
)
_LABEL = re.compile(r'^(?P<k>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<v>(?:[^"\\]|\\.)*)"$')

_QUANTILES = (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99"))


def _sanitize(name: str) -> str:
    name = _NAME_OK.sub("_", name)
    if not name or not re.match(r"[a-zA-Z_:]", name[0]):
        name = "_" + name
    return name


def _split_key(key: str) -> tuple[str, dict[str, str]]:
    """Invert ``metrics._fmt``: ``name{k=v,...}`` -> (name, labels)."""
    if "{" not in key:
        return key, {}
    name, _, rest = key.partition("{")
    labels: dict[str, str] = {}
    for part in rest.rstrip("}").split(","):
        if part:
            k, _, v = part.partition("=")
            labels[k] = v
    return name, labels


def _esc(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"')


def _fmt_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{_sanitize(k)}="{_esc(str(v))}"' for k, v in labels.items())
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if isinstance(v, float) and math.isnan(v):
        return "NaN"
    if isinstance(v, float) and math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v)) if isinstance(v, float) else str(v)


def render_prometheus(snapshot: dict[str, Any]) -> str:
    """``Registry.snapshot()`` -> Prometheus text format (see module doc)."""
    lines: list[str] = []
    for key, val in snapshot.get("counters", {}).items():
        name, labels = _split_key(key)
        pname = _sanitize(name)
        lines.append(f"# TYPE {pname} counter")
        lines.append(f"{pname}{_fmt_labels(labels)} {_fmt_value(val)}")
    for key, val in snapshot.get("gauges", {}).items():
        name, labels = _split_key(key)
        pname = _sanitize(name)
        lines.append(f"# TYPE {pname} gauge")
        lines.append(f"{pname}{_fmt_labels(labels)} {_fmt_value(val)}")
    for key, h in snapshot.get("histograms", {}).items():
        name, labels = _split_key(key)
        pname = _sanitize(name)
        lines.append(f"# TYPE {pname} summary")
        for q, field in _QUANTILES:
            qlabels = {**labels, "quantile": q}
            lines.append(
                f"{pname}{_fmt_labels(qlabels)} {_fmt_value(h[field])}"
            )
        lines.append(f"{pname}_sum{_fmt_labels(labels)} {_fmt_value(h['sum'])}")
        lines.append(
            f"{pname}_count{_fmt_labels(labels)} {_fmt_value(h['count'])}"
        )
        lines.append(f"{pname}_min{_fmt_labels(labels)} {_fmt_value(h['min'])}")
        lines.append(f"{pname}_max{_fmt_labels(labels)} {_fmt_value(h['max'])}")
    return "\n".join(lines) + ("\n" if lines else "")


def parse_prometheus(text: str) -> list[dict[str, Any]]:
    """Parse text-format samples back into ``{name, labels, value}`` dicts.

    Raises ``ValueError`` naming the offending line on anything malformed —
    this is the ``--check`` gate's teeth, not a lenient scraper."""
    samples: list[dict[str, Any]] = []
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: not a metric sample: {line!r}")
        labels: dict[str, str] = {}
        raw = m.group("labels")
        if raw:
            for part in _split_label_pairs(raw, lineno):
                lm = _LABEL.match(part)
                if lm is None:
                    raise ValueError(
                        f"line {lineno}: bad label pair {part!r} in {line!r}"
                    )
                labels[lm.group("k")] = lm.group("v")
        try:
            value = float(m.group("value"))
        except ValueError as e:
            raise ValueError(
                f"line {lineno}: bad value {m.group('value')!r}"
            ) from e
        samples.append(
            {"name": m.group("name"), "labels": labels, "value": value}
        )
    return samples


def _split_label_pairs(raw: str, lineno: int) -> Iterable[str]:
    """Split ``k1="v1",k2="v2"`` at commas outside quotes."""
    out, buf, in_q, esc = [], [], False, False
    for ch in raw:
        if esc:
            buf.append(ch)
            esc = False
        elif ch == "\\":
            buf.append(ch)
            esc = True
        elif ch == '"':
            buf.append(ch)
            in_q = not in_q
        elif ch == "," and not in_q:
            out.append("".join(buf))
            buf = []
        else:
            buf.append(ch)
    if in_q:
        raise ValueError(f"line {lineno}: unterminated label value in {raw!r}")
    if buf:
        out.append("".join(buf))
    return out


# ---------------------------------------------------------------------------
# events JSONL -> per-span latency table
# ---------------------------------------------------------------------------


def span_table(records: list[dict[str, Any]]) -> dict[str, dict[str, float]]:
    """Aggregate span events into per-path latency summaries (sorted by
    total time descending — where the run went)."""
    from repro_torch.obs.metrics import Histogram

    hists: dict[str, Histogram] = {}
    for r in records:
        if r.get("event") != "span":
            continue
        h = hists.get(r["span"])
        if h is None:
            h = hists[r["span"]] = Histogram()
        h.observe(float(r.get("dur_s", 0.0)))
    table = {name: h.snapshot() for name, h in hists.items()}
    return dict(
        sorted(table.items(), key=lambda kv: kv[1]["sum"], reverse=True)
    )


def render_span_table(table: dict[str, dict[str, float]]) -> str:
    if not table:
        return "(no span events)"
    width = max(len(n) for n in table)
    head = (f"{'span':<{width}}  {'count':>7}  {'total_s':>9}  {'mean_ms':>9}  "
            f"{'p50_ms':>9}  {'p95_ms':>9}  {'p99_ms':>9}  {'max_ms':>9}")
    lines = [head, "-" * len(head)]
    for name, s in table.items():
        lines.append(
            f"{name:<{width}}  {s['count']:>7d}  {s['sum']:>9.4f}  "
            f"{s['mean'] * 1e3:>9.3f}  {s['p50'] * 1e3:>9.3f}  "
            f"{s['p95'] * 1e3:>9.3f}  {s['p99'] * 1e3:>9.3f}  "
            f"{s['max'] * 1e3:>9.3f}"
        )
    return "\n".join(lines)


def _snapshot_from_events(records: list[dict[str, Any]]) -> dict[str, Any]:
    """A synthetic registry snapshot aggregated from span events, so
    ``--events --format prometheus`` works without the live registry."""
    return {
        "enabled": True,
        "counters": {},
        "gauges": {},
        "histograms": span_table(records),
    }


def _load_snapshot(path: str) -> dict[str, Any]:
    with open(path) as f:
        d = json.load(f)
    if "registry" in d and isinstance(d["registry"], dict):
        d = d["registry"]  # an OverlapIndex.metrics() dump
    if "histograms" not in d and "counters" not in d:
        raise ValueError(
            f"{path} is not a Registry.snapshot() (or metrics()) JSON dump"
        )
    return d


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.export",
        description="Summarize/export repro_torch.obs telemetry "
        "(span tables, Prometheus text format, trace trees).",
    )
    ap.add_argument(
        "--events",
        help="span/event JSONL (rotations included); defaults to "
        "$REPRO_OBS_EVENTS when set — the same variable the writers honor, "
        "so CI can gate the log it just produced without re-plumbing paths",
    )
    ap.add_argument(
        "--snapshot", help="Registry.snapshot() or OverlapIndex.metrics() JSON"
    )
    ap.add_argument(
        "--format", choices=("table", "prometheus", "json"), default="table"
    )
    ap.add_argument(
        "--check", action="store_true",
        help="render Prometheus output and round-trip it through the "
        "parser; exit non-zero on any malformed sample (CI gate)",
    )
    ap.add_argument("--traces", action="store_true", help="list trace ids")
    ap.add_argument("--trace", help="render one reconstructed trace tree")
    args = ap.parse_args(argv)

    if not args.events:
        args.events = events_path_from_env()
    if not args.events and not args.snapshot:
        ap.error("need --events and/or --snapshot")
    if (args.traces or args.trace) and not args.events:
        ap.error("--traces/--trace need --events")

    records: list[dict[str, Any]] = []
    if args.events:
        records = EventLog.read(args.events)

    if args.traces:
        from repro_torch.obs.trace import Trace

        for tid in Trace.trace_ids(args.events):
            print(tid)
        return 0
    if args.trace:
        from repro_torch.obs.trace import Trace

        t = Trace.reconstruct(args.events, args.trace)
        if not t.records:
            print(f"trace {args.trace!r} not found in {args.events}",
                  file=sys.stderr)
            return 1
        print(t.render())
        return 0

    snap = (
        _load_snapshot(args.snapshot)
        if args.snapshot
        else _snapshot_from_events(records)
    )

    if args.check:
        text = render_prometheus(snap)
        try:
            samples = parse_prometheus(text)
        except ValueError as e:
            print(f"prometheus rendering FAILED to parse: {e}", file=sys.stderr)
            return 1
        print(f"prometheus render OK ({len(samples)} samples"
              f"{f', {len(records)} events' if args.events else ''})")
        if args.events:
            print(render_span_table(span_table(records)))
        return 0

    if args.format == "prometheus":
        sys.stdout.write(render_prometheus(snap))
    elif args.format == "json":
        print(json.dumps(snap, indent=2, sort_keys=True))
    else:
        if args.events:
            print(render_span_table(span_table(records)))
        else:
            print(json.dumps(snap, indent=2, sort_keys=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
