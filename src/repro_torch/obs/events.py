"""Toggleable JSONL event emitter — the registry's wire format (the port's
own copy of ``repro/obs/events.py``).

One ``EventLog`` appends one JSON object per line to a file; ``Registry``
span exits (obs/metrics.py) and any caller with something structured to
say (``emit`` takes an arbitrary JSON-serializable dict) share it.  Lines
are self-contained — each carries a wall-clock ``ts`` — so logs from
several processes concatenate and sort cleanly.

Off by default: nothing opens a file unless an ``events_path`` is
configured (an ``EventLog`` handed to a ``Registry``, or the
``REPRO_OBS_EVENTS`` environment variable), so the metrics layer stays filesystem-free in the
common case.

Rotation: append mode means restarts accumulate — which is the point for
debugging, and a disk-filling liability for a long-lived server.  With
``max_bytes`` set, an emit that would push the current file past the limit
first shifts ``path -> path.1 -> path.2 -> ... -> path.N`` (``backups``
deep; the oldest falls off) and starts a fresh file, logrotate-style.
``EventLog.read`` transparently spans the rotation set oldest-first, so
readers (``Trace.reconstruct``, the export CLI) see one continuous stream.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any

__all__ = ["EventLog", "events_path_from_env"]

ENV_VAR = "REPRO_OBS_EVENTS"


def events_path_from_env() -> str | None:
    """The ambient JSONL destination, if any (empty string means off)."""
    return os.environ.get(ENV_VAR) or None


class EventLog:
    """Append-only JSONL writer with line-level durability.

    ``emit`` stamps ``ts`` (unix seconds) and writes exactly one line per
    event, flushing by default so a crash mid-run loses at most the event
    being written — these logs exist to debug exactly such runs.

    ``max_bytes=None`` (default) never rotates; otherwise a file is capped
    near ``max_bytes`` (a single event always lands whole in one file, so
    the cap is exceeded only by the final line's length) and up to
    ``backups`` rotated predecessors are kept as ``path.1 .. path.N``.
    """

    def __init__(
        self,
        path: str,
        *,
        flush: bool = True,
        max_bytes: int | None = None,
        backups: int = 3,
    ) -> None:
        if max_bytes is not None and max_bytes < 1:
            raise ValueError(f"EventLog max_bytes={max_bytes} must be >= 1")
        if backups < 0:
            raise ValueError(f"EventLog backups={backups} must be >= 0")
        self.path = str(path)
        self._flush = flush
        self.max_bytes = max_bytes
        self.backups = backups
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._f = open(self.path, "a")
        self._size = os.path.getsize(self.path)

    def emit(self, event: dict[str, Any]) -> None:
        rec = {"ts": time.time(), **event}
        line = json.dumps(rec, sort_keys=True) + "\n"
        if (
            self.max_bytes is not None
            and self._size > 0
            and self._size + len(line) > self.max_bytes
        ):
            self._rotate()
        self._f.write(line)
        self._size += len(line)
        if self._flush:
            self._f.flush()

    def _rotate(self) -> None:
        """Shift the rotation chain and start a fresh current file."""
        self._f.close()
        if self.backups == 0:
            # no history requested: truncate in place
            self._f = open(self.path, "w")
            self._size = 0
            return
        oldest = f"{self.path}.{self.backups}"
        if os.path.exists(oldest):
            os.remove(oldest)
        for n in range(self.backups - 1, 0, -1):
            src = f"{self.path}.{n}"
            if os.path.exists(src):
                os.replace(src, f"{self.path}.{n + 1}")
        os.replace(self.path, f"{self.path}.1")
        self._f = open(self.path, "a")
        self._size = 0

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self) -> "EventLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self) -> None:  # best-effort: drop the fd with the object
        try:
            self.close()
        except Exception:
            pass

    @staticmethod
    def rotated_paths(path: str) -> list[str]:
        """Existing files of the rotation set, OLDEST first (``path.N`` down
        to ``path.1``, then ``path`` itself)."""
        out: list[str] = []
        n = 1
        while os.path.exists(f"{path}.{n}"):
            n += 1
        for i in range(n - 1, 0, -1):
            out.append(f"{path}.{i}")
        if os.path.exists(path):
            out.append(path)
        return out

    @staticmethod
    def read(path: str) -> list[dict[str, Any]]:
        """Parse a JSONL event stream back into dicts — spanning the whole
        rotation set (``path.N .. path.1`` then ``path``), oldest first, so
        a rotated log reads as one continuous stream.

        Skips blank lines; raises on malformed JSON — a corrupt event log
        should fail loudly in tooling, not silently truncate."""
        out: list[dict[str, Any]] = []
        files = EventLog.rotated_paths(path) or [path]
        for fp in files:
            with open(fp) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        out.append(json.loads(line))
        return out
