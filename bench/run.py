"""Run one cell of the benchmark once and print its result as the last line of
standard output.

    python3 bench/run.py --workload ward-vbm.b16k-k10 --seed 7 --seconds 10 --trace 0

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (the same window, then a profiled stretch).  The numbers
that decide ``correct`` are printed beside their limits as the last lines of
standard error and under ``checks``, the result's last key.  Exits 3 without a
result where no card (or too few) is found, and 4 where JAX or the JAX package
was loaded.  Run from the root of a checkout; the port's kernels are built
under the checkout on first use.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".bench_cache"


def _environment() -> None:
    """Fixed cache directories inside the checkout, and no event log."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
    os.environ.pop("REPRO_OBS_EVENTS", None)
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    from bench import harness

    try:
        result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                                  bool(args.trace), t_start=T_START)
    except harness.NoDevice as e:
        print(f"no result: {e}", file=sys.stderr)
        return 3
    found = harness.forbidden_modules()
    if found:
        print(f"no result: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 4
    print(f"correct {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stdout.flush()
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
