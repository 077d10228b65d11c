"""Run JAX package code in a child process with N forced host devices.

The port's tests import JAX with one CPU device; the JAX package's mesh
paths (``shard_map`` islands, production meshes) need more.  ``run_child``
runs ``code`` in ``python -c`` with
``XLA_FLAGS=--xla_force_host_platform_device_count=N``: the code reads its
inputs from the npz ``IN`` (a dict of arrays) and stores its outputs with
``save(**arrays)`` or ``save_json(obj)``; a failure fails the test.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]

_PRELUDE = """
import json, sys
import numpy as np
IN = dict(np.load(sys.argv[1], allow_pickle=False))
def save(**arrays):
    np.savez(sys.argv[2], **arrays)
def save_json(obj):
    open(sys.argv[2] + ".json", "w").write(json.dumps(obj))
"""


def run_child(code: str, tmp: Path, *, devices: int, inputs: dict | None = None,
              timeout: int = 600):
    """Run ``code`` with ``devices`` forced host devices; returns the npz
    it saved (a dict) or the JSON object it saved."""
    tmp.mkdir(parents=True, exist_ok=True)
    inp, out = tmp / "in.npz", tmp / "out.npz"
    np.savez(inp, **(inputs or {"_": np.zeros(1)}))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    proc = subprocess.run([sys.executable, "-c", _PRELUDE + textwrap.dedent(code),
                           str(inp), str(out)], env=env, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode:
        raise RuntimeError(f"JAX child failed:\n{proc.stderr[-4000:]}")
    js = Path(str(out) + ".json")
    if js.exists():
        return json.loads(js.read_text())
    return dict(np.load(out))
