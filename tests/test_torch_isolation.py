"""The port stands alone: ``repro_torch`` imports neither ``jax`` nor any
module of the JAX package, and its entry points never fall back to the CPU
on their own."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

PORT = Path(__file__).resolve().parent.parent / "src" / "repro_torch"


def _modules() -> list[str]:
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        mods.append(".".join(parts))
    return mods


def test_import_loads_no_jax_and_no_repro():
    mods = _modules()
    for m in ("repro_torch.core.knn", "repro_torch.api.index", "repro_torch.models.model",
              "repro_torch.serve.engine", "repro_torch.launch.serve", "repro_torch.obs.trace",
              "repro_torch.configs.qwen2_0_5b", "repro_torch.kernels.topk",
              "repro_torch.stream.ingest", "repro_torch.stream.maintenance",
              "repro_torch.serve.retrieval"):
        assert m in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(PORT.parent))
    proc = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("ok")


IMPORT_RE = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\s|\.|$)", re.M)


def test_no_jax_or_repro_import_lines():
    offenders = []
    for path in sorted(PORT.rglob("*.py")):
        for m in IMPORT_RE.finditer(path.read_text()):
            offenders.append(f"{path.relative_to(PORT)}: {m.group(0).strip()}")
    assert not offenders, offenders


def test_baseline_without_device_refuses_cpu(monkeypatch):
    """No ``device=`` and no CUDA: the entry point raises instead of quietly
    running on the CPU (the CPU is there only when asked for)."""
    from repro_torch.api import OverlapIndex

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.random.default_rng(0).normal(size=(50, 4)).astype(np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OverlapIndex.baseline(x)
    ix = OverlapIndex.baseline(x, device="cpu")
    assert ix.search(x[:3], k=2).ids.shape == (3, 2)


def test_serving_entry_points_refuse_cpu(monkeypatch):
    """The model, the datastore builder and the launcher run on the card
    unless told otherwise; without CUDA and without a device they raise."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models.model import Model
    from repro_torch.serve.retrieval import build_flat_datastore

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("smollm-135m")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(cfg)
    keys = np.zeros((4, cfg.d_model), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_flat_datastore(keys, np.zeros(4, np.int32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_serve.main(["--requests", "1"])
    assert Model(cfg, device="cpu").device.type == "cpu"
    assert build_flat_datastore(keys, np.zeros(4, np.int32), device="cpu").keys.is_cpu


def test_build_stages_without_device_refuse_cpu(monkeypatch):
    """``dbscan``, ``decide`` and ``build_index_core`` run on the card when no
    device is named, as the facade does: without CUDA a numpy input raises,
    ``device="cpu"`` runs, and a tensor handed to ``dbscan`` stays where it
    lies."""
    from repro_torch.core.dbscan import dbscan, partitions_from_labels
    from repro_torch.core.decision import decide
    from repro_torch.core.pipeline import IndexConfig, build_index_core

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = np.random.default_rng(1)
    x = np.concatenate([c + g.normal(size=(40, 3)) for c in (0.0, 12.0)]).astype(np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dbscan(x, 1.5, 4)
    res = dbscan(x, 1.5, 4, device="cpu")
    assert res.n_clusters == 2
    assert dbscan(torch.from_numpy(x), 1.5, 4).n_clusters == 2
    pivots, radii, assign = partitions_from_labels(x, res.labels, res.n_clusters)
    kw = dict(method="vbm", xi_min=0.4, xi_max=0.8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        decide(x, pivots, radii, assign, **kw)
    groups, _ = decide(x, pivots, radii, assign, **kw, device="cpu")
    assert len(groups) == 2
    cfg = IndexConfig(eps=1.5, min_pts=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_index_core(x, cfg)
    forest, report = build_index_core(x, cfg, device="cpu")
    assert report.n_clusters == 2 and forest.n_indexes == 2


def test_streaming_entry_points_refuse_cpu(monkeypatch):
    """The forest datastore builds on the card unless told otherwise; the
    streaming writes run where the index lives."""
    from repro_torch.api import OverlapIndex
    from repro_torch.serve.retrieval import build_forest_datastore, ingest_keys

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = np.random.default_rng(2)
    keys = np.concatenate([c + g.normal(size=(40, 4)) for c in (0.0, 12.0)]).astype(np.float32)
    vals = np.arange(80, dtype=np.int32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_forest_datastore(keys, vals, min_pts=4)
    ds = build_forest_datastore(keys, vals, min_pts=4, stream_capacity=8, device="cpu")
    ds, acc = ingest_keys(ds, keys[:3] + 0.1, vals[:3])
    assert acc == 3 and ds.delta.x.is_cpu
    ix = OverlapIndex.baseline(keys, device="cpu")
    ix.ingest(keys[:5] + 0.1)
    assert ix.device_delta.x.is_cpu and sum(ix.structure()["delta_fill"]) == 5
