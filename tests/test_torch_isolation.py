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
              "repro_torch.serve.retrieval", "repro_torch.api.persist",
              "repro_torch.core.metric", "repro_torch.obs.export",
              "repro_torch.obs.attribution", "repro_torch.distributed",
              "repro_torch.distributed.context", "repro_torch.distributed.knn_island",
              "repro_torch.distributed.estimator", "repro_torch.distributed.router",
              "repro_torch.distributed.router.table", "repro_torch.distributed.router.cost",
              "repro_torch.distributed.router.exec", "repro_torch.models.moe",
              "repro_torch.models.mamba", "repro_torch.models.rwkv",
              "repro_torch.models.transformer", "repro_torch.models.convert",
              "repro_torch.configs.whisper_tiny", "repro_torch.configs.pixtral_12b",
              "repro_torch.configs.jamba_1_5_large_398b", "repro_torch.configs.granite_20b",
              "repro_torch.configs.deepseek_67b", "repro_torch.configs.rwkv6_3b",
              "repro_torch.configs.deepseek_v2_236b",
              "repro_torch.configs.qwen3_moe_235b_a22b", "repro_torch.tree",
              "repro_torch.optim", "repro_torch.optim.optimizer", "repro_torch.optim.schedule",
              "repro_torch.train", "repro_torch.train.train_step", "repro_torch.train.trainer",
              "repro_torch.checkpoint", "repro_torch.checkpoint.checkpointing",
              "repro_torch.data.pipeline", "repro_torch.launch.train",
              "repro_torch.launch.dryrun", "repro_torch.launch.mesh",
              "repro_torch.distributed.elastic", "repro_torch.distributed.sharding",
              "repro_torch.distributed.collectives", "repro_torch.distributed.step_cost",
              "repro_torch.distributed.roofline"):
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


def test_training_entry_points_refuse_cpu(monkeypatch, tmp_path):
    """The train launcher runs on the card unless ``--device`` names
    another device: without CUDA it raises before building anything, and
    ``--device cpu`` trains."""
    from repro_torch.launch import train as launch_train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--smoke-model", "--steps", "1", "--ckpt-dir", str(tmp_path)])
    assert not tmp_path.joinpath("step_00000001").exists()
    rep = launch_train.main(["--smoke-model", "--steps", "1", "--batch", "2", "--seq", "8",
                             "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    assert len(rep.losses) == 1


def test_family_models_refuse_cpu(monkeypatch):
    """Every family other than dense GQA (MoE + MLA, SSM, hybrid,
    encoder-decoder, the vision stub) builds on the card unless told
    otherwise: with no device and no CUDA, ``Model`` raises before it holds
    a byte, at full width too; ``device="cpu"`` runs the smoke widths, and
    the launcher takes every architecture."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models.model import Model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in ("deepseek-v2-236b", "qwen3-moe-235b-a22b", "rwkv6-3b",
                 "jamba-1.5-large-398b", "whisper-tiny", "pixtral-12b"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Model(get_config(arch))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            launch_serve.main(["--arch", arch, "--requests", "1"])
        assert Model(get_smoke_config(arch), device="cpu").device.type == "cpu"


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


def test_sharded_entry_points_refuse_cpu(monkeypatch, tmp_path):
    """A sharded or routed build, baseline or load with no ``device=`` needs
    the card: without CUDA it raises, and a list of host devices runs the
    islands on the CPU."""
    from repro_torch.api import Config, IndexConfig, LayoutConfig, OverlapIndex
    from repro_torch.distributed.knn_island import default_mesh

    g = np.random.default_rng(3)
    x = np.concatenate([c + g.normal(size=(60, 3)) for c in (0.0, 12.0)]).astype(np.float32)
    path = None
    for kind in ("sharded", "routed"):
        cfg = Config(index=IndexConfig(eps=1.5, min_pts=4),
                     layout=LayoutConfig(kind=kind, shards=2))
        ix = OverlapIndex.build(x, cfg, device=["cpu"] * 2)
        assert ix.backend.kind == kind and ix.device.parts[1].bucket_x.is_cpu
        path = ix.save(tmp_path / f"{kind}.npz")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            OverlapIndex.build(x, cfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            OverlapIndex.baseline(x, cfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            OverlapIndex.load(path)
        monkeypatch.undo()
        assert OverlapIndex.load(path, device=["cpu"] * 2).backend.kind == kind
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="device="):
        default_mesh(2)


def test_dryrun_sets_no_xla_flags_and_loads_no_jax():
    """The port's dry-run runs a cell in a process of its own without
    touching ``XLA_FLAGS`` and without loading JAX (its 256 / 512 devices
    are a fake process group, not forced host devices)."""
    code = (
        "import os, sys\n"
        "from repro_torch.configs import get_smoke_config\n"
        "from repro_torch.configs.base import ShapeConfig\n"
        "from repro_torch.distributed.context import Mesh\n"
        "from repro_torch.launch import dryrun\n"
        "rec = dryrun.run_cell('smollm-135m', 'decode_32k', 'single',\n"
        "                      mesh=Mesh(shape=(2, 2), axis_names=('data', 'model')),\n"
        "                      shape=ShapeConfig('decode_32k', 'decode', 16, 4),\n"
        "                      base=get_smoke_config('smollm-135m'))\n"
        "assert rec['status'] == 'ok', rec\n"
        "assert 'XLA_FLAGS' not in os.environ\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = str(PORT.parent)
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
    assert "XLA_FLAGS" not in (PORT / "launch" / "dryrun.py").read_text()


def test_mesh_builders_refuse_cpu(monkeypatch):
    """``MeshPlan.build()`` and ``make_host_mesh()`` lay islands over the
    local cards; with no CUDA and no devices named they raise instead of
    putting the islands on the CPU."""
    from repro_torch.distributed.elastic import plan_mesh
    from repro_torch.launch.mesh import make_host_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        plan_mesh(4).build()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_host_mesh()
    assert plan_mesh(4).build(devices=["cpu"] * 4).shape == {"data": 1, "model": 4}
    assert make_host_mesh("cpu").devices == (torch.device("cpu"),)
