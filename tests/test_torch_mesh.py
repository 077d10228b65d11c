"""The port's mesh pieces: ``distributed.context.Mesh`` with named axes,
``batch_axes``, ``elastic.plan_mesh`` / ``rescale_batch`` against the JAX
package's, and ``launch.mesh`` (the production shapes, and the refusal to
lay them out without 256 / 512 devices)."""
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.distributed import elastic as j_elastic
from repro_torch.distributed import context as dctx
from repro_torch.distributed.context import Mesh
from repro_torch.distributed.elastic import MeshPlan, plan_mesh, rescale_batch
from repro_torch.launch.mesh import executable, make_host_mesh, make_production_mesh


def test_mesh_axes_and_row_major_order():
    m = Mesh([f"cpu:{i}" for i in range(6)], shape=(2, 3), axis_names=("data", "model"))
    assert m.axis_names == ("data", "model")
    assert m.shape == {"data": 2, "model": 3} and m.size == 6
    assert [m.coords(s) for s in (0, 4)] == [{"data": 0, "model": 0}, {"data": 1, "model": 1}]
    assert m.islands("model") == [0, 1, 2]
    assert m.islands("model", {"data": 1}) == [3, 4, 5]
    assert m.islands("data", {"model": 2}) == [2, 5]
    assert m.group(4, ("data", "model")) == list(range(6))
    assert m.devices[4] == torch.device("cpu", 4)
    with pytest.raises(ValueError):
        Mesh(["cpu"] * 5, shape=(2, 3), axis_names=("data", "model"))


def test_one_axis_mesh_keeps_its_meaning():
    m = Mesh(["cpu"] * 4)
    assert m.axis_names == ("model",) and m.shape == {"model": 4}
    assert dctx.model_axis_size(m) == 4 and dctx.batch_axes(m) == ()
    assert m.islands("model") == [0, 1, 2, 3]


def test_batch_axes():
    single, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert dctx.batch_axes(single) == ("data",)
    assert dctx.batch_axes(multi) == ("pod", "data")
    assert dctx.model_axis_size(multi) == 16
    assert dctx.batch_axes(None) == () and dctx.model_axis_size(None) == 1
    with dctx.use_mesh(multi):
        assert dctx.batch_axes() == ("pod", "data")


@settings(max_examples=50, deadline=None)
@given(n=st.integers(1, 4096))
def test_plan_mesh_equals_jax(n):
    got, ref = plan_mesh(n), j_elastic.plan_mesh(n)
    assert (got.shape, got.axes) == (ref.shape, ref.axes)
    total = 1
    for s in got.shape:
        total *= s
    assert total == n


def test_rescale_batch_equals_jax():
    for args in [(256, 256, 128), (256, 256, 512), (7, 4, 3), (3, 8, 2)]:
        assert rescale_batch(*args) == j_elastic.rescale_batch(*args)


def test_plan_builds_islands():
    m = MeshPlan((2, 2), ("data", "model")).build(devices=["cpu"] * 4)
    assert m.shape == {"data": 2, "model": 2} and not m.abstract


def test_production_mesh_shapes_and_refusal(monkeypatch):
    single, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert single.shape == {"data": 16, "model": 16} and single.abstract
    assert multi.shape == {"pod": 2, "data": 16, "model": 16} and multi.size == 512
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for mesh, n in ((single, 256), (multi, 512)):
        with pytest.raises(RuntimeError, match=f"needs {n} devices"):
            executable(mesh)


def test_host_mesh_over_given_devices():
    m = make_host_mesh(["cpu"] * 3)
    assert m.shape == {"data": 3}
    assert make_host_mesh("cpu").shape == {"data": 1}


def test_launcher_auto_mesh_on_the_host(tmp_path, capsys):
    import numpy as np

    from repro_torch.launch import train as launch_train

    rep = launch_train.main(["--smoke-model", "--device", "cpu", "--mesh", "auto", "--steps", "2",
                             "--batch", "2", "--seq", "8", "--ckpt-dir", str(tmp_path)])
    assert len(rep.losses) == 2 and all(np.isfinite(rep.losses))
    assert "mesh: {'data': 1}" in capsys.readouterr().out
