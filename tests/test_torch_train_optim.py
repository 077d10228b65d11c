"""The port's optimizers, LR schedule, checkpoints and token pipeline
against the JAX package's (``tests/test_substrate.py``'s cases on the port,
then the two packages on the same numpy inputs).

Tolerances: one optimizer update from the same params, gradients and state
runs the same f32 elementwise arithmetic in both; the reductions (the
global norm, Adafactor's row and column means and its update RMS) sum in
other orders, so params and moments agree to ``rtol = 1e-6`` with
``atol = 1e-7`` (the params are O(1), the moments O(grad^2)).  Checkpoints,
batches and restored leaves are compared bit for bit.
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointing as jckpt
from repro.configs import get_smoke_config as j_smoke
from repro.data import pipeline as jpipe
from repro.models.model import Model as JModel
from repro.optim import optimizer as jopt
from repro.optim.schedule import cosine_with_warmup as j_cosine
from repro_torch.checkpoint.checkpointing import restore_latest, save_checkpoint
from repro_torch.configs import SHAPES, get_smoke_config, shape_applicable
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import (
    BatchSpec,
    DataConfig,
    TokenPipeline,
    make_batch_specs,
    materialize_batch,
)
from repro_torch.models.convert import Leaf, jax_tree, params_from_jax
from repro_torch.optim import adafactor, adamw, clip_by_global_norm, cosine_with_warmup
from repro_torch.optim import get_optimizer
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.train.train_step import init_train_state, load_state


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------- optimizer
def _quadratic_params():
    return {"w": torch.tensor([3.0, -2.0, 1.0]), "b": torch.tensor([[1.0, -1.0]] * 2)}


@pytest.mark.parametrize("opt_fn", [adamw, adafactor])
def test_optimizer_descends_quadratic(opt_fn):
    opt = opt_fn(weight_decay=0.0)
    params = _quadratic_params()
    state = opt.init(params)

    def loss(p):
        return sum(torch.sum(x**2) for x in tree_leaves(p))

    l0 = float(loss(params))
    for _ in range(60):
        grads = tree_map(lambda x: 2 * x, params)
        params, state = opt.update(grads, state, params, torch.tensor(0.05))
    assert float(loss(params)) < 0.2 * l0


def test_adafactor_state_is_factored():
    opt = adafactor()
    params = {"big": torch.zeros((64, 32)), "vec": torch.zeros((7,))}
    state = opt.init(params)
    assert set(state["v"]["big"]) == {"vr", "vc"}
    assert state["v"]["big"]["vr"].shape == (64,)
    assert state["v"]["big"]["vc"].shape == (32,)
    assert state["v"]["vec"]["v"].shape == (7,)
    assert state["step"].dtype == torch.int32 and state["step"].shape == ()


def test_clip_by_global_norm():
    g = {"a": torch.full((4,), 10.0)}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert np.isclose(float(norm), 20.0)
    assert np.isclose(float(torch.linalg.vector_norm(clipped["a"])), 1.0, rtol=1e-5)


def test_schedule_shape_and_values():
    lr = cosine_with_warmup(1e-3, warmup=10, total=100)
    assert float(lr(0)) == 0.0
    assert np.isclose(float(lr(10)), 1e-3)
    assert float(lr(100)) < float(lr(50)) < float(lr(10)) + 1e-9
    assert float(lr(100)) >= 1e-4 - 1e-9  # min_ratio floor
    jl = j_cosine(1e-3, 10, 100)
    for step in (0, 3, 10, 11, 57, 99, 100, 150):
        np.testing.assert_allclose(float(lr(torch.tensor(step, dtype=torch.int32))),
                                   float(jl(jnp.int32(step))), rtol=1e-6)


def _stacked_case(seed: int):
    """smollm's smoke params (a scanned stage of two layers) as the port's
    JAX-layout tree, and gradients of the same tree made with numpy."""
    cfg = get_smoke_config("smollm-135m")
    params = jax.tree.map(np.asarray, JModel(j_smoke("smollm-135m")).init(jax.random.key(3)))
    model = params_from_jax(params, cfg, device="cpu")
    g = np.random.default_rng(seed)
    grads = jax.tree.map(lambda a: (g.normal(size=a.shape) * 0.1).astype(np.float32), params)
    assert params["stages"][0]["u0"]["attn"]["wq"].shape[0] == 2
    return model, params, grads


def _close_tree(got, want):
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_one_update_matches_jax(name):
    """Two updates (the second from the first's state) on the same params
    and gradients: new params and every moment.  Adafactor factors and
    clips each stacked JAX leaf as one (its RMS over both layers)."""
    model, params, grads = _stacked_case(seed=21)
    opt, jo = get_optimizer(name), jopt.get_optimizer(name)
    tree = jax_tree(model)
    values = tree_map(Leaf.value, tree)
    state, jstate = opt.init(tree), jo.init(jax.tree.map(jnp.asarray, params))
    jp, tg = jax.tree.map(jnp.asarray, params), tree_map(_t, grads)
    for lr in (1e-2, 3e-3):
        values, state = opt.update(tg, state, values, torch.tensor(lr))
        jp, jstate = jo.update(jax.tree.map(jnp.asarray, grads), jstate, jp, jnp.float32(lr))
        _close_tree(values, jp)
        _close_tree({k: v for k, v in state.items() if k != "step"},
                    {k: v for k, v in jstate.items() if k != "step"})
        assert int(state["step"]) == int(jstate["step"])
    if name == "adafactor":
        assert state["v"]["stages"][0]["u0"]["attn"]["wq"]["vr"].shape == (2, 48, 3)
        assert state["v"]["stages"][0]["u0"]["attn"]["wq"]["vc"].shape == (2, 48, 16)


def test_clip_matches_jax_on_the_stacked_tree():
    _, _, grads = _stacked_case(seed=22)
    grads = jax.tree.map(lambda a: a * 3.0, grads)
    got, gnorm = clip_by_global_norm(tree_map(_t, grads), 1.0)
    want, jnorm = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, grads), 1.0)
    np.testing.assert_allclose(float(gnorm), float(jnorm), rtol=1e-6)
    _close_tree(got, want)


# -------------------------------------------------------------- checkpoints
def test_checkpoint_roundtrip_and_retention(tmp_path):
    tree = {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
            "nested": {"b": np.ones(5), "step": np.int32(7)}}
    for step in (10, 20, 30, 40):
        save_checkpoint(tmp_path, step, tree, keep=2)
    kept = sorted(p.name for p in tmp_path.iterdir() if p.is_dir())
    assert kept == ["step_00000030", "step_00000040"]
    restored, step = restore_latest(tmp_path, tree)
    assert step == 40
    np.testing.assert_array_equal(restored["w"], tree["w"])
    np.testing.assert_array_equal(restored["nested"]["b"], tree["nested"]["b"])
    assert int(restored["nested"]["step"]) == 7


def test_checkpoint_corruption_falls_back(tmp_path):
    tree = {"w": np.arange(6, dtype=np.float32)}
    save_checkpoint(tmp_path, 1, tree, keep=5)
    save_checkpoint(tmp_path, 2, {"w": tree["w"] * 2}, keep=5)
    latest = tmp_path / "step_00000002"
    payload = next(latest.glob("*.npy"))
    payload.write_bytes(b"garbage")
    restored, step = restore_latest(tmp_path, tree)
    assert step == 1  # fell back past the corrupted one
    np.testing.assert_array_equal(restored["w"], tree["w"])


def test_checkpoint_empty_dir(tmp_path):
    restored, step = restore_latest(tmp_path / "nope", {"w": np.ones(2)})
    assert restored is None and step == -1


def _train_states():
    """The same smollm smoke train state in both packages: AdamW moments
    made non-zero by one update from the same gradients."""
    model, params, grads = _stacked_case(seed=23)
    opt, jo = adamw(), jopt.adamw()
    state = init_train_state(model, opt)
    tree = state["params"]
    values, state["opt"] = opt.update(tree_map(_t, grads), state["opt"],
                                      tree_map(Leaf.value, tree), torch.tensor(1e-3))
    for leaf, v in zip(tree_leaves(tree), tree_leaves(values)):
        leaf.assign_(v)
    state["step"] = state["step"] + 1
    jp = jax.tree.map(jnp.asarray, params)
    jnew, jos = jo.update(jax.tree.map(jnp.asarray, grads), jo.init(jp), jp, jnp.float32(1e-3))
    jstate = {"params": jnew, "opt": jos, "step": jnp.ones((), jnp.int32)}
    return model, state, jstate


def _state_arrays(state) -> list[np.ndarray]:
    return [np.asarray(leaf.value() if isinstance(leaf, Leaf) else leaf)
            for leaf in tree_leaves(state)]


def test_checkpoint_names_and_bytes_match_jax(tmp_path):
    """The same arrays saved by both packages give equal manifests (names,
    shapes, dtypes and crc32, so the files are byte for byte the same); the
    port's own train state gives the JAX package's names, shapes and
    dtypes."""
    _, state, jstate = _train_states()
    same = jax.tree.map(np.asarray, jstate)
    jckpt.save_checkpoint(tmp_path / "jax", 5, same, keep=1)
    save_checkpoint(tmp_path / "port", 5, tree_map(_t, same), keep=1)
    jm = json.loads((tmp_path / "jax/step_00000005/manifest.json").read_text())
    pm = json.loads((tmp_path / "port/step_00000005/manifest.json").read_text())
    assert pm == jm
    save_checkpoint(tmp_path / "own", 5, state, keep=1)
    om = json.loads((tmp_path / "own/step_00000005/manifest.json").read_text())
    assert [(f["file"], f["shape"], f["dtype"]) for f in om["files"]] == \
        [(f["file"], f["shape"], f["dtype"]) for f in jm["files"]]
    assert any(f["file"].endswith("params_stages_0_u0_attn_wq.npy") for f in om["files"])


def test_checkpoints_cross_between_the_packages(tmp_path):
    """An f32 train state saved by either package restores in the other
    bit for bit: the JAX package's into the port's model and optimizer
    state, the port's into the JAX package's tree."""
    _, state, jstate = _train_states()
    jckpt.save_checkpoint(tmp_path / "jax", 1, jax.tree.map(np.asarray, jstate), keep=1)
    save_checkpoint(tmp_path / "port", 1, state, keep=1)

    fresh = params_from_jax(jax.tree.map(np.zeros_like, jax.tree.map(np.asarray, jstate["params"])),
                            get_smoke_config("smollm-135m"), device="cpu")
    target = init_train_state(fresh, adamw())
    restored, step = restore_latest(tmp_path / "jax", target)
    assert step == 1
    target = load_state(target, restored)
    for got, want in zip(_state_arrays(target), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(fresh.layers[1].attn.wq.detach().numpy(),
                                  np.asarray(jstate["params"]["stages"][0]["u0"]["attn"]["wq"][1]))

    jrestored, jstep = jckpt.restore_latest(tmp_path / "port", jax.tree.map(np.asarray, jstate))
    assert jstep == 1
    for got, want in zip(jax.tree.leaves(jrestored), _state_arrays(state)):
        assert np.asarray(got).dtype == want.dtype
        np.testing.assert_array_equal(np.asarray(got), want)


def test_bf16_leaf_restores_in_the_port_not_in_the_reference(tmp_path):
    """The reference fault: the JAX package saves a bf16 leaf (``np.save``
    of an ``ml_dtypes.bfloat16`` array, descr ``<V2``) but its restore hands
    it on as raw ``|V2`` bytes, which ``jnp.asarray`` (its trainer's
    resume) refuses.  The port writes the same bytes and reads them back
    as bf16 by the manifest's dtype, from either package's file."""
    w = jnp.asarray(np.linspace(-3, 3, 12, dtype=np.float32).reshape(3, 4), jnp.bfloat16)
    jckpt.save_checkpoint(tmp_path / "jax", 1, {"w": np.asarray(w)}, keep=1)
    jrestored = jckpt.restore_checkpoint(tmp_path / "jax/step_00000001", {"w": np.asarray(w)})
    assert jrestored["w"].dtype == np.dtype("V2")
    with pytest.raises(TypeError):
        jnp.asarray(jrestored["w"])
    want = torch.from_numpy(np.array(w.astype(jnp.float32))).to(torch.bfloat16)
    save_checkpoint(tmp_path / "port", 1, {"w": want}, keep=1)
    for side in ("jax", "port"):
        d = tmp_path / side / "step_00000001"
        assert json.loads((d / "manifest.json").read_text())["files"][0]["dtype"] == "bfloat16"
        restored, _ = restore_latest(tmp_path / side, {"w": want})
        assert restored["w"].dtype == torch.bfloat16 and torch.equal(restored["w"], want)
    assert (tmp_path / "jax/step_00000001/00000_w.npy").read_bytes() == \
        (tmp_path / "port/step_00000001/00000_w.npy").read_bytes()


# ------------------------------------------------------------ data pipeline
def test_pipeline_deterministic_and_host_sharded():
    cfg = DataConfig(seq_len=16, global_batch=8, vocab_size=1000)
    p0 = TokenPipeline(cfg, host_id=0, n_hosts=2)
    p1 = TokenPipeline(cfg, host_id=1, n_hosts=2)
    a = p0.batch_at(5)
    b = p0.batch_at(5)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])  # restart-safe
    c = p1.batch_at(5)
    assert not np.array_equal(a["tokens"], c["tokens"])  # disjoint hosts
    assert a["tokens"].shape == (4, 16)
    assert (a["tokens"][:, 1:] == a["targets"][:, :-1]).all()


@pytest.mark.parametrize("host", [0, 1])
def test_pipeline_batches_bitwise_equal_to_jax(host):
    cfg = DataConfig(seq_len=64, global_batch=8, vocab_size=151_936, seed=3)
    jcfg = jpipe.DataConfig(seq_len=64, global_batch=8, vocab_size=151_936, seed=3)
    mine = TokenPipeline(cfg, host_id=host, n_hosts=2)
    ref = jpipe.TokenPipeline(jcfg, host_id=host, n_hosts=2)
    for step in (0, 1, 17):
        a, b = mine.batch_at(step), ref.batch_at(step)
        for k in ("tokens", "targets"):
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("arch", ["whisper-tiny", "pixtral-12b", "smollm-135m"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_batch_specs_and_materialized_batches_match_jax(arch, shape):
    from repro.configs import ShapeConfig as JShapeConfig

    cfg, jcfg = get_smoke_config(arch), j_smoke(arch)
    small = ShapeConfig(shape, SHAPES[shape].kind, 8, 2)
    jsmall = JShapeConfig(shape, SHAPES[shape].kind, 8, 2)
    specs, jspecs = make_batch_specs(cfg, small), jpipe.make_batch_specs(jcfg, jsmall)
    assert list(specs) == list(jspecs)
    for k, spec in specs.items():
        assert isinstance(spec, BatchSpec)
        assert spec.shape == jspecs[k].shape and spec.dtype == np.dtype(jspecs[k].dtype)
    got, want = materialize_batch(cfg, small, seed=4), jpipe.materialize_batch(jcfg, jsmall, seed=4)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_shapes_match_jax():
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as j_config
    from repro.configs import shape_applicable as j_applicable
    from repro_torch.configs import ARCH_IDS, get_config

    assert {k: tuple(v.__dict__.values()) for k, v in SHAPES.items()} == \
        {k: tuple(v.__dict__.values()) for k, v in JSHAPES.items()}
    assert isinstance(SHAPES["train_4k"], ShapeConfig)
    for arch in ARCH_IDS:
        for name in SHAPES:
            assert shape_applicable(get_config(arch), SHAPES[name]) == \
                j_applicable(j_config(arch), JSHAPES[name])


def test_checkpoint_report_layout_matches_jax_tree_paths(tmp_path):
    """The port's file names are the JAX package's ``_flatten`` names of the
    same tree (``tree_flatten_with_path``, keys joined by "_")."""
    _, state, jstate = _train_states()
    names, _ = jckpt._flatten(jax.tree.map(np.asarray, jstate))
    final = save_checkpoint(tmp_path, 3, state, keep=1)
    files = json.loads(Path(final, "manifest.json").read_text())["files"]
    assert [f["file"] for f in files] == [f"{i:05d}_{n[:128]}.npy" for i, (n, _) in enumerate(names)]
