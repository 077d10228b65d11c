"""The port's train step, trainer and launcher against the JAX package's,
and serving after training.

Tolerances: a 5-step f32 trajectory from the same weights and batches is
the JAX package's to ``rtol = 1e-5`` a step in the loss and the lr, and
``rtol = 1e-4`` in the gradient norm: the two run the same f32 arithmetic
in other summation orders, and deepseek-v2's gradients are ill-conditioned
in f32 (both packages lie up to ~5e-5 of a leaf's scale from an f64
evaluation, ``tests/test_torch_train_grads.py``).  Serving after a step is compared bit for bit with a model
converted afresh from the trained weights.
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.models.model import Model as JModel
from repro.optim.optimizer import get_optimizer as j_get_optimizer
from repro.optim.schedule import cosine_with_warmup as j_cosine
from repro.train.train_step import make_train_step as j_make_train_step
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch import train as launch_train
from repro_torch.models.convert import Leaf, params_from_jax, params_to_jax
from repro_torch.models.model import Model
from repro_torch.optim import cosine_with_warmup, get_optimizer
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.train.train_step import init_train_state, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig


@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-v2-236b"])
def test_five_step_trajectory_with_grad_accum_matches_jax(arch):
    """``grad_accum=2`` (two micro-batches of 2 rows), f32 compute, the
    configuration's optimizer (AdamW for smollm, Adafactor for deepseek-v2)
    under a warmup-cosine schedule: loss, grad norm and lr of each step."""
    jcfg = j_smoke(arch).replace(compute_dtype="float32", grad_accum=2)
    cfg = get_smoke_config(arch).replace(compute_dtype="float32", grad_accum=2)
    params = JModel(jcfg).init(jax.random.key(4))
    jopt = j_get_optimizer(jcfg.optimizer)
    jstep = jax.jit(j_make_train_step(JModel(jcfg), jopt, j_cosine(1e-2, 2, 5)))
    jstate = {"params": params, "opt": jopt.init(params), "step": jnp.zeros((), jnp.int32)}
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg, device="cpu")
    opt = get_optimizer(cfg.optimizer)
    step = make_train_step(model, opt, cosine_with_warmup(1e-2, 2, 5))
    state = init_train_state(model, opt)
    pipe = TokenPipeline(DataConfig(seq_len=8, global_batch=4, vocab_size=cfg.vocab_size))
    got, want = [], []
    for i in range(5):
        batch = pipe.batch_at(i)
        state, m = step(state, batch)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        got.append([float(m[k]) for k in ("loss", "grad_norm", "lr")])
        want.append([float(jm[k]) for k in ("loss", "grad_norm", "lr")])
    got, want = np.array(got), np.array(want)
    np.testing.assert_allclose(got[:, [0, 2]], want[:, [0, 2]], rtol=1e-5)
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-4)
    assert int(state["step"]) == int(jstate["step"]) == 5
    assert got[-1, 0] < got[0, 0]


def test_grad_accum_matches_one_batch():
    """Two micro-batches of 2 rows, averaged, give the one 4-row batch's
    loss and update (the mean CE over equal token counts)."""
    base = get_smoke_config("qwen2-0.5b").replace(compute_dtype="float32")
    batch = TokenPipeline(DataConfig(seq_len=8, global_batch=4, vocab_size=256)).batch_at(0)
    out = []
    for ga in (1, 2):
        model = Model(base.replace(grad_accum=ga), device="cpu", seed=5)
        opt = get_optimizer("adamw")
        state, m = make_train_step(model, opt, lambda s: torch.tensor(1e-3))(
            init_train_state(model, opt), batch)
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    [leaf.value().clone() for leaf in tree_leaves(state["params"])]))
    np.testing.assert_allclose(out[1][:2], out[0][:2], rtol=1e-5)
    for a, b in zip(out[1][2], out[0][2]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_bf16_grad_dtype_keeps_the_params_dtype():
    """``grad_dtype="bfloat16"``: the accumulated gradients are bf16, the
    f32 params and moments stay f32 and move."""
    model = Model(get_smoke_config("smollm-135m").replace(grad_accum=2), device="cpu", seed=6)
    opt = get_optimizer("adamw")
    state = init_train_state(model, opt)
    before = [leaf.value().clone() for leaf in tree_leaves(state["params"])]
    step = make_train_step(model, opt, lambda s: torch.tensor(1e-3), grad_dtype="bfloat16")
    batch = TokenPipeline(DataConfig(seq_len=8, global_batch=4, vocab_size=256)).batch_at(1)
    state, m = step(state, batch)
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    after = [leaf.value() for leaf in tree_leaves(state["params"])]
    assert all(a.dtype == torch.float32 for a in after)
    assert all(not torch.equal(a, b) for a, b in zip(after, before))
    assert all(v.dtype == torch.float32 for v in tree_leaves(state["opt"]["mu"]))


def test_non_finite_loss_leaves_the_state_alone():
    """The update is in place, so a step whose loss is not finite changes
    nothing: params, moments and the step counter stay as they were."""
    model = Model(get_smoke_config("smollm-135m"), device="cpu", seed=7)
    opt = get_optimizer("adamw")
    state = init_train_state(model, opt)
    with torch.no_grad():
        model.final_norm.fill_(float("nan"))
    before = [a.clone() for a in (model.embed, state["opt"]["mu"]["embed"], state["step"])]
    step = make_train_step(model, opt, lambda s: torch.tensor(1e-3))
    batch = TokenPipeline(DataConfig(seq_len=8, global_batch=2, vocab_size=256)).batch_at(0)
    new, m = step(state, batch)
    assert not np.isfinite(float(m["loss"]))
    assert new is state
    for a, b in zip((model.embed, state["opt"]["mu"]["embed"], state["step"]), before):
        assert torch.equal(a, b)


def test_serving_after_a_step_reads_the_new_weights():
    """bf16 compute over f32 params: the serving path's cast copies are
    made before the step; after it, prefill and decode equal those of a
    model converted afresh from ``params_to_jax`` of the trained weights."""
    cfg = get_smoke_config("qwen2-0.5b")
    assert cfg.compute_dtype == "bfloat16" and cfg.param_dtype == "float32"
    model = Model(cfg, device="cpu", seed=8)
    toks = torch.from_numpy(np.random.default_rng(9).integers(0, 256, (2, 6)).astype(np.int32))
    stale, _ = model.prefill(toks, max_len=8)
    opt = get_optimizer("adamw")
    step = make_train_step(model, opt, lambda s: torch.tensor(1e-2))
    batch = TokenPipeline(DataConfig(seq_len=8, global_batch=2, vocab_size=256)).batch_at(0)
    step(init_train_state(model, opt), batch)
    fresh = params_from_jax(params_to_jax(model), cfg, device="cpu")
    out = {}
    for name, m in (("trained", model), ("fresh", fresh)):
        logits, cache = m.prefill(toks, max_len=8)
        out[name] = [logits] + [m.decode_step(toks[:, :1], cache, p) for p in (6, 7)]
    assert not torch.equal(out["trained"][0], stale)
    for a, b in zip(out["trained"], out["fresh"]):
        assert torch.equal(a, b)


def _trainer_run(tmp_path, total, seed):
    cfg = get_smoke_config("smollm-135m")
    model = Model(cfg, device="cpu", seed=seed)
    opt = get_optimizer(cfg.optimizer)
    step_fn = make_train_step(model, opt, cosine_with_warmup(1e-3, 5, 30))
    pipeline = TokenPipeline(DataConfig(seq_len=16, global_batch=4, vocab_size=cfg.vocab_size))
    trainer = Trainer(step_fn, pipeline, TrainerConfig(
        total_steps=total, ckpt_every=10, ckpt_dir=str(tmp_path), log_every=100))
    state, rep = trainer.run(init_train_state(model, opt))
    return model, state, rep


def test_trainer_resumes_after_interrupt(tmp_path):
    """Train 30 steps with ckpt_every=10, kill at 20, resume to 30 — the
    fault-tolerance contract; the resumed run's weights equal an
    uninterrupted run's."""
    _, _, rep1 = _trainer_run(tmp_path, 20, seed=0)
    assert rep1.resumed_from == -1
    model2, state2, rep2 = _trainer_run(tmp_path, 30, seed=1)  # a fresh state object
    assert rep2.resumed_from == 20
    assert int(state2["step"]) == 30
    report = json.loads(Path(tmp_path, "trainer_report.json").read_text())
    assert report["restores"] >= 1
    whole, _, rep3 = _trainer_run(tmp_path / "whole", 30, seed=0)
    assert rep3.losses[20:] == rep2.losses
    for a, b in zip(model2.parameters(), whole.parameters()):
        assert torch.equal(a, b)


def test_trainer_restores_after_bad_steps(tmp_path):
    """``max_bad_steps`` non-finite losses in a row: the trainer restores
    the latest checkpoint and carries on from its step."""
    model, state, rep = _trainer_run(tmp_path, 10, seed=2)
    bad = iter(range(3))
    real = make_train_step(model, get_optimizer("adamw"), cosine_with_warmup(1e-3, 5, 30))

    def flaky(st, batch):  # three non-finite losses, as a bad host gives them
        if next(bad, None) is not None:
            return st, {"loss": torch.tensor(float("nan"))}
        return real(st, batch)

    pipeline = TokenPipeline(DataConfig(seq_len=16, global_batch=4, vocab_size=256))
    trainer = Trainer(flaky, pipeline, TrainerConfig(
        total_steps=14, ckpt_every=10, ckpt_dir=str(tmp_path), log_every=100, max_bad_steps=3))
    state, rep = trainer.run(state)
    assert rep.resumed_from == 10
    assert rep.bad_step_events == 3 and rep.restores == 2
    assert int(state["step"]) == 14 and len(rep.losses) == 4


def test_launcher_trains_on_the_host(tmp_path, capsys):
    rep = launch_train.main(["--smoke-model", "--device", "cpu", "--steps", "3", "--batch", "2",
                             "--seq", "8", "--ckpt-dir", str(tmp_path)])
    assert len(rep.losses) == 3 and all(np.isfinite(rep.losses))
    assert (tmp_path / "step_00000003" / "manifest.json").exists()
    assert "finished: 3 steps" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        launch_train.main(["--smoke-model", "--device", "cpu", "--mesh", "prod"])
    assert "needs 256 devices" in capsys.readouterr().err


def test_pipeline_feeds_both_packages_alike():
    """The JAX package's pipeline and the port's give one trainer the same
    batches (bitwise), so a resumed run replays them."""
    a = TokenPipeline(DataConfig(seq_len=16, global_batch=4, vocab_size=256)).batch_at(7)
    b = JTokenPipeline(JDataConfig(seq_len=16, global_batch=4, vocab_size=256)).batch_at(7)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_leaf_views_write_through_to_the_fused_parameters():
    """``Leaf.assign_`` of the unfused ``wq``/``w_gate`` leaves writes into
    ``wqkv``/``w_gate_in`` in place; ``params_to_jax`` reads them back."""
    model = Model(get_smoke_config("smollm-135m"), device="cpu", seed=10)
    state = init_train_state(model, get_optimizer("adamw"))
    wq = state["params"]["stages"][0]["u0"]["attn"]["wq"]
    gate = state["params"]["stages"][0]["u0"]["mlp"]["w_gate"]
    new = torch.arange(np.prod(wq.shape), dtype=torch.float32).reshape(wq.shape)
    wq.assign_(new)
    gate.assign_(torch.zeros(gate.shape))
    assert torch.equal(model.layers[1].attn.wq, new[1])
    assert torch.equal(model.layers[0].mlp.w_gate_in[:, :model.layers[0].mlp.f],
                       torch.zeros(gate.shape[1:]))
    back = params_to_jax(model)["stages"][0]["u0"]
    np.testing.assert_array_equal(back["attn"]["wq"], new.numpy())
    assert isinstance(wq, Leaf) and wq.stacked
    assert tree_map(lambda leaf: leaf.shape, state["params"]) == \
        jax.tree.map(lambda a: a.shape, params_to_jax(model))
