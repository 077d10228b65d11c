"""The port's ``Model.loss`` and its gradients against the JAX package's
``jax.value_and_grad(Model.loss)`` on the ten smoke configurations, the JAX
weights carried across by ``params_from_jax`` and the port's gradients
read back in the JAX tree's layout through ``models.convert.jax_tree``.

Inputs are made with numpy as ``tests/test_models.py`` makes them (frames
for whisper, stub patches for pixtral) and handed to both.  Tolerances:

* f32 compute: the loss to ``rtol = 1e-6`` (one scalar); every gradient
  leaf to ``rtol = 1e-5`` and ``atol = 1e-4`` of the leaf's scale, its
  largest |value| (the JAX side's).  The gradients of deepseek-v2's dense
  MLA layer are ill-conditioned in f32: the JAX package's own lie up to
  4.7e-5 of the leaf's scale from the same loss differentiated in f64 (the
  port's up to 5.7e-5), where the logits' 1e-5 suffices.  The scale is
  floored at 1e-4 of the largest gradient of the whole tree: a leaf whose
  gradient is zero in exact arithmetic (whisper's key bias, under
  softmax's shift invariance) holds only rounding noise of ~1e-10 in
  either package.
* bf16 compute: the loss in ``tests/test_torch_families.py``'s noise band,
  |port bf16 - JAX f32| <= 1.5 |JAX bf16 - JAX f32| + 1e-2.
* remat: one checkpoint a layer recomputes the same operations, so the
  loss and gradients equal the run without it to ``rtol = atol = 1e-6``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_smoke_config as j_smoke
from repro.models.model import Model as JModel
from repro_torch.configs import get_smoke_config
from repro_torch.models.convert import jax_tree, params_from_jax
from repro_torch.tree import tree_leaves

TIGHT = 1e-5
GRAD_ATOL = 1e-4


def make_batch(cfg, b, s, seed):
    """``tests/test_models.py``'s batch as numpy arrays."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
             "targets": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = (rng.normal(size=(b, cfg.encoder_seq, cfg.d_model)) * 0.1
                           ).astype(np.float32)
    if cfg.frontend == "vision_stub":
        batch["patches"] = (rng.normal(size=(b, cfg.num_stub_patches, cfg.d_model)) * 0.1
                            ).astype(np.float32)
    return batch


def port_grads(model, batch):
    """(loss, metrics, the gradient as the JAX tree's leaves in order)."""
    loss, metrics = model.loss(batch)
    params = list(model.parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    by_param = {p: torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)}
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            [leaf.value(by_param) for leaf in tree_leaves(jax_tree(model))])


def hold_grads(got: list, want: list) -> None:
    top = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-4 * top)
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=TIGHT, atol=GRAD_ATOL * scale)


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return JModel(j_smoke(arch)).init(jax.random.key(1))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_grads_match_jax(arch):
    jcfg = j_smoke(arch).replace(compute_dtype="float32")
    params = _jax_params(arch)
    batch = make_batch(jcfg, 2, 8, seed=11)
    jm = JModel(jcfg)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    model = params_from_jax(jax.tree.map(np.asarray, params),
                            get_smoke_config(arch).replace(compute_dtype="float32"), device="cpu")
    loss, met, grads = port_grads(model, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    assert int(met["tokens"]) == int(jmet["tokens"]) == 16
    np.testing.assert_allclose(float(met["ce"]), float(jmet["ce"]), rtol=1e-6)
    assert ("router_aux" in met) == ("router_aux" in jmet) == (jcfg.moe is not None)
    if jcfg.moe is not None:
        np.testing.assert_allclose(float(met["router_aux"]), float(jmet["router_aux"]),
                                   rtol=TIGHT)
    jl, jdef = jax.tree_util.tree_flatten(jgrads)
    assert jdef == jax.tree_util.tree_structure(jax.tree.map(np.asarray, params))
    assert [tuple(g.shape) for g in grads] == [tuple(g.shape) for g in jl]
    hold_grads(grads, jl)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-v2-236b", "rwkv6-3b"])
def test_bf16_loss_in_noise_band(arch):
    """The default bf16 compute: the port's loss lies no further from the
    JAX package's f32 loss than the band its own bf16 loss sets."""
    params = _jax_params(arch)
    batch = make_batch(j_smoke(arch), 2, 8, seed=12)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    j16 = float(jax.jit(JModel(j_smoke(arch)).loss)(params, jb)[0])
    j32 = float(jax.jit(JModel(j_smoke(arch).replace(compute_dtype="float32")).loss)(params, jb)[0])
    cfg = get_smoke_config(arch)
    assert cfg.compute_dtype == "bfloat16"
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg, device="cpu")
    loss, _, grads = port_grads(model, batch)
    assert abs(float(loss) - j32) <= 1.5 * abs(j16 - j32) + 1e-2
    assert all(g.dtype == torch.float32 and bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "whisper-tiny"])
def test_remat_recomputes_the_same_grads(arch):
    """``remat="full"``: one non-reentrant checkpoint a layer (whisper's
    encoder layers too); the MoE router losses come back from each
    checkpoint once, not again from its recompute."""
    params = jax.tree.map(np.asarray, _jax_params(arch))
    batch = make_batch(j_smoke(arch), 2, 8, seed=13)
    out = {}
    for remat in ("none", "full"):
        cfg = get_smoke_config(arch).replace(compute_dtype="float32", remat=remat)
        model = params_from_jax(params, cfg, device="cpu")
        out[remat] = port_grads(model, batch)
    (l0, m0, g0), (l1, m1, g1) = out["none"], out["full"]
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-6, atol=1e-6)
    for key in m0:
        np.testing.assert_allclose(float(m1[key]), float(m0[key]), rtol=1e-6, atol=1e-6)
    for a, b in zip(g1, g0):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)


def test_loss_masks_targets_outside_the_vocabulary():
    """Targets below 0 or at/above ``vocab_size`` (the padded tail) count
    in neither the sum nor the token count, as in the JAX package."""
    arch = "qwen2-0.5b"
    jcfg = j_smoke(arch).replace(compute_dtype="float32")
    params = _jax_params(arch)
    batch = make_batch(jcfg, 2, 8, seed=14)
    batch["targets"][0, :3] = [-1, jcfg.vocab_size, jcfg.padded_vocab + 5]
    jloss, jmet = JModel(jcfg).loss(params, {k: jnp.asarray(v) for k, v in batch.items()})
    model = params_from_jax(jax.tree.map(np.asarray, params),
                            get_smoke_config(arch).replace(compute_dtype="float32"), device="cpu")
    with torch.no_grad():
        loss, met = model.loss(batch)
    assert int(met["tokens"]) == int(jmet["tokens"]) == 13
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
