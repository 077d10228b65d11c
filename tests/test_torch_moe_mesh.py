"""The MoE layer's expert-parallel island paths (``models/moe.expert_parallel``)
on ``["cpu"] * 4`` islands, meshes (data, model) = (1, 4) and (2, 2).

Each path is chosen by the JAX package's rules (T*k <= 4,096 with an fsdp
axis: weight-stationary; more tokens: token-sharded; ``moe_a2a``:
all-to-all) and held, on the same weights and tokens, f32 at atol 1e-4
(``tests/test_moe_paths.py``):

* to the port's single-device layer where the path drops what it drops
  (equal drop counts): always without drops, and with drops on the paths
  whose buffers see the same tokens;
* to the JAX package's same path on 4 host devices (a child process), with
  drops too (low capacity factor): the JAX package's all-to-all path sums
  the shared experts over other cells' tokens, so it is held to JAX on a
  configuration without shared experts;
* the all-to-all path's gradients are finite and within 1e-4 of a leaf's
  scale of the single-device gradients.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.distributed.context import Mesh, use_mesh
from repro_torch.models.moe import MoE

from torch_jax_child import run_child

MESHES = [(1, 4), (2, 2)]
# (name, tokens, a2a, capacity factor, shared experts)
CASES = [
    ("ws", 8, False, 8.0, 1),
    ("ws_drops", 64, False, 0.3, 1),
    ("ts", 4096, False, 4.0, 1),
    ("ts_drops", 4096, False, 0.5, 1),
    ("a2a", 4096, True, 4.0, 0),
    ("a2a_drops", 4096, True, 0.5, 0),
]


def _cfg(shared=1, a2a=False, cf=8.0):
    return ModelConfig(
        name="t", family="moe", num_layers=1, d_model=16, num_heads=2,
        num_kv_heads=2, d_ff=32, vocab_size=64, moe_a2a=a2a,
        param_dtype="float32", compute_dtype="float32",
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=16,
                      capacity_factor=cf, num_shared=shared),
    )


CHILD = """
import jax, jax.numpy as jnp
from repro.configs.base import ModelConfig, MoEConfig
from repro.distributed import context as dctx
from repro.models import moe as moe_lib
CASES = %r
out = {}
for name, t, a2a, cf, shared in CASES:
    cfg = ModelConfig(name="t", family="moe", num_layers=1, d_model=16, num_heads=2,
        num_kv_heads=2, d_ff=32, vocab_size=64, moe_a2a=a2a,
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=16, capacity_factor=cf,
                      num_shared=shared))
    p = {k[len(name) + 1:]: jnp.asarray(v) for k, v in IN.items()
         if k.startswith(name + "/") and k != name + "/x"}
    p = {k: v for k, v in p.items() if not k.startswith("shared")}
    if shared:
        p["shared"] = {n: jnp.asarray(IN[f"{name}/shared_{n}"]) for n in ("w_in", "w_gate", "w_out")}
    x = jnp.asarray(IN[name + "/x"])
    for shape in %r:
        mesh = jax.make_mesh(shape, ("data", "model"))
        with dctx.use_mesh(mesh):
            y, _ = jax.jit(lambda p, x: moe_lib.moe_ffn(p, x, cfg))(p, x)
        out[f"{name}/{shape[0]}x{shape[1]}"] = np.asarray(y)
save(**out)
"""


def _module(name, shared, a2a, cf, seed):
    mod = MoE(_cfg(shared, a2a, cf), device="cpu")
    g = torch.Generator().manual_seed(seed)
    mod.init_(g)
    mod.cast(torch.float32)
    return mod


def _weights(mod, name) -> dict:
    out = {f"{name}/{n}": getattr(mod, n).detach().numpy().copy()
           for n in ("router", "w_in", "w_gate", "w_out")}
    if mod.shared is not None:
        for n in ("w_in", "w_gate", "w_out"):
            out[f"{name}/shared_{n}"] = getattr(mod.shared, n).detach().numpy().copy()
    return out


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    mods, inputs = {}, {}
    for i, (name, t, a2a, cf, shared) in enumerate(CASES):
        mod = _module(name, shared, a2a, cf, seed=i)
        x = np.random.default_rng(i).normal(size=(1, t, 16)).astype(np.float32)
        mods[name] = (mod, x)
        inputs.update(_weights(mod, name))
        inputs[f"{name}/x"] = x
    ref = run_child(CHILD % (CASES, MESHES), tmp_path_factory.mktemp("moe"), devices=4,
                    inputs=inputs)
    return mods, ref


def _mesh(shape):
    return Mesh(["cpu"] * 4, shape=shape, axis_names=("data", "model"))


def _run(mod, x, shape=None):
    with torch.no_grad():
        if shape is None:
            y, _ = mod(torch.from_numpy(x))
        else:
            with use_mesh(_mesh(shape)):
                y, _ = mod(torch.from_numpy(x))
    return y.numpy(), int(mod.dropped)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_path_matches_single_and_jax(cases, name, shape):
    mods, ref = cases
    mod, x = mods[name]
    single, single_drops = _run(mod, x)
    got, drops = _run(mod, x, shape)
    np.testing.assert_allclose(got, ref[f"{name}/{shape[0]}x{shape[1]}"], atol=1e-4)
    if "drops" not in name:
        assert drops == single_drops == 0
    same_tokens = name.startswith("ws") or (name.startswith("ts") and shape[0] == 1)
    if same_tokens:
        assert drops == single_drops
        np.testing.assert_allclose(got, single, atol=1e-4)
    if name.endswith("drops"):
        assert drops > 0


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_a2a_with_shared_matches_single(shape):
    mod = _module("a2a_shared", 1, True, 4.0, seed=11)
    x = np.random.default_rng(11).normal(size=(2, 2048, 16)).astype(np.float32)
    single, _ = _run(mod, x)
    got, drops = _run(mod, x, shape)
    assert drops == 0
    np.testing.assert_allclose(got, single, atol=1e-4)


def _grads(mod, x, shape):
    params = [mod.router, mod.w_in, mod.w_gate, mod.w_out]
    xt = torch.from_numpy(x)
    if shape is None:
        y, _ = mod(xt)
    else:
        with use_mesh(_mesh(shape)):
            y, _ = mod(xt)
    return torch.autograd.grad((y * y).sum(), params)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_a2a_gradients_match_single(shape):
    mod = _module("grad", 0, True, 4.0, seed=7)
    x = np.random.default_rng(7).normal(size=(1, 4096, 16)).astype(np.float32)
    ref = _grads(mod, x, None)
    got = _grads(mod, x, shape)
    for g, r in zip(got, ref):
        assert torch.isfinite(g).all()
        scale = float(r.abs().max())
        assert scale > 0
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-4 * scale)
