"""The dry-run's memory ledger, its folded time loops and ``remat="dots"``:

* ``step_cost.analyze_step``'s ledger against hand counts: ``(x @ a) @ b``
  peaks at its arguments, the first product and the result; a checkpointed
  loop of six ``tanh(x @ w_i)`` and its gradient peaks at the end of the
  backward, where the six (16, 16) weight gradients are alive beside their
  stack (``unbind``'s backward), the loss and its seed;
* a folded time loop (``layers.scan_steps`` under the counter: four trips,
  the second standing for the middle ones, its backward nodes counted by
  their sequence numbers) counts exactly what the unrolled loop counts:
  FLOPs, bytes, collective bytes and the peak, on the rwkv6-3b and jamba
  smoke configurations' train and prefill cells at 32 tokens on a (2, 2)
  mesh (a child process: the fake process group is per process);
* the stage fold (two and three units) equals the whole depth run, FLOPs,
  bytes and the peak, with remat and without;
* ``remat="dots"`` saves the outputs of ``aten.mm`` / ``aten.addmm`` (the
  products with no batch dims, the JAX package's
  ``dots_with_no_batch_dims_saveable``) and recomputes the rest; its loss
  and gradients equal ``"full"``'s and ``"none"``'s bit for bit on the CPU
  at f32, as the JAX package's three policies do, and lie within
  ``tests/test_torch_train_grads.py``'s tolerance of the JAX package's;
  the ledger's peak of the loss and its gradient, and the dry-run's peak
  of a smoke train cell, are ordered none >= dots >= full.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint

from repro.configs import get_smoke_config as j_smoke
from repro.models.model import Model as JModel
from repro_torch.configs import get_smoke_config
from repro_torch.distributed.step_cost import analyze_step
from repro_torch.models import model as model_mod
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model

from test_torch_train_grads import hold_grads, make_batch, port_grads
from torch_jax_child import ROOT

M = "meta"


def test_ledger_peak_of_two_products():
    x, a, b = (torch.empty(8, 24, device=M), torch.empty(24, 40, device=M),
               torch.empty(40, 8, device=M))
    cost, _ = analyze_step(lambda x, a, b: (x @ a) @ b, x, a, b)
    args, first, out = 4 * (8 * 24 + 24 * 40 + 40 * 8), 4 * 8 * 40, 4 * 8 * 8
    assert cost.argument_bytes == args
    assert cost.peak_bytes == args + first + out
    assert cost.output_bytes == out and cost.temp_bytes == first


def test_ledger_peak_of_checkpointed_loop_grad():
    x = torch.empty(4, 16, device=M)
    w = torch.empty(6, 16, 16, device=M, requires_grad=True)

    def fwd(x, w):
        for wi in w:
            x = checkpoint(lambda x, wi: torch.tanh(x @ wi), x, wi, use_reentrant=False)
        return x.sum()

    cost, _ = analyze_step(lambda x, w: torch.autograd.grad(fwd(x, w), w)[0], x, w)
    args, grad_i, stacked, scalars = 4 * (4 * 16 + 6 * 16 * 16), 4 * 16 * 16, 4 * 6 * 16 * 16, 8
    assert cost.peak_bytes == args + 6 * grad_i + stacked + scalars
    assert cost.output_bytes == stacked
    assert cost.temp_bytes == 6 * grad_i + scalars


def test_dots_policy_saves_products_without_batch_dims():
    aten = torch.ops.aten
    for op in (aten.mm.default, aten.addmm.default):
        assert model_mod._dots_policy(None, op) == CheckpointPolicy.MUST_SAVE
    for op in (aten.bmm.default, aten.baddbmm.default, aten.tanh.default, aten.add.Tensor,
               aten._softmax.default):
        assert model_mod._dots_policy(None, op) == CheckpointPolicy.PREFER_RECOMPUTE


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "deepseek-v2-236b"])
def test_remat_dots_grads_equal_full_and_none(arch):
    jcfg = j_smoke(arch).replace(compute_dtype="float32")
    params = JModel(jcfg).init(jax.random.key(1))
    batch = make_batch(jcfg, 2, 8, seed=15)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jout = {r: jax.jit(jax.value_and_grad(JModel(jcfg.replace(remat=r)).loss, has_aux=True))(
        params, jb) for r in ("none", "full", "dots")}
    jl = {r: jax.tree_util.tree_leaves(g) for r, ((_, _), g) in jout.items()}
    assert all(np.array_equal(a, b) for a, b in zip(jl["dots"], jl["full"]))
    assert all(np.array_equal(a, b) for a, b in zip(jl["dots"], jl["none"]))
    np_params = jax.tree.map(np.asarray, params)
    out = {}
    for remat in ("none", "full", "dots"):
        cfg = get_smoke_config(arch).replace(compute_dtype="float32", remat=remat)
        out[remat] = port_grads(params_from_jax(np_params, cfg, device="cpu"), batch)
    for other in ("full", "none"):
        assert torch.equal(out["dots"][0], out[other][0])
        assert all(torch.equal(a, b) for a, b in zip(out["dots"][2], out[other][2]))
    np.testing.assert_allclose(float(out["dots"][0]), float(jout["dots"][0][0]), rtol=1e-6)
    hold_grads(out["dots"][2], jl["dots"])


def test_remat_saved_bytes_ordered():
    """The ledger's peak of the loss and its gradient at 64 tokens: what a
    policy saves is alive at the backward's start."""
    peak = {}
    for remat in ("none", "dots", "full"):
        model = Model(get_smoke_config("qwen2-0.5b").replace(remat=remat), device=M, seed=None)
        params = list(model.parameters())

        def step(tokens):
            loss, _ = model.loss({"tokens": tokens, "targets": tokens})
            return torch.autograd.grad(loss, params)

        peak[remat] = analyze_step(step, torch.empty((2, 64), dtype=torch.int64,
                                                     device=M))[0].peak_bytes
    assert peak["none"] > peak["dots"] > peak["full"], peak


CHILD = r"""
import json
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed.context import Mesh
from repro_torch.launch import dryrun
small = Mesh(shape=(2, 2), axis_names=("data", "model"))
out = {"fold": {}, "remat": {}}
for arch in ("rwkv6-3b", "jamba-1.5-large-398b"):
    for sn, kind in (("train_4k", "train"), ("prefill_32k", "prefill")):
        for fold in (True, False):
            rec = dryrun.run_cell(arch, sn, "single", mesh=small,
                                  shape=ShapeConfig(sn, kind, 32, 4),
                                  base=get_smoke_config(arch), fold_loops=fold)
            out["fold"][f"{arch}/{sn}/{fold}"] = [rec["status"], rec["hlo_cost"], rec["memory"]]
# the dry-run's peaks of one smoke train cell: baseline (remat full), its
# noremat variant, and remat="dots"
base = get_smoke_config("qwen2-0.5b").replace(remat="full")
for variant, cfg in (("baseline", base), ("noremat", base), ("dots", base.replace(remat="dots"))):
    rec = dryrun.run_cell("qwen2-0.5b", "train_4k", "single",
                          "baseline" if variant == "dots" else variant, mesh=small,
                          shape=ShapeConfig("train_4k", "train", 64, 4), base=cfg)
    out["remat"][variant] = [rec["status"], rec["memory"]["peak_bytes"]]
# the stage fold (two and three units, six deep) against the six layers run
from repro_torch.distributed.context import use_mesh
from repro_torch.distributed.step_cost import analyze_step
from torch.distributed.tensor.experimental import implicit_replication
shape = ShapeConfig("train_4k", "train", 64, 4)
for remat in ("full", "none"):
    cfg = get_smoke_config("qwen2-0.5b").replace(num_layers=6, remat=remat)
    rec = dryrun.run_cell("qwen2-0.5b", "train_4k", "single", mesh=small, shape=shape, base=cfg)
    dryrun._reset_rules()
    with use_mesh(small):
        fn, args, _ = dryrun.build_cell(cfg, shape, small, dmesh=dryrun.device_mesh(small))
        with implicit_replication():
            cost, _ = analyze_step(fn, *args, arg_bytes=rec["memory"]["argument_bytes"])
    out["stage"] = out.get("stage", {})
    out["stage"][remat] = [rec["hlo_cost"]["trip_counts"], rec["hlo_cost"]["flops"],
                           rec["hlo_cost"]["bytes"], rec["memory"]["peak_bytes"],
                           cost.flops, cost.bytes, cost.peak_bytes]
print("JSON" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def child_run():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", CHILD], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = next(ln for ln in proc.stdout.splitlines() if ln.startswith("JSON"))
    return json.loads(line[4:])


@pytest.mark.parametrize("cell", ["rwkv6-3b/train_4k", "rwkv6-3b/prefill_32k",
                                  "jamba-1.5-large-398b/train_4k",
                                  "jamba-1.5-large-398b/prefill_32k"])
def test_folded_time_loop_equals_unrolled(child_run, cell):
    folded, unrolled = child_run["fold"][f"{cell}/True"], child_run["fold"][f"{cell}/False"]
    assert folded[0] == unrolled[0] == "ok"
    loop = "rwkv wkv" if cell.startswith("rwkv") else "mamba scan"
    assert folded[1]["trip_counts"][loop] == 32
    assert loop not in (unrolled[1]["trip_counts"] or {})
    for key in ("flops", "bytes", "collective_bytes"):
        assert folded[1][key] == unrolled[1][key], (key, folded[1][key], unrolled[1][key])
    assert folded[2] == unrolled[2]


@pytest.mark.parametrize("remat", ["full", "none"])
def test_stage_fold_equals_the_whole_depth(child_run, remat):
    """Six layers measured at two and three and folded count what the six
    count run: FLOPs, bytes and the peak (linear in the depth)."""
    trips, *got = child_run["stage"][remat]
    assert trips == {"stage 0": 6}
    assert got[:3] == got[3:], got


def test_dryrun_peaks_ordered_by_remat(child_run):
    r = child_run["remat"]
    assert all(s == "ok" for s, _ in r.values())
    assert r["noremat"][1] > r["dots"][1] > r["baseline"][1], r
