"""The port's dry-run pieces against the JAX package's:

* ``train_step.abstract_train_state``: the leaves' shapes and dtypes equal
  JAX's ``abstract_train_state`` for the ten smoke configurations, on the
  ``meta`` device (no storage);
* ``step_cost.analyze_step`` against ``hlo_cost.analyze_module`` on the
  functions of ``tests/test_hlo_cost.py``, their scans as Python loops:
  FLOPs exactly equal on the three dot functions, the grad of the
  checkpointed loop >= 2.5x its forward, the ``tanh`` bytes within
  ``test_bytes_positive_and_bounded``'s bounds;
* ``launch.dryrun`` in a child process (the fake process group is per
  process): one smoke-config cell each of train / prefill / decode on a
  (2, 2) abstract mesh, whose records carry the JAX record's keys and
  render through ``benchmarks.roofline.fmt_table``; on a (1, 1) mesh the
  per-device FLOPs (a four-layer stage measured at two and three layers and
  folded) equal ``FlopCounterMode`` over the same step run for real on the
  CPU; ``build_cell``'s local bytes equal the JAX package's
  ``build_cell`` meta (a child with 512 host devices); and the dense smoke
  cell's FLOPs within 5% of JAX's compiled count at 1,024 tokens a row
  (shorter rows differ by design: the JAX package's chunked attention
  computes the keys it pads to a 1,024-key block, the port's masks them
  out uncomputed);
* on a (2, 2) mesh, the per-device FLOPs of the smoke cells (MoE through
  ``shard_map``'s per-device program, the all-to-all variant too; the
  attention core, the fused projections, the head and RWKV's and Mamba's
  mixers as each device's program) beside the JAX package's compiled count
  on the same mesh (an auto-sharded ``jax.sharding.Mesh``): every cell
  within [0.95, 1.05], or held within 5% of its measured ratio where a
  named difference of the two programs puts it outside (``HELD``):
  deepseek-v2's MLA pads v to the q/k width in the JAX package and
  computes the zero columns' products, the port does not (its count is
  JAX's less exactly those products on (1, 1): 8.750e9 of 9.958e9); JAX's
  ``hlo_cost`` counts jamba's depthwise convolution as a dense one over its
  channels (it reads no ``feature_group_count``: 4.7e8 of its 3.117e9 on
  (1, 1), where the port's count is the compiled module's dot sum to
  0.4%); GSPMD's (2, 2) program for rwkv6-3b falls 9.3% below half its own
  (1, 2) count, while the port's is half of its own, which is JAX's to
  0.5% on (1, 1) and (1, 2).  The collective bytes are printed beside
  JAX's, not held (DTensor picks other redistributions);
* memory: each cell's ``argument_bytes`` equals JAX's
  ``argument_size_in_bytes``; its ``peak_bytes`` (the ledger's) is printed
  beside JAX's ``peak_bytes`` and held within [0.5, 2] of the heap XLA
  assigns, argument + temp + output - alias bytes: XLA:CPU's
  ``peak_memory_in_bytes`` leaves out its temp buffer, so the JAX record's
  ``peak_bytes`` is about the argument bytes there.  Measured: 0.59-1.51
  (eager keeps intermediates XLA fuses, and XLA's heap keeps buffers the
  ledger sees die);
* the dry-run fails rather than guesses: an error of DTensor's propagation
  raises ``PropagationError`` naming the op (a grouped convolution that is
  not depthwise), an op without a sharding strategy is counted as
  replicated (its gathers in ``replicated_coll_bytes``), and
  ``cell_status`` fails a cell whose replicated ops pass
  ``REPLICATED_LIMIT``.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from benchmarks.roofline import fmt_table
from repro.configs import get_smoke_config as j_smoke
from repro.distributed.hlo_cost import analyze_module
from repro.models.model import Model as JModel
from repro.optim.optimizer import get_optimizer as j_opt
from repro.train.train_step import abstract_train_state as j_abstract
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.distributed.step_cost import analyze_step
from repro_torch.models.model import Model
from repro_torch.optim.optimizer import get_optimizer
from repro_torch.train.train_step import abstract_train_state
from repro_torch.tree import tree_flatten_with_path

from torch_jax_child import ROOT, run_child

M = "meta"
# (arch, shape name, kind, seq, batch, variant): smoke cells on a (2, 2) mesh
VS_CELLS = [("qwen2-0.5b", "train_4k", "train", 1024, 2, "baseline"),
            ("qwen2-0.5b", "prefill_32k", "prefill", 1024, 2, "baseline"),
            ("qwen2-0.5b", "decode_32k", "decode", 1024, 4, "baseline"),
            ("deepseek-v2-236b", "train_4k", "train", 1024, 2, "baseline"),
            ("deepseek-v2-236b", "decode_32k", "decode", 1024, 4, "baseline"),
            ("deepseek-v2-236b", "train_4k", "train", 1024, 4, "a2amoe-ga1"),
            ("rwkv6-3b", "train_4k", "train", 1024, 2, "baseline"),
            ("jamba-1.5-large-398b", "prefill_32k", "prefill", 1024, 2, "baseline")]
# the port's count over JAX's
BANDS = {"decode": (0.95, 1.05), "train": (0.95, 1.05), "prefill": (0.95, 1.05)}
# cells held within 5% of their measured ratio, and why (module docstring)
HELD = {"deepseek-v2-236b/train_4k/baseline": (0.8832, "MLA's v padded to the q/k width in JAX"),
        "deepseek-v2-236b/train_4k/a2amoe-ga1": (0.9057, "MLA's v padded to the q/k width in JAX"),
        "rwkv6-3b/train_4k/baseline": (
            1.1172, "GSPMD's (2, 2) program, 9.3% below half its (1, 2)"),
        "jamba-1.5-large-398b/prefill_32k/baseline": (
            0.9295, "hlo_cost counts the depthwise conv as dense")}
# the ledger's peak over the heap XLA assigns (argument + temp + output - alias)
PEAK_BAND = (0.5, 2.0)


def _compile_text(fn, *args):
    return jax.jit(fn).lower(*args).compile().as_text()


def _sds(*shape):
    return jax.ShapeDtypeStruct(shape, jnp.float32)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_train_state_matches_jax(arch):
    jcfg = j_smoke(arch)
    ref = j_abstract(JModel(jcfg), j_opt(jcfg.optimizer))
    ref = {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype))
           for p, x in jax.tree_util.tree_flatten_with_path(ref)[0]}
    cfg = get_smoke_config(arch)
    state = abstract_train_state(Model(cfg, device=M, seed=None), get_optimizer(cfg.optimizer))
    got = {}
    for path, x in tree_flatten_with_path(state):
        key = "".join(f"[{p}]" if isinstance(p, int) else f"['{p}']" for p in path)
        got[key] = (tuple(x.shape), str(x.dtype).replace("torch.", ""))
        assert x.device.type == M
    assert got == ref


def _loop(x, w):
    for wi in w:
        x = x @ wi
    return x


def test_loop_flops_exact():
    x, w = torch.empty(32, 32, device=M), torch.empty(17, 32, 32, device=M)
    ref = analyze_module(_compile_text(
        lambda x, w: jax.lax.scan(lambda x, wi: (x @ wi, None), x, w)[0],
        _sds(32, 32), _sds(17, 32, 32))).flops
    assert analyze_step(_loop, x, w)[0].flops == ref == 17 * 2 * 32 ** 3


def test_nested_loop_flops_exact():
    def jf(x, w):
        def outer(x, _):
            return jax.lax.scan(lambda x, wi: (x @ wi, None), x, w)[0], None
        return jax.lax.scan(outer, x, None, length=5)[0]

    def f(x, w):
        for _ in range(5):
            x = _loop(x, w)
        return x

    ref = analyze_module(_compile_text(jf, _sds(16, 16), _sds(9, 16, 16))).flops
    got = analyze_step(f, torch.empty(16, 16, device=M), torch.empty(9, 16, 16, device=M))
    assert got[0].flops == ref == 5 * 9 * 2 * 16 ** 3


def test_unrolled_flops_exact():
    ref = analyze_module(_compile_text(lambda x, a, b: (x @ a) @ b, _sds(8, 24), _sds(24, 40),
                                       _sds(40, 8))).flops
    args = (torch.empty(8, 24, device=M), torch.empty(24, 40, device=M),
            torch.empty(40, 8, device=M))
    assert analyze_step(lambda x, a, b: (x @ a) @ b, *args)[0].flops == ref


def test_bytes_positive_and_bounded():
    cost, _ = analyze_step(lambda x: torch.tanh(x) * 2.0, torch.empty(128, 128, device=M))
    nbytes = 128 * 128 * 4
    assert nbytes <= cost.bytes <= 6 * nbytes


def test_grad_of_checkpointed_loop_counts_bwd_flops():
    x = torch.empty(4, 16, device=M)
    w = torch.empty(6, 16, 16, device=M, requires_grad=True)

    def fwd(x, w):
        for wi in w:
            x = checkpoint(lambda x, wi: torch.tanh(x @ wi), x, wi, use_reentrant=False)
        return x.sum()

    f1 = analyze_step(fwd, x, w)[0].flops
    f2 = analyze_step(lambda x, w: torch.autograd.grad(fwd(x, w), w)[0], x, w)[0].flops
    assert f2 >= 2.5 * f1


PORT_CHILD = r"""
VS_CELLS = %r
import json, sys
import torch
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.configs import get_config, get_smoke_config, SHAPES
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed.context import Mesh
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh

out = {"cells": [], "meta": {}}
small = Mesh(shape=(2, 2), axis_names=("data", "model"))
shapes = {"train_4k": ShapeConfig("train_4k", "train", 32, 4),
          "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32, 4),
          "decode_32k": ShapeConfig("decode_32k", "decode", 64, 4)}
for name, shape in shapes.items():
    out["cells"].append(dryrun.run_cell("qwen2-0.5b", name, "single", mesh=small, shape=shape,
                                        base=get_smoke_config("qwen2-0.5b")))
# (1, 1): the dry-run's per-device count against the same step run for real;
# four layers, so the scanned stage is measured at two and three and folded
one = Mesh(shape=(1, 1), axis_names=("data", "model"))
cfg = get_smoke_config("qwen2-0.5b").replace(num_layers=4)
rec = dryrun.run_cell("qwen2-0.5b", "train_4k", "single", mesh=one, shape=shapes["train_4k"],
                      base=cfg)
fn, args, _ = dryrun.build_cell(dryrun.cell_config("qwen2-0.5b", "train_4k", base=cfg),
                                shapes["train_4k"], one, device="cpu")
with FlopCounterMode(display=False) as fc:
    fn(*args)
out["one"] = {"dry": rec["hlo_cost"]["flops"], "real": fc.get_total_flops(),
              "trips": rec["hlo_cost"]["trip_counts"]}
# the dense cell beside JAX's compiled count: 1,024 tokens a row, one whole
# KV block of the JAX package's chunked attention (it computes padded keys)
out["dense"] = dryrun.run_cell("qwen2-0.5b", "train_4k", "single", mesh=one,
                               shape=ShapeConfig("train_4k", "train", 1024, 2),
                               base=get_smoke_config("qwen2-0.5b"))["hlo_cost"]["flops"]
# build_cell's local bytes on the production meshes (no run)
for arch, sn in (("qwen2-0.5b", "train_4k"), ("qwen2-0.5b", "decode_32k"),
                 ("deepseek-v2-236b", "decode_32k"), ("deepseek-v2-236b", "prefill_32k")):
    for mk in ("single", "multi"):
        mesh = make_production_mesh(multi_pod=(mk == "multi"))
        dryrun._reset_rules()
        _, _, meta = dryrun.build_cell(dryrun.cell_config(arch, sn), SHAPES[sn], mesh)
        out["meta"][f"{arch}/{sn}/{mk}"] = meta
# (2, 2): the smoke cells set beside the JAX package's count
out["vs_jax"] = {}
for arch, sn, kind, seq, b, variant in VS_CELLS:
    rec = dryrun.run_cell(arch, sn, "single", variant, mesh=small,
                          shape=ShapeConfig(sn, kind, seq, b), base=get_smoke_config(arch))
    out["vs_jax"][f"{arch}/{sn}/{variant}"] = [rec["status"], rec["hlo_cost"]["flops"],
                                               rec["replicated_ops"], rec["rules"],
                                               rec["hlo_cost"]["collective_bytes"],
                                               rec["memory"]]
# strictness: a propagation error raises, a missing strategy is counted
import torch.nn.functional as F
from repro_torch.distributed import step_cost
from torch.distributed.tensor.experimental import implicit_replication
dmesh = dryrun.device_mesh(small)
x = dryrun._dtensor(torch.empty(1, 16, 8, device="meta"), dmesh, (None, "model", None))
w = dryrun._dtensor(torch.empty(16, 4, 3, device="meta"), dmesh, ("model", None, None))
try:
    with implicit_replication():
        step_cost.analyze_step(lambda x, w: F.conv1d(x, w, groups=4), x, w)
    out["conv"] = "no error"
except step_cost.PropagationError as e:
    out["conv"] = str(e)

@torch.library.custom_op("repro_dryrun_test::gram", mutates_args=())
def gram(x: torch.Tensor) -> torch.Tensor:
    return x @ x.T

@gram.register_fake
def _(x):
    return x.new_empty((x.shape[0], x.shape[0]))

y = dryrun._dtensor(torch.empty(8, 16, device="meta"), dmesh, ("data", "model"))
with implicit_replication():
    cost, res = step_cost.analyze_step(gram, y)
out["gram"] = dict(ops=cost.replicated_ops, coll=cost.coll_bytes,
                   rep_coll=cost.replicated_coll_bytes, status=dryrun.cell_status(cost),
                   replicated=[p.is_replicate() for p in res.placements])
print("JSON" + json.dumps(out))
"""

JAX_CHILD = """
VS_CELLS = %r
import jax
from repro.configs import SHAPES, get_config, get_smoke_config
from repro.configs.base import ShapeConfig
from repro.distributed import context as dctx
from repro.distributed.hlo_cost import analyze_module
from repro.launch import dryrun
from repro.launch.mesh import make_production_mesh
out = {"meta": {}}
for arch, sn in (("qwen2-0.5b", "train_4k"), ("qwen2-0.5b", "decode_32k"),
                 ("deepseek-v2-236b", "decode_32k"), ("deepseek-v2-236b", "prefill_32k")):
    for mk in ("single", "multi"):
        mesh = make_production_mesh(multi_pod=(mk == "multi"))
        dryrun._reset_rules()
        cfg = get_config(arch)
        if sn == "decode_32k":
            cfg = cfg.replace(retrieval=cfg.retrieval.__class__(
                enabled=True, k=8, datastore_size=16384, key_dim=512))
        with dctx.use_mesh(mesh):
            _, _, meta = dryrun.build_cell(cfg, SHAPES[sn], mesh)
        out["meta"][f"{arch}/{sn}/{mk}"] = meta
mesh = jax.make_mesh((1, 1), ("data", "model"))
with dctx.use_mesh(mesh):
    fn, args, _ = dryrun.build_cell(get_smoke_config("qwen2-0.5b"),
                                    ShapeConfig("train_4k", "train", 1024, 2), mesh)
    out["dense_flops"] = analyze_module(fn.lower(*args).compile().as_text()).flops
# (2, 2), auto-sharded: the smoke cells' compiled per-device counts
import numpy as np
from repro.distributed import sharding as shd
small = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
out["vs_jax"] = {}
for arch, sn, kind, seq, b, variant in VS_CELLS:
    dryrun._reset_rules()
    cfg = get_smoke_config(arch)
    if kind == "decode":
        cfg = cfg.replace(retrieval=cfg.retrieval.__class__(
            enabled=True, k=8, datastore_size=16384, key_dim=512))
    cfg = dryrun.VARIANTS[variant](cfg)
    with dctx.use_mesh(small):
        shd.set_rule("seq", ("model",) if cfg.seq_shard_activations else ())
        fn, args, _ = dryrun.build_cell(cfg, ShapeConfig(sn, kind, seq, b), small)
        comp = fn.lower(*args).compile()
        c, m = analyze_module(comp.as_text()), comp.memory_analysis()
        out["vs_jax"][f"{arch}/{sn}/{variant}"] = [
            c.flops, c.coll_bytes,
            {"argument": m.argument_size_in_bytes, "output": m.output_size_in_bytes,
             "temp": m.temp_size_in_bytes, "alias": m.alias_size_in_bytes,
             "peak": m.peak_memory_in_bytes}]
save_json(out)
"""


@pytest.fixture(scope="module")
def port_run():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", PORT_CHILD % (VS_CELLS,)], env=env,
                          capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = next(ln for ln in proc.stdout.splitlines() if ln.startswith("JSON"))
    return json.loads(line[4:])


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    return run_child(JAX_CHILD % (VS_CELLS,), tmp_path_factory.mktemp("dry"), devices=512,
                     timeout=900)


# the JAX dry-run record's keys (launch/dryrun.py run_cell)
JAX_KEYS = {"arch", "shape", "mesh", "variant", "memory", "cost", "hlo_cost", "memory_model",
            "local_bytes", "roofline", "roofline_hlo_bytes", "status", "devices", "lower_s",
            "compile_s", "params_total", "params_active", "param_bytes_total",
            "param_bytes_per_device_fsdp", "model_flops_global", "model_flops_per_device",
            "useful_compute_ratio"}


@pytest.mark.parametrize("i,kind", [(0, "train"), (1, "prefill"), (2, "decode")])
def test_smoke_cells_render(port_run, i, kind):
    rec = port_run["cells"][i]
    assert rec["status"] == "ok", rec
    assert JAX_KEYS <= set(rec)
    assert set(rec["hlo_cost"]) == {"flops", "bytes", "collective_bytes", "collective_by_op",
                                    "n_while", "trip_counts"}
    assert rec["hlo_cost"]["flops"] > 0 and rec["hlo_cost"]["collective_bytes"] > 0
    mem = rec["memory"]
    assert rec["devices"] == 4 and mem["code_bytes"] is None
    assert mem["peak_bytes"] >= mem["argument_bytes"] + mem["temp_bytes"] > 0
    table = fmt_table([rec])
    assert "| qwen2-0.5b |" in table and "| ok |" in table


def test_one_device_flops_equal_the_real_step(port_run):
    assert port_run["one"]["dry"] == port_run["one"]["real"] > 0
    assert port_run["one"]["trips"] == {"stage 0": 4}


def test_build_cell_local_bytes_equal_jax(port_run, jax_run):
    assert port_run["meta"] == jax_run["meta"]


def test_dense_smoke_flops_beside_jax(port_run, jax_run):
    port, ref = port_run["dense"], jax_run["dense_flops"]
    print(f"dense smoke cell: port {port:.6e} FLOPs, JAX {ref:.6e}, ratio {port / ref:.4f}")
    assert 0.95 * ref <= port <= 1.05 * ref, (port, ref, port / ref)


def _vs(port_run, jax_run, cell):
    key = f"{cell[0]}/{cell[1]}/{cell[5]}"
    return key, port_run["vs_jax"][key], jax_run["vs_jax"][key]


@pytest.mark.parametrize("cell", VS_CELLS, ids=lambda c: f"{c[0]}-{c[1]}-{c[5]}")
def test_mesh_flops_beside_jax(port_run, jax_run, cell):
    key, port_rec, jax_rec = _vs(port_run, jax_run, cell)
    (status, port, replicated, rules, coll, _), (ref, ref_coll, _) = port_rec, jax_rec
    lo, hi = BANDS[cell[2]]
    if key in HELD:  # within 5% of the measured ratio, and at least 0.85
        r, why = HELD[key]
        lo, hi = max(0.95 * r, 0.85), 1.05 * r
    print(f"{key} on (2, 2): port {port:.6e} FLOPs a device, JAX {ref:.6e}, "
          f"ratio {port / ref:.4f} (held: {HELD.get(key, ('-', 'no'))[1]}); collective bytes "
          f"port {coll:.6e}, JAX {ref_coll:.6e}, ratio {coll / ref_coll:.3f}; rules {rules}")
    assert status == "ok" and replicated == {}
    assert lo * ref <= port <= hi * ref, (port, ref, port / ref)


@pytest.mark.parametrize("cell", VS_CELLS, ids=lambda c: f"{c[0]}-{c[1]}-{c[5]}")
def test_mesh_argument_bytes_equal_jax(port_run, jax_run, cell):
    _, port, ref = _vs(port_run, jax_run, cell)
    assert port[5]["argument_bytes"] == ref[2]["argument"]


@pytest.mark.parametrize("cell", VS_CELLS, ids=lambda c: f"{c[0]}-{c[1]}-{c[5]}")
def test_mesh_peak_beside_jax(port_run, jax_run, cell):
    key, port, ref = _vs(port_run, jax_run, cell)
    m, j = port[5], ref[2]
    heap = j["argument"] + j["temp"] + j["output"] - j["alias"]
    print(f"{key} on (2, 2): port peak {m['peak_bytes']} B (temp {m['temp_bytes']}), JAX "
          f"peak_bytes {j['peak']}, JAX heap {heap} (temp {j['temp']}), "
          f"ratio {m['peak_bytes'] / heap:.3f}")
    assert PEAK_BAND[0] * heap <= m["peak_bytes"] <= PEAK_BAND[1] * heap


def test_propagation_error_fails_the_step(port_run):
    assert port_run["conv"].startswith("DTensor cannot run aten.convolution"), port_run["conv"]


def test_missing_strategy_is_counted_and_fails_the_cell(port_run):
    g = port_run["gram"]
    assert g["ops"] == {"repro_dryrun_test.gram.default": 1}
    assert g["rep_coll"] == g["coll"] > 0
    assert g["replicated"] == [True, True]
    assert g["status"][0] == "error" and "repro_dryrun_test.gram" in g["status"][1]
