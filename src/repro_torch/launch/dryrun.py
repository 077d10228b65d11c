"""Multi-pod dry-run of the port: the per-device program of every
(architecture x input-shape) cell on the production meshes, without the
devices (the port of the JAX package's ``repro/launch/dryrun.py``).

    python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--mesh single|multi|both] [--variant V]

The JAX dry-run forces 512 host devices, lowers the partitioned step and
reads XLA's analyses.  Torch has no partitioner that runs a program over
absent devices; its nearest counterpart of GSPMD is ``DTensor``'s sharding
propagation.  So each cell runs once, in this process, as rank 0 of a fake
process group of 256 / 512 ranks, on ``meta`` tensors (no storage, no
device):

* the step of ``build_cell`` (the train step, prefill, or one decode step
  with retrieval) on ``DTensor`` parameters, optimizer state, cache and
  batch placed by the port's sharding rules (``distributed/sharding.py``,
  resolved on the JAX leaves of ``models.convert.jax_tree``);
* a fused parameter (``wqkv``, ``w_gate_in``) keeps the placement its JAX
  leaves agree on for its leading dims and is replicated along its fused
  last dim (the JAX package shards ``wq`` by heads but not ``wk``/``wv``);
  its local bytes in the record are the JAX leaves' all the same;
* ``sharding.logical_constraint`` redistributes at the JAX package's
  constraint sites; the MoE layer's expert-parallel paths, the split
  retrieval scan, the attention core (its query heads split as ``wq``,
  its KV heads as ``wk`` / ``wv``; a decode step's cache positions split
  as the rules place the cache, the softmax's max and sum reduced), the
  fused QKV and SwiGLU products, the head, RWKV's time and channel mixes
  and Mamba's scan run each device's program
  (``distributed.context.shard_map`` under ``local_map``), as GSPMD
  partitions the JAX package's; the scan on the kernels' plain versions,
  as the JAX dry-run on the CPU lowers the jnp reference;
* ``distributed/step_cost.analyze_step`` counts the FLOPs and bytes each
  device runs, the collectives by kind, and the live bytes on each device
  (its ledger: from the step's arguments, every storage a local op makes
  until it dies).  An error of DTensor's propagation fails the cell
  (``status: error``, the op named); an op DTensor has no strategy for
  runs on gathered inputs, is named in ``replicated_ops``, and a cell
  whose replicated ops carry more than ``REPLICATED_LIMIT`` of its FLOPs
  or collective bytes is an error too;
* a model's scanned stage is measured at two and three repeats of its unit
  and folded to its depth (``StepCost.fold``), and each Mamba or RWKV time
  loop runs four trips folded to its length (``step_cost.TimeSteps``,
  inside each run): the record's ``n_while`` and ``trip_counts`` name the
  stage and the loops, as the JAX package folds a scan body by its trip
  count, a ``while`` in a ``while``.

Records go to ``experiments/dryrun_torch/<arch>_<shape>_<mesh>[__variant].json``
with the JAX record's keys and meanings (``benchmarks/roofline.py``'s
``fmt_table`` renders them); the roofline terms use the H100 constants of
``distributed/roofline.py``.  ``memory`` has the JAX record's keys: the argument
bytes (the JAX package's prefill makes its cache, so there it is an
output), the output bytes, and the ledger's peak and temporaries (the
peak beyond the arguments and the new outputs); ``code_bytes`` is null,
there is no compiled program.  DTensor 2.11 (the card machine's) lacks
strategies 2.13 has: ``step_cost``'s own lowerings cover the ones the
cells reach (a pad, a depthwise convolution, an add of a partial sum).
The exit status is 1 if any cell failed.  The fake process group is per
process: call ``run_cell`` in a process of its own (tests do, in a child).
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path

import torch
from torch import nn

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data.pipeline import make_batch_specs
from repro_torch.distributed import context as dctx
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.context import Mesh
from repro_torch.distributed.estimator import _local_bytes, estimate_memory_bytes
from repro_torch.distributed.roofline import axis_link_bw, roofline_terms
from repro_torch.distributed.step_cost import analyze_step
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.convert import _whole, jax_cache_tree, jax_tree
from repro_torch.models.model import Model
from repro_torch.models.transformer import plan_stages
from repro_torch.optim.optimizer import get_optimizer
from repro_torch.optim.schedule import cosine_with_warmup
from repro_torch.serve.retrieval import Datastore
from repro_torch.train.train_step import init_train_state, make_train_step
from repro_torch.tree import tree_flatten_with_path, tree_unflatten

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

# a cell whose replicated ops (no DTensor strategy) carry more of its FLOPs
# or of its collective bytes than this is not a per-device count
REPLICATED_LIMIT = 0.01

CODE_NOTE = "no compiled program: the step runs eagerly, op by op"


# ---------------------------------------------------------------------------
# the fake process group and DTensor placement
# ---------------------------------------------------------------------------


def device_mesh(mesh: Mesh):
    """A torch ``DeviceMesh`` of ``mesh``'s shape and names over a fake
    process group of ``mesh.size`` ranks, this process rank 0.  The batch
    axes are merged into one mesh dim ("pod+data"; the rules shard over
    both or neither): DTensor's strategy search grows with the mesh's
    dims, and three took minutes a layer."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    n = mesh.size
    if dist.is_initialized() and dist.get_world_size() != n:
        dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    batch = dctx.batch_axes(mesh)
    names, shape = [], []
    if batch:
        names.append("+".join(batch))
        shape.append(math.prod(mesh.shape[a] for a in batch))
    for a in mesh.axis_names:
        if a not in batch:
            names.append(a)
            shape.append(mesh.shape[a])
    return DeviceMesh("cpu", torch.arange(n).reshape(shape), mesh_dim_names=tuple(names))


def _dtensor(t: torch.Tensor, dmesh, spec) -> torch.Tensor:
    """A meta ``DTensor`` of ``t``'s shape and dtype placed by ``spec``."""
    from torch.distributed.tensor import DTensor, Shard

    names = dmesh.mesh_dim_names
    pl = shd.placements(spec, names)
    local = list(t.shape)
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            local[p.dim] //= dmesh.size(i)
    loc = torch.empty(local, dtype=t.dtype, device="meta")
    return DTensor.from_local(loc, dmesh, pl, run_check=False, shape=t.shape,
                              stride=torch.empty(t.shape, device="meta").stride())


def _param_specs(model: Model, mesh: Mesh) -> dict:
    """Each parameter's spec from its JAX leaves' (``jax_tree``): a whole
    leaf's as it is (less a scanned stage's axis), a fused parameter's the
    entries its views agree on along its leading dims, replicated along its
    fused last dim."""
    views: dict[nn.Parameter, list] = {}
    for path, leaf in tree_flatten_with_path(jax_tree(model)):
        spec = shd.spec_for_param(shd._path_str(path), leaf.shape, mesh)
        for p, view in leaf.parts:
            views.setdefault(p, []).append((spec[1:] if leaf.stacked else spec, view))
    out = {}
    for p, vs in views.items():
        if len(vs) == 1 and vs[0][1] is _whole:
            out[p] = vs[0][0]
            continue
        lead = [e if all(v[0][i] == e for v in vs) else None
                for i, e in enumerate(vs[0][0][:p.ndim - 1])]
        out[p] = tuple(lead) + (None,)
    return out


def place_model(model: Model, mesh: Mesh, dmesh) -> None:
    """Replace every parameter of ``model`` by a meta DTensor placed by the
    rules."""
    specs = _param_specs(model, mesh)
    for mod in model.modules():
        for name, p in list(mod.named_parameters(recurse=False)):
            setattr(mod, name, nn.Parameter(_dtensor(p.detach(), dmesh, specs[p]),
                                            requires_grad=p.requires_grad))
    for mod in model.modules():
        if hasattr(mod, "c"):
            mod.c = {}


def _place_tree(tree, specs, dmesh):
    pairs = tree_flatten_with_path(tree)
    flat_specs = [s for _, s in tree_flatten_with_path(specs, tree)]
    return tree_unflatten(tree, [_dtensor(x, dmesh, s) for (_, x), s in zip(pairs, flat_specs)])


def _place_cache(model: Model, cache: list, mesh: Mesh, dmesh) -> list:
    """The port's cache (one flat dict a sub-layer) as DTensors placed by
    the JAX cache tree's specs (less a scanned stage's axis)."""
    tree = jax_cache_tree(model, cache)
    spec_of: dict[int, tuple] = {}
    for path, leaf in tree_flatten_with_path(tree):
        spec = shd.spec_for_cache(shd._path_str(path), tuple(leaf.shape), mesh)
        parts = getattr(leaf, "parts", None)
        for t in (parts if parts is not None else [leaf]):
            spec_of[id(t)] = spec[1:] if parts is not None else spec
    return [{n: _dtensor(t, dmesh, spec_of[id(t)]) for n, t in lane.items()} for lane in cache]


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------


def cell_config(arch: str, shape_name: str, variant: str = "baseline",
                base: ModelConfig | None = None) -> ModelConfig:
    """The configuration a cell runs (``base``, by default the arch's full
    one): decode cells enable retrieval over a 16,384-row store of
    512-wide keys (the JAX dry-run's), then the variant's mutation (which
    may change the rule table)."""
    cfg = base if base is not None else get_config(arch)
    if shape_name in ("decode_32k", "long_500k"):
        cfg = cfg.replace(retrieval=cfg.retrieval.__class__(
            enabled=True, k=8, datastore_size=16384, key_dim=512))
    return VARIANTS[variant](cfg)


def _datastore(cfg: ModelConfig, mesh: Mesh, device="meta") -> Datastore:
    """The retrieval store stand-in: ``datastore_size`` rows an island of
    the model axis (the JAX dry-run's)."""
    r = cfg.retrieval
    n = r.datastore_size * dctx.model_axis_size(mesh)
    kd = r.key_dim or cfg.d_model
    kdt = torch.int8 if r.quantized else torch.float32
    return Datastore(
        keys=torch.empty((n, kd), dtype=kdt, device=device),
        values=torch.zeros((n,), dtype=torch.int32, device=device),
        scale=torch.empty((n,), dtype=torch.float32, device=device) if r.quantized else None,
        proj=torch.empty((cfg.d_model, kd), dtype=torch.float32, device=device)
        if kd != cfg.d_model else None)


def datastore_local(cfg: ModelConfig, mesh: Mesh) -> int:
    """The JAX package's ``datastore_local``: the store's bytes over the
    model axis (its projection too)."""
    ds = _datastore(cfg, mesh)
    leaves = [x for x in (ds.keys, ds.values, ds.scale, ds.proj) if x is not None]
    return sum(x.numel() * x.element_size() for x in leaves) // dctx.model_axis_size(mesh)


def datastore_held(cfg: ModelConfig, mesh: Mesh) -> int:
    """The store's bytes a device holds: its rows' share, the projection
    whole (it is replicated)."""
    ds = _datastore(cfg, mesh)
    rows = [x for x in (ds.keys, ds.values, ds.scale) if x is not None]
    proj = 0 if ds.proj is None else ds.proj.numel() * ds.proj.element_size()
    return sum(x.numel() * x.element_size() for x in rows) // dctx.model_axis_size(mesh) + proj


def _batch(cfg: ModelConfig, shape: ShapeConfig, device, seed: int = 0) -> dict:
    """The cell's batch: random tokens on a real device, empty on meta."""
    out = {}
    g = torch.Generator().manual_seed(seed)
    for k, spec in make_batch_specs(cfg, shape).items():
        dt = spec.dtype if isinstance(spec.dtype, torch.dtype) else getattr(torch, str(spec.dtype))
        if torch.device(device).type == "meta":
            out[k] = torch.empty(spec.shape, dtype=dt, device="meta")
        elif dt.is_floating_point:
            out[k] = torch.randn(spec.shape, generator=g).to(device, dt)
        else:
            out[k] = torch.randint(0, cfg.vocab_size, spec.shape, generator=g).to(device, dt)
    return out


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh, *, dmesh=None,
               device="meta"):
    """(fn, args, meta) for one cell.  With ``dmesh`` (``device_mesh(mesh)``)
    the state and inputs are meta DTensors placed by the rules; without it
    they are plain tensors on ``device`` (a real device gets seed-0 weights
    and random tokens: the same step, run for real)."""
    meta_dev = torch.device(device).type == "meta"
    model = Model(cfg, device=device, seed=None if meta_dev else 0)
    params = jax_tree(model)
    pspec = shd.param_shardings(params, mesh)
    meta = {"params_local": _local_bytes(params, pspec, mesh),
            "opt_local": 0, "cache_local": 0, "datastore_local": 0}
    batch = _batch(cfg, shape, device)
    if dmesh is not None:
        place_model(model, mesh, dmesh)
        batch = {k: _dtensor(v, dmesh, shd.batch_spec(mesh, tuple(v.shape)))
                 for k, v in batch.items()}

    if shape.kind == "train":
        opt = get_optimizer(cfg.optimizer)
        step_fn = make_train_step(
            model, opt, cosine_with_warmup(3e-4, 100, 10_000),
            grad_dtype="bfloat16" if cfg.param_dtype == "bfloat16" else "float32")
        state = init_train_state(model, opt)
        ospec = shd.param_shardings(state["opt"], mesh)
        meta["opt_local"] = _local_bytes(state["opt"], ospec, mesh)
        if dmesh is not None:
            state["opt"] = _place_tree(state["opt"], ospec, dmesh)
        return step_fn, (state, batch), meta

    cache = model.init_cache(shape.global_batch, shape.seq_len)
    ctree = jax_cache_tree(model, cache)
    meta["cache_local"] = _local_bytes(ctree, shd.cache_shardings(ctree, mesh), mesh)
    if dmesh is not None:
        cache = _place_cache(model, cache, mesh, dmesh)

    if shape.kind == "prefill":
        def prefill_fn(batch, cache):
            logits, cache = model.prefill(batch["tokens"], frames=batch.get("frames"),
                                          patches=batch.get("patches"),
                                          max_len=shape.seq_len, cache=cache)
            return logits[:, -1, :], cache

        return prefill_fn, (batch, cache), meta

    # decode: one token against a full-length cache, retrieval enabled
    ds = _datastore(cfg, mesh, device)
    meta["datastore_local"] = datastore_local(cfg, mesh)
    if dmesh is not None:
        row, rep = ("model",), ()
        ds = Datastore(
            keys=_dtensor(ds.keys, dmesh, row + (None,)),
            values=_dtensor(ds.values, dmesh, row),
            scale=None if ds.scale is None else _dtensor(ds.scale, dmesh, row),
            proj=None if ds.proj is None else _dtensor(ds.proj, dmesh, rep + (None, None)))

    def decode_fn(tokens, cache, pos, datastore):
        return model.decode_step(tokens, cache, pos, datastore=datastore)

    pos = torch.zeros((), dtype=torch.int32, device=device)
    return decode_fn, (batch["tokens"], cache, pos, ds), meta


# ---------------------------------------------------------------------------
# Perf-iteration variants (the JAX package's): named config/rule mutations.
# 'baseline' is the paper-faithful / naive-TP configuration.
# ---------------------------------------------------------------------------


def _v_baseline(cfg):
    return cfg


def _v_seqtp(cfg):
    """Sequence-parallel TP: pin sub-layer outputs seq-sharded."""
    return cfg.replace(constrain_sublayer_outputs=True, seq_shard_activations=True)


def _v_zero3(cfg):
    """Pure ZeRO-3: no tensor parallelism; params FSDP over every mesh axis."""
    shd.set_rule("heads", ())
    shd.set_rule("mlp", ())
    shd.set_rule("vocab", ())
    shd.set_rule("tensor", ())
    shd.set_rule("fsdp", ("pod", "data", "model"))
    return cfg.replace(seq_shard_activations=False, constrain_sublayer_outputs=False)


def _v_zero3_seqtp(cfg):
    cfg = _v_zero3(cfg)
    return cfg.replace(seq_shard_activations=True, constrain_sublayer_outputs=True)


def _v_quantized_ds(cfg):
    r = cfg.retrieval
    return cfg.replace(retrieval=r.__class__(
        enabled=r.enabled, k=r.k, lam=r.lam, temperature=r.temperature,
        datastore_size=r.datastore_size, key_dim=r.key_dim, quantized=True))


def _v_servetp(cfg):
    """Inference sharding: weights replicated over the batch axes, TP kept."""
    shd.set_rule("fsdp", ())
    return cfg


def _v_zero3v(cfg):
    """ZeRO-3 + seq-sharded residuals, vocab/logits TP-sharded."""
    cfg = _v_zero3_seqtp(cfg).replace(grad_accum=1)
    shd.set_rule("vocab", ("model",))
    return cfg


def _v_a2amoe(cfg):
    """All-to-all EP dispatch."""
    return cfg.replace(moe_a2a=True, grad_accum=1,
                       seq_shard_activations=True, constrain_sublayer_outputs=True)


VARIANTS = {
    "baseline": _v_baseline,
    "zero3v-ga1": _v_zero3v,
    "a2amoe-ga1": _v_a2amoe,
    "seqtp": _v_seqtp,
    "zero3": _v_zero3,
    "zero3-seqtp": _v_zero3_seqtp,
    "zero3-seqtp-ga1": lambda c: _v_zero3_seqtp(c).replace(grad_accum=1),
    "seqtp-ga2": lambda c: _v_seqtp(c).replace(grad_accum=2),
    "seqtp-ga1": lambda c: _v_seqtp(c).replace(grad_accum=1),
    "ga16": lambda c: c.replace(grad_accum=16),
    "ga2": lambda c: c.replace(grad_accum=2),
    "ga1": lambda c: c.replace(grad_accum=1),
    "noremat": lambda c: c.replace(remat="none"),
    "int8ds": _v_quantized_ds,
    "servetp": _v_servetp,
    "servetp-int8ds": lambda c: _v_quantized_ds(_v_servetp(c)),
}


def _reset_rules() -> None:
    shd.set_rule("heads", ("model",))
    shd.set_rule("mlp", ("model",))
    shd.set_rule("vocab", ("model",))
    shd.set_rule("tensor", ("model",))
    shd.set_rule("fsdp", ("pod", "data"))
    shd.set_rule("seq", ())


def _fold(cfg: ModelConfig):
    """(config with the last stage at two units, at three units, its depth)
    when that stage is scanned and deeper than three units, else None: the
    cell is measured at both and folded (``StepCost.fold``).  Two and three,
    not one and two: a stage of one unit stacks its leaves for the update
    otherwise than a deeper one does."""
    st = plan_stages(cfg)[-1]
    if not st.scan or st.n <= 3:
        return None
    two = cfg.num_layers - (st.n - 2) * len(st.unit)
    return cfg.replace(num_layers=two), cfg.replace(num_layers=two + len(st.unit)), st.n


def param_counts(cfg: ModelConfig) -> tuple[int, float, int]:
    """(total parameters, active parameters, total parameter bytes) of the
    JAX leaves: a routed expert counts top_k / E of its size as active."""
    model = Model(cfg, device="meta", seed=None)
    n_total = n_expert = n_bytes = 0
    for path, leaf in tree_flatten_with_path(jax_tree(model)):
        pstr = "/".join(str(p) for p in path)
        size = math.prod(leaf.shape)
        n_total += size
        n_bytes += size * leaf.dtype.itemsize
        if "/moe/w_" in pstr and "/shared/" not in pstr:
            n_expert += size
    if cfg.moe is not None:
        n_active = (n_total - n_expert) + n_expert * cfg.moe.top_k / cfg.moe.num_experts
    else:
        n_active = n_total
    return n_total, n_active, n_bytes


def cell_status(cost) -> tuple[str, str | None]:
    """("ok", None), or ("error", why) where the ops run replicated (no
    DTensor strategy) carry more than ``REPLICATED_LIMIT`` of the step's
    FLOPs or collective bytes: then the count is not a per-device one."""
    share = max(cost.replicated_flops / cost.flops if cost.flops else 0.0,
                cost.replicated_coll_bytes / cost.coll_bytes if cost.coll_bytes else 0.0)
    if share <= REPLICATED_LIMIT:
        return "ok", None
    return "error", (f"ops without a sharding strategy, run replicated, carry {share:.2%} of "
                     f"the FLOPs or collective bytes (limit {REPLICATED_LIMIT:.0%}): "
                     f"{cost.replicated_ops}")


def run_cell(arch: str, shape_name: str, mesh_kind: str, variant: str = "baseline", *,
             mesh: Mesh | None = None, shape: ShapeConfig | None = None,
             base: ModelConfig | None = None, fold_loops: bool = True) -> dict:
    """One cell's record.  ``mesh`` / ``shape`` / ``base`` stand in for the
    production mesh, the named shape and the arch's full configuration (a
    small abstract mesh, another batch, a smoke configuration);
    ``fold_loops=False`` runs the time loops unrolled."""
    from torch.distributed.tensor.experimental import implicit_replication

    _reset_rules()  # variants mutate the rule table
    cfg = cell_config(arch, shape_name, variant, base)
    shape = shape or SHAPES[shape_name]
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "variant": variant}
    if not shape_applicable(cfg, shape):
        rec["status"] = "skipped"
        rec["reason"] = "long_500k requires sub-quadratic attention (DESIGN.md §5)"
        return rec
    mesh = mesh or make_production_mesh(multi_pod=(mesh_kind == "multi"))
    n_dev = mesh.size
    dmesh = device_mesh(mesh)
    fold = _fold(cfg)
    with dctx.use_mesh(mesh):
        shd.set_rule("seq", ("model",) if cfg.seq_shard_activations else ())
        _, _, meta = build_cell(cfg, shape, mesh)  # the full depth's local bytes
        # what the port's step takes (the train state's step and decode's
        # position are int32 scalars); the JAX package's prefill makes the
        # cache that the port's writes in place, so JAX counts it an output
        held = meta["params_local"] + meta["opt_local"] + meta["cache_local"] + sum(
            math.prod(v.shape) * v.dtype.itemsize // max(
                math.prod(mesh.shape[a] for a in dctx.batch_axes(mesh)), 1)
            for v in make_batch_specs(cfg, shape).values())
        held += 4 if shape.kind in ("train", "decode") else 0
        held += datastore_held(cfg, mesh) if shape.kind == "decode" else 0
        jax_args = held - (meta["cache_local"] if shape.kind == "prefill" else 0)
        runs = []
        t_lower = t_compile = 0.0
        for c in ([cfg] if fold is None else fold[:2]):
            t1 = time.time()
            fn, args, m = build_cell(c, shape, mesh, dmesh=dmesh)
            # the ledger starts from this depth's argument bytes
            start = held - sum(meta[k] - m[k] for k in ("params_local", "opt_local", "cache_local"))
            t2 = time.time()
            with implicit_replication():
                cost, out = analyze_step(fn, *args, arg_bytes=start, fold_loops=fold_loops)
            runs.append(cost)
            t_lower += t2 - t1
            t_compile += time.time() - t2
            del fn, args, out
    cost, trips = runs[0], None
    if fold is not None and any(getattr(runs[1], f) < getattr(runs[0], f)
                                for f in ("flops", "bytes", "coll_bytes")):
        raise ValueError("the step's counts do not grow with its scanned stage's depth: "
                         f"two units {runs[0]}, three {runs[1]}")
    if fold is not None:
        n = fold[2]
        cost = runs[0].fold(runs[1], n, first=2)
        trips = {f"stage {len(plan_stages(cfg)) - 1}": n}
    if cost.trips:
        trips = {**(trips or {}), **cost.trips}
    rec["memory"] = {"argument_bytes": int(jax_args), "output_bytes": int(cost.output_bytes),
                     "temp_bytes": int(cost.temp_bytes), "peak_bytes": int(cost.peak_bytes),
                     "code_bytes": None, "code_note": CODE_NOTE}
    rec["cost"] = {"flops": cost.flops, "bytes accessed": cost.bytes}
    rec["hlo_cost"] = {
        "flops": cost.flops,
        "bytes": cost.bytes,
        "collective_bytes": cost.coll_bytes,
        "collective_by_op": cost.coll_by_op,
        "n_while": None if trips is None else len(trips),  # loops folded
        "trip_counts": trips,
    }
    rec["collective_count_by_op"] = cost.coll_count_by_op
    rec["replicated_ops"] = cost.replicated_ops
    rec["replicated_flops"] = cost.replicated_flops
    rec["replicated_collective_bytes"] = cost.replicated_coll_bytes
    rec["rules"] = cost.rules
    rec["n_ops"] = cost.n_ops
    mem_model = estimate_memory_bytes(
        cfg, shape, mesh,
        params_local=meta["params_local"], opt_local=meta["opt_local"],
        cache_local=meta["cache_local"], datastore_local=meta["datastore_local"])
    rec["memory_model"] = mem_model
    rec["local_bytes"] = dict(meta)
    link = min(axis_link_bw(mesh).values())
    rec["link_bw"] = link
    rec["hardware"] = "NVIDIA H100 SXM data sheet (NVIDIA H100 80GB HBM3, 700 W)"
    rec["roofline"] = roofline_terms(cost.flops, mem_model["total"], cost.coll_bytes,
                                     link_bw=link)
    rec["roofline_hlo_bytes"] = roofline_terms(cost.flops, cost.bytes, cost.coll_bytes,
                                               link_bw=link)
    rec["status"], err = cell_status(cost)
    if err:
        rec["error"] = err
    rec["devices"] = n_dev
    rec["lower_s"] = round(t_lower, 2)
    rec["compile_s"] = round(t_compile, 2)
    n_total, n_active, total_param_bytes = param_counts(cfg)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    model_flops_global = mult * n_active * tokens
    rec["params_total"] = int(n_total)
    rec["params_active"] = int(n_active)
    rec["param_bytes_total"] = int(total_param_bytes)
    rec["param_bytes_per_device_fsdp"] = int(total_param_bytes // n_dev)
    rec["model_flops_global"] = model_flops_global
    rec["model_flops_per_device"] = model_flops_global / n_dev
    rec["useful_compute_ratio"] = (
        rec["model_flops_per_device"] / cost.flops if cost.flops else None)
    return rec


def _cell_in_child(arch: str, shape: str, mesh_kind: str, variant: str, out_dir: Path,
                   timeout: float) -> dict:
    """One cell in a process of its own (``--jobs``), its record read back;
    a cell that does not finish in ``timeout`` s is an error."""
    import os
    import subprocess
    import sys

    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
           "--mesh", mesh_kind, "--variant", variant, "--out", str(out_dir)]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    try:
        subprocess.run(cmd, env=env, capture_output=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        return {"arch": arch, "shape": shape, "mesh": mesh_kind, "variant": variant,
                "status": "error", "error": f"not finished in {timeout:.0f} s"}
    tag = f"{arch}_{shape}_{mesh_kind}" + ("" if variant == "baseline" else f"__{variant}")
    return json.loads((out_dir / f"{tag}.json").read_text())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--variant", choices=list(VARIANTS), default="baseline")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=str(OUT_DIR))
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once, each in a process of its own")
    ap.add_argument("--cell-timeout", type=float, default=3600.0,
                    help="seconds a cell may take with --jobs > 1 before it is an error")
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells = [(a, s, m) for a in archs for s in shapes for m in meshes]

    def one(cell) -> dict:
        arch, shape, mesh_kind = cell
        if args.jobs > 1:
            return _cell_in_child(arch, shape, mesh_kind, args.variant, out_dir,
                                  args.cell_timeout)
        try:
            return run_cell(arch, shape, mesh_kind, args.variant)
        except Exception as e:  # a failed cell is recorded, the others still run
            return {"arch": arch, "shape": shape, "mesh": mesh_kind, "variant": args.variant,
                    "status": "error", "error": f"{type(e).__name__}: {e}",
                    "trace": traceback.format_exc()[-4000:]}

    if args.jobs > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(args.jobs) as pool:
            recs = list(pool.map(one, cells))
    else:
        recs = map(one, cells)
    failures = 0
    for rec in recs:
        tag = f"{rec['arch']}_{rec['shape']}_{rec['mesh']}"
        if args.variant != "baseline":
            tag += f"__{args.variant}"
        (out_dir / f"{tag}.json").write_text(json.dumps(rec, indent=2))
        status = rec["status"]
        failures += status == "error"
        extra = ""
        if status == "ok":
            r = rec["roofline"]
            extra = (f" compute={r['compute_s']:.3e}s mem={r['memory_s']:.3e}s "
                     f"coll={r['collective_s']:.3e}s dom={r['dominant']}"
                     f" run={rec['compile_s']}s replicated={sum(rec['replicated_ops'].values())}")
        elif status == "error":
            extra = " " + rec["error"][:160]
        print(f"[{status:7s}] {tag}{extra}", flush=True)
    print(f"done: {len(cells)} cells, {failures} failures", flush=True)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
