"""The port's sharding rules (``repro_torch.distributed.sharding``) and
memory estimator (``distributed.estimator``) against the JAX package's.

* leaf for leaf, the specs of ``param_shardings`` / ``cache_shardings`` on
  the (16, 16) and (2, 16, 16) production meshes, for the parameter tree,
  the AdamW and Adafactor states and the decode cache (at decode_32k, as
  the dry-run's ``build_cell`` makes it) of all ten full configurations.
  Shape-only on both sides: ``jax.eval_shape`` in a child process with 512
  forced host devices (as the JAX dry-run forces them) against the port's
  model on the ``meta`` device;
* ``_local_bytes`` and ``estimate_memory_bytes`` for every (arch, shape,
  mesh), exactly (integer and f64 arithmetic);
* ``_raw_spec`` (``tests/test_sharding.py``'s cases), the divisibility
  fallback, the dedupe of ``logical_spec`` and ``set_rule`` with the
  dry-run's ``_reset_rules``.
"""
import math

import pytest
import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.context import Mesh
from repro_torch.distributed.estimator import _local_bytes, estimate_memory_bytes
from repro_torch.launch.dryrun import _reset_rules, cell_config, datastore_local
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.convert import jax_cache_tree, jax_tree
from repro_torch.models.model import Model
from repro_torch.optim.optimizer import get_optimizer
from repro_torch.tree import tree_flatten_with_path

from torch_jax_child import run_child

CHILD = """
import jax, jax.numpy as jnp
from repro.configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from repro.distributed import sharding as shd
from repro.distributed.estimator import _local_bytes, estimate_memory_bytes
from repro.launch.dryrun import _abstract_datastore, _reset_rules
from repro.launch.mesh import make_production_mesh
from repro.distributed import context as dctx
from repro.models.model import Model
from repro.optim.optimizer import get_optimizer

def spec(s):
    return [list(e) if isinstance(e, tuple) else e for e in s.spec]

def flat(tree, shards):
    return {shd._path_str(p): spec(s) for (p, _), s in
            zip(jax.tree_util.tree_flatten_with_path(tree)[0], jax.tree.leaves(shards))}

_reset_rules()
out = {}
for arch in ARCH_IDS:
    base = get_config(arch)
    model = Model(base)
    params = jax.eval_shape(lambda: model.init(jax.random.key(0)))
    opts = {n: jax.eval_shape(get_optimizer(n).init, params) for n in ("adamw", "adafactor")}
    dec = SHAPES["decode_32k"]
    caches = {n: jax.eval_shape(lambda s=s: model.init_cache(s.global_batch, s.seq_len))
              for n, s in SHAPES.items() if s.kind != "train"}
    for mk in ("single", "multi"):
        mesh = make_production_mesh(multi_pod=(mk == "multi"))
        ps = shd.param_shardings(params, mesh)
        rec = {"params": flat(params, ps)}
        for n, o in opts.items():
            rec[n] = flat(o, shd.param_shardings(o, mesh))
        cs = shd.cache_shardings(caches["decode_32k"], mesh)
        rec["cache"] = flat(caches["decode_32k"], cs)
        rec["params_local"] = _local_bytes(params, ps)
        rec["opt_local"] = _local_bytes(opts[base.optimizer],
                                        shd.param_shardings(opts[base.optimizer], mesh))
        rec["cache_local"] = {n: _local_bytes(c, shd.cache_shardings(c, mesh))
                              for n, c in caches.items()}
        mem = {}
        for sn, shape in SHAPES.items():
            cfg = base
            if sn in ("decode_32k", "long_500k"):
                cfg = cfg.replace(retrieval=cfg.retrieval.__class__(
                    enabled=True, k=8, datastore_size=16384, key_dim=512))
            if not shape_applicable(cfg, shape):
                continue
            ds_local = 0
            if shape.kind == "decode":
                ds = _abstract_datastore(cfg, mesh)
                leaves = [x for x in (ds.keys, ds.values, ds.scale, ds.proj) if x is not None]
                ds_local = sum(x.size * x.dtype.itemsize for x in leaves) // dctx.model_axis_size(mesh)
            mem[sn] = {"ds": ds_local, "est": estimate_memory_bytes(
                cfg, shape, mesh, params_local=rec["params_local"],
                opt_local=rec["opt_local"] if shape.kind == "train" else 0,
                cache_local=rec["cache_local"].get(sn, 0) if shape.kind != "train" else 0,
                datastore_local=ds_local)}
        rec["mem"] = mem
        out[f"{arch}/{mk}"] = rec
save_json(out)
"""


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return run_child(CHILD, tmp_path_factory.mktemp("shard"), devices=512, timeout=900)


def _spec_json(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _flat(tree, specs):
    return {shd._path_str(p): _spec_json(s) for (p, _), s in
            zip(tree_flatten_with_path(tree), [s for _, s in tree_flatten_with_path(specs, tree)])}


@pytest.fixture(scope="module")
def port_trees():
    out = {}
    for arch in ARCH_IDS:
        model = Model(get_config(arch), device="meta", seed=None)
        params = jax_tree(model)
        opts = {n: get_optimizer(n).init(params) for n in ("adamw", "adafactor")}
        caches = {n: jax_cache_tree(model, model.init_cache(s.global_batch, s.seq_len))
                  for n, s in SHAPES.items() if s.kind != "train"}
        out[arch] = (model.cfg, params, opts, caches)
    return out


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_and_bytes_equal_jax(jax_ref, port_trees, arch, mesh_kind):
    _reset_rules()
    ref = jax_ref[f"{arch}/{mesh_kind}"]
    base, params, opts, caches = port_trees[arch]
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    ps = shd.param_shardings(params, mesh)
    assert _flat(params, ps) == ref["params"]
    for n, o in opts.items():
        assert _flat(o, shd.param_shardings(o, mesh)) == ref[n], n
    assert _flat(caches["decode_32k"], shd.cache_shardings(caches["decode_32k"], mesh)) \
        == ref["cache"]
    params_local = _local_bytes(params, ps, mesh)
    opt = opts[base.optimizer]
    opt_local = _local_bytes(opt, shd.param_shardings(opt, mesh), mesh)
    assert (params_local, opt_local) == (ref["params_local"], ref["opt_local"])
    cache_local = {n: _local_bytes(c, shd.cache_shardings(c, mesh), mesh)
                   for n, c in caches.items()}
    assert cache_local == ref["cache_local"]
    for sn, shape in SHAPES.items():
        cfg = cell_config(arch, sn)
        if not shape_applicable(cfg, shape):
            assert sn not in ref["mem"]
            continue
        ds = datastore_local(cfg, mesh) if shape.kind == "decode" else 0
        assert ds == ref["mem"][sn]["ds"]
        est = estimate_memory_bytes(
            cfg, shape, mesh, params_local=params_local,
            opt_local=opt_local if shape.kind == "train" else 0,
            cache_local=cache_local.get(sn, 0) if shape.kind != "train" else 0,
            datastore_local=ds)
        assert est == ref["mem"][sn]["est"], sn


def test_raw_spec_cases():
    # tests/test_sharding.py's cases
    assert shd._raw_spec("stages/0/u0/attn/wq", 4) == ["none", "fsdp", "heads", "none"]
    assert shd._raw_spec("stages/0/u0/mlp/w_out", 3) == ["none", "mlp", "fsdp"]
    assert shd._raw_spec("v/stages/0/u0/mlp/w_in/vr", 2) == ["none", "fsdp"]
    assert shd._raw_spec("v/stages/0/u0/mlp/w_in/vc", 2) == ["none", "mlp"]
    assert shd._raw_spec("stages/0/u0/moe/w_in", 4) == ["none", "expert", "fsdp", "none"]
    assert shd._raw_spec("final_norm", 1) == ["none"]


def test_divisibility_fallback_and_dedupe():
    mesh = Mesh(shape=(2, 4), axis_names=("data", "model"))
    # 14 heads do not split 4 ways: replicated; 64 splits over data
    assert shd.spec_for_param("stages/0/u0/attn/wq", (3, 64, 14, 64), mesh) \
        == (None, "data", None, None)
    assert shd.spec_for_param("embed", (1000, 64), mesh) == ("model", "data")
    assert shd.spec_for_param("embed", (1002, 64), mesh) == (None, "data")
    # a mesh axis shards one dim only, first come first served
    assert shd.logical_spec((8, 16, 12), ("batch", "vocab", "heads"), mesh) \
        == ("data", "model", None)
    assert shd.logical_spec((8, 16), (None, "vocab"), mesh) == (None, "model")
    assert shd.batch_spec(mesh, (8, 5)) == ("data", None)
    assert shd.batch_spec(mesh, (7, 5)) == (None, None)
    multi = make_production_mesh(multi_pod=True)
    assert shd.batch_spec(multi, (64, 5)) == (("pod", "data"), None)
    assert shd.logical_constraint(torch.ones(8, 16), ("batch", "vocab")).shape == (8, 16)


def test_set_rule_and_reset():
    mesh = make_production_mesh()
    try:
        shd.set_rule("fsdp", ())
        assert shd.spec_for_param("lm_head", (1024, 4096), mesh) == (None, "model")
        shd.set_rule("heads", ())
        shd.set_rule("fsdp", ("pod", "data", "model"))
        assert shd.spec_for_param("stages/0/u0/attn/wq", (1024, 16, 64), mesh) \
            == (("data", "model"), None, None)
    finally:
        _reset_rules()
    assert shd.LOGICAL_AXES["fsdp"] == ("pod", "data") and shd.LOGICAL_AXES["heads"] == ("model",)
    assert math.prod(mesh.shape.values()) == 256
