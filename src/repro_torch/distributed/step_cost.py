"""Per-device cost of one step, counted from the ops the device runs: the
port's counterpart of the JAX package's ``repro/distributed/hlo_cost.py``
(and the collective accounting of ``hlo_analysis.py``).

The JAX package compiles the mesh-partitioned program and re-folds its HLO
text with the scans' trip counts.  Torch has no HLO; its per-device
program is the ops a device runs, which ``analyze_step`` sees through a
``TorchDispatchMode`` while it calls the step once:

* FLOPs: ``torch.utils.flop_counter``'s formulas (the ones
  ``FlopCounterMode`` applies) on each op's tensors.  Under the dry-run's
  sharded run the step's tensors are ``DTensor``s; the mode lets DTensor
  lower each op to the local op it runs (``NotImplemented``, as torch's
  ``CommDebugMode`` does) and counts that, so the count is per device,
  never the global product;
* bytes: the operand and result bytes of every op that is not a view (the
  counterpart of XLA's "bytes accessed": every op boundary, no fusion, so
  an upper bound on HBM traffic);
* collective bytes by kind, from the ``_c10d_functional`` ops the sharded
  run issues, by the JAX package's rule (``COLLECTIVE_FACTORS``: traffic
  ~ factor x result bytes; a reduce-scatter's operand bytes).

Python loops are unrolled as they run, so the program has no loop to read
a trip count from.  The dry-run measures a model's scanned stage at one and
at two repeats of its unit and folds the difference to the stage's depth
(``StepCost.fold``), as the JAX package folds a scan body by its trip count.

Some ops have a per-device lowering of their own here (``_RULES``,
counted in ``rules``), the one GSPMD gives them, where DTensor would gather
a whole tensor first (a KV cache, vocab-sharded logits) or refuse:

* an advanced-index read or write (``index``, ``index_put_``) of a tensor
  sharded along an indexed dim, and a ``gather`` along a sharded dim, read
  or write on each device the entries that fall in its shard (the rest
  masked; a read is a partial sum);
* a ``scatter_add`` scatters each device's own entries (``_scatter_add_rule``);
* an ``unbind`` along a sharded dim gathers that dim first;
* where DTensor's own lowering fails (``_RETRY``): a view runs on a
  contiguous copy, or else gathers the dims it changes (an unflatten of
  an unevenly sharded dim) and shards its output over the same mesh dims
  again; an add of inputs whose placements DTensor cannot reconcile
  redistributes them to one placement first.

An op DTensor has no sharding strategy for (DTensor raises
``NotImplementedError`` naming the missing strategy) runs on replicated
inputs: its inputs gathered, the gathers counted (and again in
``replicated_coll_bytes``), the op named in ``replicated_ops`` and its
FLOPs counted again in ``replicated_flops``.  Any
other error of DTensor's propagation is raised: the caller fails the step.
What an attempt that failed had issued is not counted, and an op that
failed once goes straight to its retry the next time it comes with the
same shapes, placements and strides.
"""
from __future__ import annotations

import math
from collections import Counter
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

COLLECTIVE_FACTORS = {
    # traffic per device ~ factor * result_bytes (ring algorithms, large N)
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,   # counted on the operand bytes instead (below)
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

# _c10d_functional op name -> the JAX package's collective kind
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}
_FUNCOL_NAMESPACES = ("_c10d_functional", "c10d_functional", "_c10d_functional_autograd")

# metadata queries a mode may decline (FlopCounterMode's list)
_META_OPS = {
    torch.ops.aten.is_contiguous.default, torch.ops.aten.is_contiguous.memory_format,
    torch.ops.aten.is_strides_like_format.default,
    torch.ops.aten.is_non_overlapping_and_dense.default, torch.ops.aten.size.default,
    torch.ops.aten.sym_size.default, torch.ops.aten.stride.default,
    torch.ops.aten.sym_stride.default, torch.ops.aten.storage_offset.default,
    torch.ops.aten.sym_storage_offset.default, torch.ops.aten.numel.default,
    torch.ops.aten.sym_numel.default, torch.ops.aten.dim.default,
    torch.ops.prim.layout.default,
}


@dataclass
class StepCost:
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_by_op: dict[str, float] = field(default_factory=dict)
    coll_count_by_op: dict[str, int] = field(default_factory=dict)
    n_ops: int = 0
    replicated_ops: dict[str, int] = field(default_factory=dict)
    replicated_flops: float = 0.0
    replicated_coll_bytes: float = 0.0
    rules: dict[str, int] = field(default_factory=dict)

    def copy(self) -> StepCost:
        return StepCost(**{k: dict(v) if isinstance(v, dict) else v
                           for k, v in self.__dict__.items()})

    def fold(self, two: StepCost, n: int) -> StepCost:
        """The cost of ``n`` repeats of a unit, from this run (one repeat)
        and ``two`` (the same program with two): ``self + (n - 1) x (two -
        self)``, every count linear in the repeats (the counterpart of the
        JAX package's scan trip-count fold)."""
        def lin(a, b):
            return a + (n - 1) * (b - a)

        def lin_d(a, b):
            return {k: lin(a.get(k, 0), b.get(k, 0)) for k in {**a, **b}}

        return StepCost(lin(self.flops, two.flops), lin(self.bytes, two.bytes),
                        lin(self.coll_bytes, two.coll_bytes),
                        lin_d(self.coll_by_op, two.coll_by_op),
                        lin_d(self.coll_count_by_op, two.coll_count_by_op),
                        lin(self.n_ops, two.n_ops),
                        lin_d(self.replicated_ops, two.replicated_ops),
                        lin(self.replicated_flops, two.replicated_flops),
                        lin(self.replicated_coll_bytes, two.replicated_coll_bytes),
                        lin_d(self.rules, two.rules))


class PropagationError(RuntimeError):
    """DTensor's propagation of ``func`` failed otherwise than for a missing
    sharding strategy: the step's per-device program is not known."""

    def __init__(self, func, err: BaseException) -> None:
        super().__init__(f"DTensor cannot run {func}: {type(err).__name__}: {err}")
        self.func = func


def _nbytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(t) for t in tree)
    if isinstance(tree, dict):
        return sum(_nbytes(t) for t in tree.values())
    return 0


def collective_bytes(kind: str, operand_bytes: int, result_bytes: int) -> float:
    """One collective's per-device wire bytes by the JAX package's rule."""
    if kind == "reduce-scatter":
        return float(operand_bytes)
    return COLLECTIVE_FACTORS[kind] * result_bytes


def _dtensor_type():
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:  # a torch built without distributed
        return None
    return DTensor


def _fake_active(types) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor

    return (torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None
            or any(issubclass(t, FakeTensor) for t in types))


class _Counter(TorchDispatchMode):
    def __init__(self, cost: StepCost) -> None:
        super().__init__()
        self.cost = cost
        self.dtensor = _dtensor_type()
        self._lower = False
        self._replicating = False
        self._refused: dict = {}  # op signatures DTensor failed on -> the error
        self._retrying: set = set()  # ops whose retry is running

    def _is_dtensor_op(self, types) -> bool:
        return self.dtensor is not None and any(issubclass(t, self.dtensor) for t in types)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _META_OPS:
            return NotImplemented
        if _fake_active(types):  # DTensor's shape propagation, not the program
            return func(*args, **kwargs)
        if self._is_dtensor_op(types):
            if self._lower:  # let DTensor lower it; its local ops come back here
                self._lower = False
                return NotImplemented
            return self._dtensor_op(func, args, kwargs)
        if func not in flop_registry and func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    def _dtensor_op(self, func, args, kwargs):
        args = self._replicate_plain(func, args)
        rule = _RULES.get(func)
        if rule is not None:
            with self:
                out = rule(self.dtensor, args, kwargs)
            if out is not None:
                self.cost.rules[str(func)] = self.cost.rules.get(str(func), 0) + 1
                return out
        key = self._signature(func, args, kwargs)
        if key is not None and key in self._refused:  # failed before: straight to the retry
            return self._retry(func, args, kwargs, self._refused[key])
        saved = self.cost.copy()
        with self:
            try:
                self._lower = True
                return func(*args, **kwargs)
            except NotImplementedError as e:
                if "sharding strategy" not in str(e):
                    raise PropagationError(func, e) from e
                self.cost.__dict__.update(saved.__dict__)
            except (AssertionError, IndexError, RuntimeError, ValueError) as e:
                if isinstance(e, PropagationError):
                    raise
                # what the failed attempt issued before it failed is not run
                self.cost.__dict__.update(saved.__dict__)
                if key is not None:
                    self._refused[key] = e
                return self._retry(func, args, kwargs, e)
            finally:
                self._lower = False
            return self._replicated(func, args, kwargs)

    def _retry(self, func, args, kwargs, err):
        """``func`` by its ``_RETRY`` lowering, DTensor's own having failed
        with ``err``; a PropagationError where there is none."""
        retry = _RETRY.get(func._overloadpacket)
        if retry is None or func in self._retrying:  # a retry's own op failed
            raise PropagationError(func, err) from err
        self._retrying.add(func)
        try:
            with self:
                got = retry(self.dtensor, func, args, kwargs)
        finally:
            self._retrying.discard(func)
        if got is None:
            raise PropagationError(func, err) from err
        out, how = got
        name = f"{func} ({how})"
        self.cost.rules[name] = self.cost.rules.get(name, 0) + 1
        return out

    def _signature(self, func, args, kwargs):
        """What DTensor's propagation of ``func`` depends on (shapes,
        placements, local strides), or None if an input is not hashable."""
        def sig(a):
            if isinstance(a, self.dtensor):
                return ("D", tuple(a.shape), tuple(a.placements), a.dtype,
                        tuple(a._local_tensor.stride()))
            if isinstance(a, torch.Tensor):
                return ("T", tuple(a.shape), tuple(a.stride()), a.dtype)
            if isinstance(a, (list, tuple)):
                return tuple(sig(x) for x in a)
            return a

        key = (func, sig(args), tuple(sorted((k, sig(v)) for k, v in kwargs.items())))
        try:
            hash(key)
        except TypeError:
            return None
        return key

    def _replicate_plain(self, func, args):
        """A plain tensor among a DTensor op's inputs as a replicated
        DTensor (what ``implicit_replication`` makes of it), so DTensor's
        propagation sees DTensors only; an in-place op's own tensor stays."""
        mesh = next((a.device_mesh for a in args if isinstance(a, self.dtensor)), None)
        if mesh is None:
            return args
        from torch.distributed.tensor import Replicate

        first = 1 if func._schema.name.endswith("_") else 0
        return tuple(
            self.dtensor.from_local(a, mesh, [Replicate()] * mesh.ndim, run_check=False)
            if i >= first and isinstance(a, torch.Tensor) and not isinstance(a, self.dtensor)
            else a for i, a in enumerate(args))

    def _replicated(self, func, args, kwargs):
        """``func`` on its DTensor inputs gathered whole, its outputs
        replicated DTensors (for an op DTensor has no strategy for)."""
        from torch.distributed.tensor import Replicate
        from torch.utils._pytree import tree_map

        mesh = None

        def local(x):
            nonlocal mesh
            if isinstance(x, self.dtensor):
                mesh = x.device_mesh
                return x.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()
            return x

        coll = self.cost.coll_bytes
        largs, lkwargs = tree_map(local, (args, kwargs))
        self.cost.replicated_coll_bytes += self.cost.coll_bytes - coll
        self._replicating = True
        try:
            out = func(*largs, **lkwargs)
        finally:
            self._replicating = False
        name = str(func)
        self.cost.replicated_ops[name] = self.cost.replicated_ops.get(name, 0) + 1
        return tree_map(
            lambda t: self.dtensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                              run_check=False)
            if isinstance(t, torch.Tensor) else t, out)

    def _count(self, func, args, kwargs, out) -> None:
        c = self.cost
        c.n_ops += 1
        pkt = func._overloadpacket
        if pkt in flop_registry:
            f = float(flop_registry[pkt](*args, **kwargs, out_val=out))
            c.flops += f
            if self._replicating:
                c.replicated_flops += f
        name = func._opname if hasattr(func, "_opname") else str(func)
        if func.namespace in _FUNCOL_NAMESPACES:
            kind = _COLLECTIVES.get(name)
            if kind is not None:
                vol = collective_bytes(kind, _nbytes((args, kwargs)), _nbytes(out))
                c.coll_bytes += vol
                c.coll_by_op[kind] = c.coll_by_op.get(kind, 0.0) + vol
                c.coll_count_by_op[kind] = c.coll_count_by_op.get(kind, 0) + 1
            return
        if not func.is_view:
            c.bytes += _nbytes((args, kwargs)) + _nbytes(out)


def _shard_mesh_dims(placements, d: int) -> list[int]:
    return [m for m, p in enumerate(placements) if p.is_shard(d)]


def _offset(mesh, dims: list[int], n_local: int) -> int:
    """The first global index of this device's block of a tensor dim that
    the mesh ``dims`` shard (row-major over them, ``n_local`` each)."""
    i = 0
    for m in dims:
        i = i * mesh.size(m) + mesh.get_local_rank(m)
    return i * n_local


def _full(x, dtensor):
    return x.full_tensor() if isinstance(x, dtensor) else x


def _advanced_index(dtensor, self_, indices):
    """(local tensor, local indices, in-shard mask, leading indexed dims)
    for an advanced index of ``self_`` by 1-d ``indices`` of equal length
    on its leading dims, or None where the rule does not apply."""
    if not isinstance(self_, dtensor) or any(i is None for i in indices):
        return None
    idx = [_full(i, dtensor) for i in indices]
    if any(i.ndim != 1 or i.shape != idx[0].shape for i in idx):
        return None
    pl, mesh = self_.placements, self_.device_mesh
    k = len(idx)
    if not any(_shard_mesh_dims(pl, d) for d in range(k)) or any(p.is_partial() for p in pl):
        return None
    loc = self_.to_local()
    ok = torch.ones(idx[0].shape, dtype=torch.bool, device=loc.device)
    local = []
    for d, i in enumerate(idx):
        dims = _shard_mesh_dims(pl, d)
        if dims:
            i = i - _offset(mesh, dims, loc.shape[d])
            ok = ok & (i >= 0) & (i < loc.shape[d])
            i = i.clamp(0, loc.shape[d] - 1)
        local.append(i)
    return loc, tuple(local), ok, k


def _value_placements(placements, k: int):
    """Placements of the (N, *self.shape[k:]) values of an advanced index
    on the k leading dims: a shard of a later dim moves to its place
    there; the indexed dims' shards are replicated."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(p.dim - k + 1) if p.is_shard() and p.dim >= k else Replicate()
            for p in placements]


def _index_rule(dtensor, args, kwargs):
    """``x[i0, .., ik-1]`` on x sharded along an indexed dim: each device
    reads its entries (zero elsewhere), a partial sum."""
    from torch.distributed.tensor import Partial

    got = _advanced_index(dtensor, args[0], args[1])
    if got is None:
        return None
    loc, idx, ok, k = got
    out = loc[idx] * ok.reshape((-1,) + (1,) * (loc.ndim - k)).to(loc.dtype)
    self_ = args[0]
    pl = [Partial() if p.is_shard() and p.dim < k else q
          for p, q in zip(self_.placements, _value_placements(self_.placements, k))]
    shape = (idx[0].shape[0],) + tuple(self_.shape[k:])
    return dtensor.from_local(out, self_.device_mesh, pl, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def _index_put_rule(dtensor, args, kwargs):
    """``x[i0, .., ik-1] = v`` in place on x sharded along an indexed dim:
    each device writes the entries in its shard (an entry outside it
    writes back what it read)."""
    self_, indices, values = args[:3]
    accumulate = args[3] if len(args) > 3 else kwargs.get("accumulate", False)
    got = _advanced_index(dtensor, self_, indices)
    if got is None:
        return None
    loc, idx, ok, k = got
    vpl = _value_placements(self_.placements, k)
    if isinstance(values, dtensor):
        v = values.redistribute(self_.device_mesh, vpl).to_local()
    elif all(p.is_replicate() for p in vpl):
        v = values
    else:
        return None
    okb = ok.reshape((-1,) + (1,) * (loc.ndim - k))
    v = v.to(loc.dtype).expand((idx[0].shape[0],) + tuple(loc.shape[k:]))
    if accumulate:
        loc.index_put_(idx, v * okb.to(v.dtype), True)
    else:
        loc.index_put_(idx, torch.where(okb, v, loc[idx]))
    return self_


def _as_dtensor(x, dtensor, mesh):
    """``x`` as a DTensor on ``mesh`` (a plain tensor is replicated)."""
    from torch.distributed.tensor import Replicate

    if isinstance(x, dtensor):
        return x
    return dtensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)


def _gather_rule(dtensor, args, kwargs):
    """``gather`` along a dim the source is sharded on (the loss's target
    logits of vocab-sharded logits): each device gathers the indices in
    its shard (zero elsewhere), a partial sum."""
    from torch.distributed.tensor import Partial, Replicate

    self_, dim, index = args[:3]
    if not isinstance(self_, dtensor):
        return None
    mesh, pl = self_.device_mesh, self_.placements
    dim %= self_.ndim
    dims = _shard_mesh_dims(pl, dim)
    if not dims or any(p.is_partial() for p in pl):
        return None
    ipl = [Replicate() if p.is_shard(dim) else p for p in pl]
    idx = _as_dtensor(index, dtensor, mesh).redistribute(mesh, ipl).to_local()
    loc = self_.to_local()
    n = loc.shape[dim]
    li = idx - _offset(mesh, dims, n)
    ok = (li >= 0) & (li < n)
    out = torch.gather(loc, dim, li.clamp(0, n - 1)) * ok.to(loc.dtype)
    opl = [Partial() if p.is_shard(dim) else q for p, q in zip(pl, ipl)]
    return dtensor.from_local(out, mesh, opl, run_check=False, shape=index.shape,
                              stride=torch.empty(index.shape, device="meta").stride())


def _scatter_add_rule(dtensor, args, kwargs):
    """``scatter_add`` as each device's own scatter: along a mesh dim that
    shards the index on the scatter dim, every device scatters its entries
    (the first onto the tensor, the others onto zeros) and the result is a
    partial sum; along one that shards it on another dim the tensor takes
    the same rows; along one that replicates it the tensor's scatter dim
    is split and each device scatters the indices in its shard (the
    gradient of a gather from vocab-sharded logits)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    self_, dim, index, src = args[:4]
    mesh = next((t.device_mesh for t in (self_, index, src) if isinstance(t, dtensor)), None)
    if mesh is None:
        return None
    dim %= index.ndim
    self_ = _as_dtensor(self_, dtensor, mesh)
    index = _as_dtensor(index, dtensor, mesh)
    sp, ip = self_.placements, index.placements
    if any(p.is_partial() for p in (*sp, *ip)):
        return None
    target, out_pl, split = [], [], []
    for m, (s_, i_) in enumerate(zip(sp, ip)):
        if i_.is_shard(dim):
            if not s_.is_replicate():
                return None
            target.append(Replicate())
            out_pl.append(Partial())
        elif i_.is_shard():
            target.append(Shard(i_.dim))
            out_pl.append(Shard(i_.dim))
        elif s_.is_shard(dim) or (s_.is_replicate() and self_.shape[dim] % mesh.size(m) == 0):
            target.append(Shard(dim))
            out_pl.append(Shard(dim))
            split.append(m)
        else:
            target.append(s_)
            out_pl.append(s_)
    base = self_.redistribute(mesh, target).to_local()
    idx = index.to_local()
    src_l = _as_dtensor(src, dtensor, mesh).redistribute(mesh, ip).to_local()
    if split:
        n = base.shape[dim]
        idx = idx - _offset(mesh, split, n)
        ok = (idx >= 0) & (idx < n)
        idx = idx.clamp(0, n - 1)
        src_l = src_l * ok.to(src_l.dtype)
    if any(mesh.get_local_rank(m) for m, p in enumerate(out_pl) if p.is_partial()):
        base = torch.zeros_like(base)
    out = torch.scatter_add(base, dim, idx, src_l)
    return dtensor.from_local(out, mesh, out_pl, run_check=False, shape=self_.shape,
                              stride=torch.empty(self_.shape, device="meta").stride())


def _unbind_rule(dtensor, args, kwargs):
    """``unbind`` along a sharded dim: the dim gathered first (GSPMD's
    all-gather), then DTensor's own unbind."""
    from torch.distributed.tensor import Replicate

    x = args[0]
    dim = (args[1] if len(args) > 1 else kwargs.get("dim", 0)) % x.ndim
    if not isinstance(x, dtensor) or not _shard_mesh_dims(x.placements, dim):
        return None
    pl = [Replicate() if p.is_shard(dim) else p for p in x.placements]
    return torch.unbind(x.redistribute(x.device_mesh, pl), dim)


def _retry_view(dtensor, func, args, kwargs):
    """A view DTensor's lowering refuses: on a contiguous copy where the
    local block's strides were at fault, else with the dims from the first
    one the view changes gathered (an unflatten of an unevenly sharded
    dim; GSPMD's all-gather before such a reshape), its output sharded
    again over the gathered mesh dims."""
    from torch.distributed.tensor import Replicate, Shard

    x = args[0]
    if not isinstance(x, dtensor):
        return None
    try:
        dense = x.clone(memory_format=torch.contiguous_format)
        return func(dense, *args[1:], **kwargs), "contiguous"
    except (RuntimeError, ValueError, AssertionError, IndexError):
        pass
    shape = list(args[1])
    if -1 in shape:
        known = math.prod(n for n in shape if n != -1)
        shape[shape.index(-1)] = x.numel() // max(known, 1)
    first = next((d for d, (a, b) in enumerate(zip(x.shape, shape)) if a != b),
                 min(x.ndim, len(shape)))
    mesh = x.device_mesh
    pl = [Replicate() if p.is_shard() and p.dim >= first else p for p in x.placements]
    if pl == list(x.placements):
        return None
    out = func(x.redistribute(mesh, pl), *args[1:], **kwargs)
    # the gathered mesh dims shard the view's output again (a local slice):
    # each on the output dim of the input dim's size, else the first one
    # after the unchanged dims that it divides
    target, taken = list(out.placements), set()
    for m, p in enumerate(x.placements):
        if not (p.is_shard() and p.dim >= first):
            continue
        n = mesh.size(m)
        dims = [o for o in range(first, out.ndim) if o not in taken and out.shape[o] % n == 0]
        same = [o for o in dims if out.shape[o] == x.shape[p.dim]]
        if same or dims:
            o = (same or dims)[0]
            target[m] = Shard(o)
            taken.add(o)
    return out.redistribute(mesh, target), "gathered"


def _retry_pointwise(dtensor, func, args, kwargs):
    """An add of same-shaped inputs whose placements DTensor cannot
    reconcile (a sharded and a partial gradient summed): every input
    redistributed to one placement a mesh dim (a shard where any input is
    sharded, else replicated, else partial), then the op."""
    from torch.distributed.tensor import Replicate

    ts = [a for a in args if isinstance(a, dtensor)]
    if len(ts) < 2 or any(t.shape != ts[0].shape for t in ts):
        return None
    mesh = ts[0].device_mesh
    target = []
    for m in range(mesh.ndim):
        pls = [t.placements[m] for t in ts]
        shard = next((p for p in pls if p.is_shard()), None)
        target.append(shard if shard is not None else
                      Replicate() if any(p.is_replicate() for p in pls) else pls[0])
    args = tuple(a.redistribute(mesh, target) if isinstance(a, dtensor) else a for a in args)
    return func(*args, **kwargs), "reconciled"


# lowerings tried where DTensor's own propagation fails (by op packet)
_RETRY = {
    torch.ops.aten.view: _retry_view,
    torch.ops.aten._unsafe_view: _retry_view,
    torch.ops.aten.add: _retry_pointwise,
}

_RULES = {
    torch.ops.aten.gather.default: _gather_rule,
    torch.ops.aten.index.Tensor: _index_rule,
    torch.ops.aten.index_put_.default: _index_put_rule,
    torch.ops.aten.scatter_add.default: _scatter_add_rule,
    torch.ops.aten.scatter_add_.default: _scatter_add_rule,
    torch.ops.aten.unbind.int: _unbind_rule,
}


def analyze_step(fn, *args, **kwargs) -> tuple[StepCost, object]:
    """Run ``fn(*args, **kwargs)`` once and count what each device runs.
    Returns (its ``StepCost``, fn's result)."""
    cost = StepCost()
    with _Counter(cost):
        out = fn(*args, **kwargs)
    cost.replicated_ops = dict(Counter(cost.replicated_ops).most_common())
    return cost, out
