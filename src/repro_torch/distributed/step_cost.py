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

* memory: a ledger of the live bytes on each device.  It starts from the
  step's argument bytes; every storage a local op creates (a collective's
  result too) adds its bytes until the storage dies (a weak reference's
  callback, as ``torch.distributed._tools.mem_tracker`` keeps it), and the
  highest total is ``peak_bytes`` (the JAX record's meaning).  What
  the ledger cannot see: buffers a kernel allocates inside itself, and
  DTensor's redistribution buffers beyond the local ops that hold them.

Python loops are unrolled as they run, so the program has no loop to read
a trip count from.  Two folds stand in for the JAX package's:

* a model's scanned stage: the dry-run measures the step at two and at
  three repeats of its unit and folds the difference to the stage's depth
  (``StepCost.fold``), every count linear in the repeats (the peak a phase
  at a time);
* a time loop (``TimeSteps``: Mamba's selective scan, RWKV's WKV
  recurrence) runs four trips: the first, one standing for the ``m = n -
  3`` middle ones, and the last two.  The middle trip's ops count ``m``
  times, and so do those of its backward (the autograd nodes it created,
  by sequence number); what it leaves alive after the next trip (its
  output, what autograd saved) stands for ``m`` trips' bytes in the ledger
  until it dies, and the next trip's peak, seen without them, is raised by
  the ``m - 1`` trips' bytes it does not see.  The last two trips run
  after the middle one, so a gradient summed over the trips (a slice's,
  the carry's) always reaches its buffer first from a trip that counts
  once, and the sums the unrolled loop adds are all counted.  Every trip
  of such a loop runs the same ops on the same shapes, so the fold equals
  the unrolled loop (``hlo_cost``'s ``while`` body times its trip count;
  nested inside the stage fold as a ``while`` in a ``while``).

Some ops have a per-device lowering of their own here (``_RULES``,
counted in ``rules``), the one GSPMD gives them, where DTensor would gather
a whole tensor first (a KV cache, vocab-sharded logits) or refuse:

* an advanced-index read or write (``index``, ``index_put_``) of a tensor
  sharded along an indexed dim, and a ``gather`` along a sharded dim, read
  or write on each device the entries that fall in its shard (the rest
  masked; a read is a partial sum);
* a ``scatter_add`` scatters each device's own entries (``_scatter_add_rule``);
* an ``unbind`` along a sharded dim gathers that dim first;
* a ``constant_pad_nd`` that pads only unsharded dims pads each device's
  block (DTensor 2.11 has no strategy for it);
* a depthwise convolution (Mamba's causal conv: one group a channel) and
  its backward run on each device's channels and batch rows, the weight's
  gradient a partial sum over the batch's mesh dims (DTensor's own rule
  takes the channels for whole);
* where DTensor's own lowering fails (``_RETRY``): a view runs on a
  contiguous copy, or else gathers the dims it changes (an unflatten of
  an unevenly sharded dim) and shards its output over the same mesh dims
  again; an add of inputs whose placements DTensor cannot reconcile
  redistributes them to one placement first (where they broadcast, the
  partial sums are reduced).

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

import contextlib
import math
import weakref
from collections import Counter
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
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
    # the ledger (bytes a device): arguments at the start, the highest live
    # total, the result's tensors, and the peak beyond the arguments and the
    # result's new storages
    argument_bytes: float = 0.0
    peak_bytes: float = 0.0
    output_bytes: float = 0.0
    temp_bytes: float = 0.0
    phase_peaks: list[float] = field(default_factory=list)  # the ledger's, a phase each
    trips: dict[str, int] = field(default_factory=dict)  # time loops folded

    def copy(self) -> StepCost:
        return StepCost(**{k: dict(v) if isinstance(v, dict) else list(v) if isinstance(v, list)
                           else v for k, v in self.__dict__.items()})

    def fold(self, two: StepCost, n: int, first: int) -> StepCost:
        """The cost of ``n`` repeats of a unit, from this run (``first``
        repeats) and ``two`` (the same program with one more): ``self +
        (n - first) x (two - self)``, every count linear in the repeats (the
        counterpart of the JAX package's scan trip-count fold).  The memory
        too, a phase at a time: each unit's saved input (under remat), its
        parameters, their gradients and their optimizer state grow linearly
        with depth, so each phase's peak (the forward, the backward, the
        update) is folded on its own and the step's is the highest of them;
        within a phase the peak is assumed to stay where it is at two and
        three units (the loss head's backward, say, against the last
        layers')."""
        def lin(a, b):
            return a + (n - first) * (b - a)

        def lin_d(a, b):
            return {k: lin(a.get(k, 0), b.get(k, 0)) for k in {**a, **b}}

        out = StepCost()
        for k, a in self.__dict__.items():
            b = two.__dict__[k]
            out.__dict__[k] = (dict(b) if k == "trips" else lin_d(a, b) if isinstance(a, dict)
                               else a if isinstance(a, list) else lin(a, b))
        # each phase's peak linear in the repeats, the step's their highest
        pa, pb = self.phase_peaks, two.phase_peaks
        out.phase_peaks = ([lin(x, y) for x, y in zip(pa, pb)] if len(pa) == len(pb)
                           else [lin(self.peak_bytes, two.peak_bytes)])
        out.peak_bytes = max(out.phase_peaks)
        new_out = lin(self.peak_bytes - self.argument_bytes - self.temp_bytes,
                      two.peak_bytes - two.argument_bytes - two.temp_bytes)
        out.temp_bytes = max(out.peak_bytes - out.argument_bytes - new_out, 0.0)
        return out


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


class _Ledger:
    """Live bytes of the storages the step's local ops create, from
    ``start`` (the arguments').  An entry is [bytes, alive]; a storage's
    death (its weak reference's callback) takes its bytes off.  The highest
    total is kept for each phase of the step (a phase ends where the
    autograd engine starts or stops running backward nodes: the forward,
    the backward, the update after it)."""

    def __init__(self, start: float) -> None:
        self.live = float(start)
        self.phases = [self.live]  # each phase's highest total
        self.backward = False
        self.window = self.live  # the highest total since ``open_window``
        self.entries: list[list] = []
        self._seen: dict[int, tuple[list, weakref.ref]] = {}

    @property
    def peak(self) -> float:
        return max(self.phases)

    def _rise(self, n: float) -> None:
        self.live += n
        self.phases[-1] = max(self.phases[-1], self.live)
        self.window = max(self.window, self.live)

    def enter(self, backward: bool) -> None:
        """The running op is (not) in a backward node: a new phase where
        that changed."""
        if backward != self.backward:
            self.backward = backward
            self.phases.append(self.live)

    def add(self, st) -> None:
        key = id(st)
        if key in self._seen:
            return
        entry = [float(st.nbytes()), True]

        def died(_, key=key, entry=entry):
            self._seen.pop(key, None)
            if entry[1]:
                entry[1] = False
                self.live -= entry[0]

        self._seen[key] = (entry, weakref.ref(st, died))
        self.entries.append(entry)
        self._rise(entry[0])

    def bytes_of(self, storages) -> float:
        """Bytes of the live entries among ``storages`` (by identity)."""
        return sum(self._seen[id(st)][0][0] for st in {id(s): s for s in storages}.values()
                   if id(st) in self._seen and self._seen[id(st)][0][1])

    def checkpoint(self) -> tuple:
        return len(self.entries), list(self.phases), self.backward, self.window

    def undo(self, cp: tuple) -> None:
        """Forget what was added since ``cp`` (a failed attempt's storages)."""
        n, phases, self.backward, self.window = cp
        self.phases = list(phases)
        for entry in self.entries[n:]:
            if entry[1]:
                entry[1] = False
                self.live -= entry[0]
        del self.entries[n:]

    def open_window(self) -> None:
        self.window = self.live

    def repeat(self, lo: int, hi: int, m: int) -> None:
        """The entries ``lo:hi`` still alive stand for ``m`` copies each:
        ``m - 1`` more of their bytes are live from now until each dies,
        and the window's peak, seen without them, is raised by as much."""
        extra = 0.0
        for entry in self.entries[lo:hi]:
            if entry[1]:
                extra += (m - 1) * entry[0]
                entry[0] *= m
        self.phases[-1] = max(self.phases[-1], self.window + extra)
        self.live += extra


def _storages(tree) -> list:
    out = []
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            local = getattr(t, "_local_tensor", None)
            out.append((local if local is not None else t).untyped_storage())
    return out


_ACTIVE: list[_Counter] = []


def _next_sequence_nr() -> int:
    """The autograd sequence number the next node will take (a throwaway
    node on ``meta``, made outside every mode; its op saves nothing)."""
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes(), torch.enable_grad():
        t = torch.empty((), device="meta", requires_grad=True).neg()
    return t.grad_fn._sequence_nr() + 1


class TimeSteps:
    """The trips of a time loop of ``n`` steps named ``name``: ``range(n)``,
    and ``stack(ys, dim)`` of the trips' outputs is ``torch.stack``.  Under
    ``analyze_step`` (with ``fold_loops``) a loop of more than four trips
    runs trips 0, 1, ``n - 2`` and ``n - 1``, trip 1 standing for the
    middle ones (the module docstring); ``stack`` then returns the full
    ``n`` positions, trip 1's output repeated."""

    def __init__(self, n: int, name: str) -> None:
        self.n, self.name = n, name

    def __iter__(self):
        c = _ACTIVE[-1] if _ACTIVE else None
        if c is None or not c.fold_loops or self.n <= 4:
            return iter(range(self.n))
        return c.folded_trips(self.n, self.name)

    def stack(self, ys: list, dim: int):
        if len(ys) == self.n:
            return torch.stack(ys, dim)
        return _FoldStack.apply(dim, self.n, *ys)


class _FoldStack(torch.autograd.Function):
    """``torch.stack`` of a folded loop's four outputs at its full ``n``
    positions (trip 1's repeated): the same op, bytes and shape as
    the unrolled loop's stack; the backward hands each output its own
    position's gradient (views, as ``stack``'s backward ``unbind`` does)."""

    @staticmethod
    def forward(ctx, dim, n, y0, y1, y2, y3):
        ctx.dim, ctx.n = dim, n
        return torch.stack([y0] + [y1] * (n - 3) + [y2, y3], dim)

    @staticmethod
    def backward(ctx, g):
        d, n = ctx.dim, ctx.n
        return None, None, g.select(d, 0), g.select(d, 1), g.select(d, n - 2), g.select(d, n - 1)


class _Counter(TorchDispatchMode):
    def __init__(self, cost: StepCost, start_bytes: float, fold_loops: bool) -> None:
        super().__init__()
        self.cost = cost
        self.dtensor = _dtensor_type()
        self.ledger = _Ledger(start_bytes)
        self.fold_loops = fold_loops
        self._lower = False
        self._replicating = False
        self._refused: dict = {}  # op signatures DTensor failed on -> the error
        self._retrying: set = set()  # ops whose retry is running
        self._propagating = 0  # inside DTensor's strategy search
        self._trip_weight: int | None = None  # inside a folded loop's trip
        self._ranges: list[tuple[int, int, int]] = []  # (first, end, repeats) node seqs

    def folded_trips(self, n: int, name: str):
        """Trips 0, 1, n - 2 and n - 1 of a folded time loop
        (``TimeSteps``), trip 1 standing for the ``n - 3`` middle ones."""
        m = n - 3
        self.cost.trips[name] = n
        prev = self._trip_weight
        grad = torch.is_grad_enabled()
        try:
            self._trip_weight = 1
            yield 0
            seq0 = _next_sequence_nr() if grad else None
            lo = len(self.ledger.entries)
            self._trip_weight = m
            yield 1
            if grad:
                self._ranges.append((seq0, _next_sequence_nr(), m))
            hi = len(self.ledger.entries)
            self._trip_weight = 1
            self.ledger.open_window()
            yield n - 2
            self.ledger.repeat(lo, hi, m)
            yield n - 1
        finally:
            self._trip_weight = prev

    def _weight(self) -> int:
        """How many ops of the unrolled program the running op stands for:
        a folded loop's middle trip's ops, and those of the backward nodes
        it created, ``n - 3``; every other op one."""
        if self._trip_weight is not None:
            return self._trip_weight
        if not self._ranges:
            return 1
        node = torch._C._current_autograd_node()
        if node is None:
            return 1
        seq = node._sequence_nr()
        return next((m for lo, hi, m in self._ranges if lo <= seq < hi), 1)

    def _is_dtensor_op(self, types) -> bool:
        return self.dtensor is not None and any(issubclass(t, self.dtensor) for t in types)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _META_OPS:
            return NotImplemented
        if self._propagating or _fake_active(types):
            return func(*args, **kwargs)  # DTensor's bookkeeping, not the program
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
                self.cost.rules[str(func)] = self.cost.rules.get(str(func), 0) + self._weight()
                return out
        key = self._signature(func, args, kwargs)
        if key is not None and key in self._refused:  # failed before: straight to the retry
            return self._retry(func, args, kwargs, self._refused[key])
        saved, cp = self.cost.copy(), self.ledger.checkpoint()
        with self:
            try:
                self._lower = True
                return func(*args, **kwargs)
            except NotImplementedError as e:
                if "sharding strategy" not in str(e):
                    raise PropagationError(func, e) from e
                self.cost.__dict__.update(saved.__dict__)
                self.ledger.undo(cp)
            except (AssertionError, IndexError, RuntimeError, ValueError) as e:
                if isinstance(e, PropagationError):
                    raise
                # what the failed attempt issued before it failed is not run
                self.cost.__dict__.update(saved.__dict__)
                self.ledger.undo(cp)
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
        self.cost.rules[name] = self.cost.rules.get(name, 0) + self._weight()
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
                return _redist(x, mesh, [Replicate()] * mesh.ndim).to_local()
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
        self.cost.replicated_ops[name] = self.cost.replicated_ops.get(name, 0) + self._weight()
        return tree_map(
            lambda t: self.dtensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                              run_check=False)
            if isinstance(t, torch.Tensor) else t, out)

    def _count(self, func, args, kwargs, out) -> None:
        c = self.cost
        w = self._weight()
        c.n_ops += w
        self.ledger.enter(torch._C._current_autograd_node() is not None)
        self._track(args, kwargs, out)
        pkt = func._overloadpacket
        if pkt in flop_registry:
            f = w * float(flop_registry[pkt](*args, **kwargs, out_val=out))
            c.flops += f
            if self._replicating:
                c.replicated_flops += f
        name = func._opname if hasattr(func, "_opname") else str(func)
        if func.namespace in _FUNCOL_NAMESPACES:
            kind = _COLLECTIVES.get(name)
            if kind is not None:
                vol = w * collective_bytes(kind, _nbytes((args, kwargs)), _nbytes(out))
                c.coll_bytes += vol
                c.coll_by_op[kind] = c.coll_by_op.get(kind, 0.0) + vol
                c.coll_count_by_op[kind] = c.coll_count_by_op.get(kind, 0) + w
            return
        if not func.is_view:
            c.bytes += w * (_nbytes((args, kwargs)) + _nbytes(out))

    def _track(self, args, kwargs, out) -> None:
        """The ledger takes each storage of ``out`` that is none of the
        inputs' (an in-place op's or a view's result is not new memory)."""
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not outs:
            return
        ins = {id(t.untyped_storage()) for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)}
        for t in outs:
            st = t.untyped_storage()
            if id(st) not in ins:
                self.ledger.add(st)


def _redist(x, mesh, placements):
    """``x`` redistributed to ``placements``, or ``x`` where it has them
    (DTensor 2.11's no-op redistribution in a backward detaches its output
    in place, an op it has no strategy for)."""
    return x if list(x.placements) == list(placements) else x.redistribute(mesh, placements)


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
        v = _redist(values, self_.device_mesh, vpl).to_local()
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
    idx = _redist(_as_dtensor(index, dtensor, mesh), mesh, ipl).to_local()
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
    base = _redist(self_, mesh, target).to_local()
    idx = index.to_local()
    src_l = _redist(_as_dtensor(src, dtensor, mesh), mesh, ip).to_local()
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


def _from_local(dtensor, t, mesh, pl, shape):
    return dtensor.from_local(t, mesh, pl, run_check=False, shape=tuple(shape),
                              stride=torch.empty(tuple(shape), device="meta").stride())


def _pad_rule(dtensor, args, kwargs):
    """``constant_pad_nd`` of dims no mesh dim shards: each device pads
    its block."""
    x, pad = args[0], list(args[1])
    value = args[2] if len(args) > 2 else kwargs.get("value", 0)
    if not isinstance(x, dtensor) or any(p.is_partial() for p in x.placements):
        return None
    padded = [x.ndim - 1 - i // 2 for i in range(len(pad))]
    if any(_shard_mesh_dims(x.placements, d) for d in padded):
        return None
    shape = list(x.shape)
    for i, d in enumerate(padded):
        shape[d] += pad[i]
    out = torch.constant_pad_nd(x.to_local(), pad, value)
    return _from_local(dtensor, out, x.device_mesh, list(x.placements), shape)


def _depthwise(dtensor, x, w, groups):
    """The placements a depthwise convolution runs under (batch rows as
    ``x`` has them, channels as the weight has them), or None where the
    rule does not apply."""
    from torch.distributed.tensor import Replicate, Shard

    if not (isinstance(w, dtensor) and groups == x.shape[1] == w.shape[0] and w.shape[1] == 1):
        return None
    if any(p.is_partial() for p in (*x.placements, *w.placements)):
        return None
    xpl, wpl = [], []
    for px, pw in zip(x.placements, w.placements):
        if pw.is_shard(0):
            xpl.append(Shard(1))
            wpl.append(Shard(0))
        elif px.is_shard(0):
            xpl.append(Shard(0))
            wpl.append(Replicate())
        else:
            xpl.append(Replicate())
            wpl.append(Replicate())
    return xpl, wpl


def _conv_rule(dtensor, args, kwargs):
    """A depthwise ``convolution`` on each device's channels and rows."""
    x, w, b, stride, padding, dilation, transposed, out_pad, groups = args[:9]
    mesh = next((t.device_mesh for t in (x, w) if isinstance(t, dtensor)), None)
    if mesh is None or transposed:
        return None
    x = _as_dtensor(x, dtensor, mesh)
    got = _depthwise(dtensor, x, w, groups)
    if got is None:
        return None
    xpl, wpl = got
    lb = None if b is None else _redist(_as_dtensor(b, dtensor, mesh), mesh, wpl).to_local()
    out = torch.ops.aten.convolution.default(
        _redist(x, mesh, xpl).to_local(), _redist(w, mesh, wpl).to_local(), lb,
        stride, padding, dilation, transposed, out_pad, out_local_groups(x, w, xpl, mesh))
    shape = (x.shape[0], w.shape[0]) + tuple(out.shape[2:])
    return _from_local(dtensor, out, mesh, xpl, shape)


def out_local_groups(x, w, xpl, mesh) -> int:
    """A depthwise convolution's groups on this device: its channels."""
    return x.shape[1] // math.prod(mesh.size(m) for m, p in enumerate(xpl) if p.is_shard(1))


def _conv_backward_rule(dtensor, args, kwargs):
    """The backward of a depthwise convolution on each device's channels
    and rows: the input's gradient placed as the input, the weight's and
    the bias's partial sums over the mesh dims that split the rows."""
    from torch.distributed.tensor import Partial, Shard

    g, x, w, bias_sizes, stride, padding, dilation, transposed, out_pad, groups, mask = args[:11]
    mesh = next((t.device_mesh for t in (g, x, w) if isinstance(t, dtensor)), None)
    if mesh is None or transposed:
        return None
    x = _as_dtensor(x, dtensor, mesh)
    got = _depthwise(dtensor, x, w, groups)
    if got is None:
        return None
    xpl, wpl = got
    gl = _redist(_as_dtensor(g, dtensor, mesh), mesh, xpl).to_local()
    gi, gw, gb = torch.ops.aten.convolution_backward.default(
        gl, _redist(x, mesh, xpl).to_local(), _redist(w, mesh, wpl).to_local(),
        None if bias_sizes is None else [gl.shape[1]], stride, padding, dilation, transposed,
        out_pad, out_local_groups(x, w, xpl, mesh), mask)
    ppl = [Partial() if p.is_shard(0) else q for p, q in zip(xpl, wpl)]
    bpl = [Shard(0) if p.is_shard(0) else p for p in ppl]
    return (None if gi is None else _from_local(dtensor, gi, mesh, xpl, x.shape),
            None if gw is None else _from_local(dtensor, gw, mesh, ppl, w.shape),
            None if gb is None else _from_local(dtensor, gb, mesh, bpl, (w.shape[0],)))


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
    return _redist(out, mesh, target), "gathered"


def _retry_pointwise(dtensor, func, args, kwargs):
    """An add whose inputs' placements DTensor cannot reconcile (a sharded
    and a partial gradient summed, a bias added to a partial product):
    same-shaped inputs redistributed to one placement a mesh dim (a shard
    where any input is sharded, else replicated, else partial); inputs that
    broadcast have their partial sums reduced where the others are not
    partial, then the op."""
    from torch.distributed.tensor import Replicate

    ts = [a for a in args if isinstance(a, dtensor)]
    if len(ts) < 2:
        return None
    mesh = ts[0].device_mesh
    if any(t.shape != ts[0].shape for t in ts):
        def reduced(t):
            pl = [Replicate() if p.is_partial() and not all(
                u.placements[m].is_partial() for u in ts) else p
                for m, p in enumerate(t.placements)]
            return _redist(t, mesh, pl)

        if not any(p.is_partial() for t in ts for p in t.placements):
            return None
        args = tuple(reduced(a) if isinstance(a, dtensor) else a for a in args)
        return func(*args, **kwargs), "reduced"
    target = []
    for m in range(mesh.ndim):
        pls = [t.placements[m] for t in ts]
        shard = next((p for p in pls if p.is_shard()), None)
        target.append(shard if shard is not None else
                      Replicate() if any(p.is_replicate() for p in pls) else pls[0])
    args = tuple(_redist(a, mesh, target) if isinstance(a, dtensor) else a for a in args)
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
    torch.ops.aten.constant_pad_nd.default: _pad_rule,
    torch.ops.aten.convolution.default: _conv_rule,
    torch.ops.aten.convolution_backward.default: _conv_backward_rule,
}


@contextlib.contextmanager
def _bookkeeping_uncounted(counter: _Counter):
    """DTensor's strategy search (and its choice of a redistribution's
    steps) runs small torch ops of its own on ``meta``: they are not the
    device's program, so ``counter`` lets them through uncounted."""
    DTensor = _dtensor_type()
    if DTensor is None:
        yield
        return
    import torch.distributed.tensor._redistribute as redist

    prop = DTensor._op_dispatcher.sharding_propagator
    patched = [(prop, "propagate"), (prop, "propagate_op_sharding"),
               (prop, "propagate_op_sharding_non_cached"),
               (redist, "_gen_transform_infos_non_cached")]
    saved = []
    for obj, name in patched:
        fn = getattr(obj, name, None)
        if fn is None:
            continue

        def wrapped(*a, _fn=fn, **k):
            counter._propagating += 1
            try:
                return _fn(*a, **k)
            finally:
                counter._propagating -= 1

        saved.append((obj, name, obj.__dict__.get(name)))
        setattr(obj, name, wrapped)
    try:
        yield
    finally:
        for obj, name, old in saved:
            if old is None:
                delattr(obj, name)
            else:
                setattr(obj, name, old)


def analyze_step(fn, *args, arg_bytes: float | None = None,
                 fold_loops: bool = True) -> tuple[StepCost, object]:
    """Run ``fn(*args)`` once and count what each device runs.  The ledger
    starts from ``arg_bytes`` (by default the bytes of the arguments'
    distinct local storages); ``fold_loops=False`` unrolls the time loops.
    Returns (its ``StepCost``, fn's result)."""
    start = arg_bytes if arg_bytes is not None else sum(
        st.nbytes() for st in {id(st): st for st in _storages(args)}.values())
    cost = StepCost(argument_bytes=float(start))
    counter = _Counter(cost, start, fold_loops)
    _ACTIVE.append(counter)
    try:
        with counter, _bookkeeping_uncounted(counter):
            out = fn(*args)
    finally:
        _ACTIVE.pop()
    led = counter.ledger
    cost.phase_peaks = list(led.phases)
    cost.peak_bytes = led.peak
    result = [getattr(t, "_local_tensor", t) for t in tree_leaves(out)
              if isinstance(t, torch.Tensor)]
    cost.output_bytes = float(sum(t.numel() * t.element_size() for t in result))
    cost.temp_bytes = max(cost.peak_bytes - start - led.bytes_of(_storages(result)), 0.0)
    cost.replicated_ops = dict(Counter(cost.replicated_ops).most_common())
    return cost, out
