"""Ambient mesh context: the islands a sharded computation runs on.

The JAX package's mesh is a ``jax.sharding.Mesh`` that one process drives
through ``shard_map``.  Here a ``Mesh`` is the same single-controller idea
in plain torch: named axes of a given shape, and one torch device per
island, the islands in row-major order over the shape (as
``jax.make_mesh`` orders its devices).  A device may repeat
(``["cuda:0"] * 4`` is four islands on one card, as a forced host platform
count gives the JAX package four islands on one CPU), and islands run one
after another on their device's current stream.  ``Mesh(devices)`` is one
``"model"`` axis over the devices; a mesh made without devices is abstract
(shape and names only), which is all the sharding rules and the dry-run
read.

Code that wants the sharded path looks the active mesh up here
(``serve.retrieval.knn_logits`` splits a flat datastore over the model
axis, the MoE layer runs its expert-parallel islands); with no mesh it runs
on one device.  ``shard_map`` runs one island's program, written once, on
every island of a mesh (or, on ``DTensor`` inputs, as one device's program
under ``local_map``).
"""
from __future__ import annotations

import contextlib
import inspect
import math
from collections.abc import Callable, Iterator, Sequence

import torch

# Logical -> physical axis mapping (see distributed/sharding.py).
BATCH_AXES = ("pod", "data")  # batch / fsdp axes present in the mesh
MODEL_AXIS = "model"


class Mesh:
    """Named axes of ``shape`` and, unless abstract, one torch device per
    island in row-major order: ``devices[s]`` is island ``s``'s device.

    ``Mesh(devices)`` is one axis ``axis`` over ``devices``;
    ``Mesh(devices, shape=(2, 2), axis_names=("data", "model"))`` lays the
    devices out row-major; ``Mesh(shape=..., axis_names=...)`` has no
    devices.  ``shape`` reads as a ``{name: size}`` dict, as on a
    ``jax.sharding.Mesh``.
    """

    def __init__(self, devices: Sequence | None = None, axis: str = MODEL_AXIS, *,
                 shape: Sequence[int] | None = None,
                 axis_names: Sequence[str] | None = None) -> None:
        names = tuple(axis_names) if axis_names is not None else (axis,)
        if shape is None:
            if devices is None:
                raise ValueError("a Mesh needs devices or a shape")
            shape = (len(devices),)
        shape = tuple(int(n) for n in shape)
        if len(shape) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"mesh shape {shape} does not fit axis names {names}")
        if math.prod(shape) < 1:
            raise ValueError("a Mesh needs at least one island")
        self._shape = shape
        self._names = names
        self.devices: tuple[torch.device, ...] | None = None
        if devices is not None:
            if len(devices) != math.prod(shape):
                raise ValueError(
                    f"a mesh of shape {shape} needs {math.prod(shape)} devices, "
                    f"given {len(devices)}")
            self.devices = tuple(torch.device(d) for d in devices)

    @property
    def axis_names(self) -> tuple[str, ...]:
        return self._names

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self._names, self._shape))

    @property
    def size(self) -> int:
        return math.prod(self._shape)

    @property
    def abstract(self) -> bool:
        return self.devices is None

    def coords(self, s: int) -> dict[str, int]:
        """Island ``s``'s index along each axis."""
        out = {}
        for name, n in zip(reversed(self._names), reversed(self._shape)):
            out[name] = s % n
            s //= n
        return {a: out[a] for a in self._names}

    def index(self, coords: dict[str, int]) -> int:
        """The island at ``coords`` (axes not named are at index 0)."""
        s = 0
        for name, n in zip(self._names, self._shape):
            s = s * n + coords.get(name, 0)
        return s

    def group(self, s: int, axes: Sequence[str]) -> list[int]:
        """The islands that share island ``s``'s index on every axis but
        ``axes``, ordered row-major over ``axes`` (the members of a
        collective over ``axes``, in the order ``all_gather`` tiles them)."""
        c = self.coords(s)
        members = [dict(c)]
        for a in axes:
            members = [dict(m, **{a: i}) for m in members for i in range(self.shape[a])]
        return [self.index(m) for m in members]

    def islands(self, axis: str, at: dict[str, int] | None = None) -> list[int]:
        """The islands along ``axis`` at index ``at`` on the other axes
        (0 where not named)."""
        return self.group(self.index(at or {}), (axis,))

    def __repr__(self) -> str:
        where = "abstract" if self.abstract else f"{len(set(self.devices))} device(s)"
        return f"Mesh({self.shape}, {where})"


_ACTIVE: list[Mesh | None] = [None]


def current_mesh() -> Mesh | None:
    return _ACTIVE[0]


@contextlib.contextmanager
def use_mesh(mesh: Mesh | None) -> Iterator[None]:
    prev = _ACTIVE[0]
    _ACTIVE[0] = mesh
    try:
        yield
    finally:
        _ACTIVE[0] = prev


def batch_axes(mesh: Mesh | None = None) -> tuple[str, ...]:
    mesh = mesh or current_mesh()
    if mesh is None:
        return ()
    return tuple(a for a in BATCH_AXES if a in mesh.axis_names)


def model_axis_size(mesh: Mesh | None = None) -> int:
    mesh = mesh or current_mesh()
    if mesh is None or MODEL_AXIS not in mesh.axis_names:
        return 1
    return mesh.shape[MODEL_AXIS]


# ---------------------------------------------------------------------------
# shard_map: one island's program on every island
# ---------------------------------------------------------------------------


def spec_axes(entry) -> tuple[str, ...]:
    """A spec entry's mesh axes: None or () replicated, a name, a tuple."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)



def shard_map(body: Callable, mesh: Mesh, in_specs: Sequence, out_specs: Sequence):
    """The counterpart of the JAX package's ``shard_map``: ``body(ix,
    *locals)`` is one island's program, run on every island of ``mesh``.

    * ``in_specs``: a spec per argument (a tuple with one entry per dim:
      None, an axis name or a tuple of names, as a ``PartitionSpec``), or
      None for an argument every island gets whole (or that is not a
      tensor); island s gets its row-major block of each sharded dim;
    * ``ix(axes)`` is the island's row-major index over ``axes``;
    * the body is a generator where it communicates: it yields a collective
      and is sent its result, ``("psum", axes, x)`` (the sum over the
      islands that differ only on ``axes``; ``"pmax"`` their elementwise
      maximum, no gradient), ``("all_gather", axes, x,
      dim)`` (their ``x`` concatenated along ``dim`` in row-major order) or
      ``("all_to_all", axes, x)`` (block j of dim 0 goes to member j; the
      blocks received, in member order, along dim 0); it returns its
      outputs, a tuple;
    * ``out_specs``: per output, (spec, partial axes): the output is
      summed over its partial axes (a psum the body leaves to the caller)
      and its sharded dims concatenated; over the other axes the islands
      agree and island index 0's is taken.

    On an island mesh the islands run one after another, each on its
    device, in lockstep between collectives, and the outputs land on the
    first tensor argument's device.  Islands whose index is nonzero on an
    axis no spec names compute nothing (theirs would repeat index 0's).  On
    ``DTensor`` arguments the body runs once, as this device's program
    under ``local_map``, with torch's functional collectives over the
    ``DeviceMesh``'s dims (a dim may merge adjacent axes, "pod+data"; a
    spec names all of them or none); a plain tensor among them is taken as
    replicated."""
    def run(*args):
        if any(is_dtensor(a) for a in args):
            return _shard_map_dtensor(body, in_specs, out_specs, args)
        if mesh.abstract:
            raise ValueError("an abstract mesh has no islands to run on")
        return _shard_map_islands(body, mesh, in_specs, out_specs, args)

    return run


def _lin(mesh: Mesh, s: int, axes: Sequence[str]) -> int:
    c = mesh.coords(s)
    i = 0
    for a in axes:
        i = i * mesh.shape[a] + c[a]
    return i


def _block(mesh: Mesh, s: int, x, spec):
    """Island s's block of ``x`` under ``spec``, on its device."""
    if spec is None or not isinstance(x, torch.Tensor):
        return x
    for d, entry in enumerate(spec):
        axes = spec_axes(entry)
        if not axes:
            continue
        n = math.prod(mesh.shape[a] for a in axes)
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not split evenly over "
                             f"{n} islands {axes}")
        w = x.shape[d] // n
        x = x.narrow(d, _lin(mesh, s, axes) * w, w)
    return x.to(mesh.devices[s])


def _collective(mesh: Mesh, reqs: dict[int, tuple]) -> dict[int, object]:
    """Every island's result of the collective it yielded (all yield the
    same kind over the same axes)."""
    kinds = {(r[0], r[1]) for r in reqs.values()}
    if len(kinds) != 1:
        raise RuntimeError(f"islands disagree on a collective: {kinds}")
    out = {}
    for s, (kind, axes, x, *rest) in reqs.items():
        members = mesh.group(s, axes)
        if any(m not in reqs for m in members):
            raise RuntimeError(f"a collective over {axes} needs islands that do not run")
        dev = mesh.devices[s]
        xs = [reqs[m][2] for m in members]
        if kind == "psum":
            dev0 = xs[0].device
            total = xs[0]
            for y in xs[1:]:
                total = total + y.to(dev0)
            out[s] = total.to(dev)
        elif kind == "pmax":
            out[s] = torch.stack([y.to(dev) for y in xs]).amax(0)
        elif kind == "all_gather":
            out[s] = torch.cat([y.to(dev) for y in xs], dim=rest[0])
        elif kind == "all_to_all":
            j = members.index(s)
            out[s] = torch.cat([y.chunk(len(members))[j].to(dev) for y in xs], dim=0)
        else:
            raise ValueError(f"unknown collective {kind!r}")
    return out


def _shard_map_islands(body, mesh: Mesh, in_specs, out_specs, args):
    named = {a for spec in in_specs if spec is not None for e in spec for a in spec_axes(e)}
    named |= {a for spec, part in out_specs for e in spec for a in spec_axes(e)} \
        | {a for _, part in out_specs for a in part}
    runs = [s for s in range(mesh.size)
            if all(i == 0 for a, i in mesh.coords(s).items() if a not in named)]
    progs = {}
    for s in runs:
        local = [_block(mesh, s, x, spec) for x, spec in zip(args, in_specs)]
        progs[s] = body(lambda axes, s=s: _lin(mesh, s, axes), *local)
    outs = {s: p for s, p in progs.items() if not inspect.isgenerator(p)}
    live = {s: p for s, p in progs.items() if inspect.isgenerator(p)}
    sent: dict[int, object] = {s: None for s in live}
    while live:
        reqs = {}
        for s, p in live.items():
            try:
                reqs[s] = p.send(sent[s])
            except StopIteration as stop:
                outs[s] = stop.value
        if reqs and len(reqs) != len(live):
            raise RuntimeError("islands disagree on the number of collectives")
        live = {s: p for s, p in live.items() if s in reqs}
        sent = _collective(mesh, reqs) if reqs else {}
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    return tuple(_assemble(mesh, {s: o[i] for s, o in outs.items()}, spec, part, dev)
                 for i, (spec, part) in enumerate(out_specs))


def _assemble(mesh: Mesh, parts: dict[int, torch.Tensor], spec, partial, dev):
    """One output from the islands' parts: summed over ``partial``, its
    sharded dims concatenated, index 0 taken over the other axes."""
    sharded = [(d, spec_axes(e)) for d, e in enumerate(spec) if spec_axes(e)]
    keep = set(partial) | {a for _, axes in sharded for a in axes}
    islands = [s for s in parts if all(i == 0 for a, i in mesh.coords(s).items()
                                       if a not in keep)]
    heads = [s for s in islands if all(mesh.coords(s)[a] == 0 for a in partial)]
    summed = {}
    for s in heads:
        total = parts[s].to(dev)
        for m in mesh.group(s, tuple(partial))[1:]:
            total = total + parts[m].to(dev)
        summed[s] = total

    def build(level: int, islands: list[int]) -> torch.Tensor:
        if level == len(sharded):
            return summed[islands[0]]
        d, axes = sharded[level]
        blocks: dict[int, list[int]] = {}
        for s in islands:
            blocks.setdefault(_lin(mesh, s, axes), []).append(s)
        return torch.cat([build(level + 1, blocks[i]) for i in sorted(blocks)], dim=d)

    return build(0, heads)


class _Psum(torch.autograd.Function):
    """A sum over a ``DeviceMesh`` dim whose gradient is the same sum (each
    device's partial feeds every device's use of the total)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed._functional_collectives as funcol

        ctx.group = group
        return funcol.wait_tensor(funcol.all_reduce(x, "sum", group))

    @staticmethod
    def backward(ctx, g):
        import torch.distributed._functional_collectives as funcol

        return funcol.wait_tensor(funcol.all_reduce(g, "sum", ctx.group)), None


def is_dtensor(x) -> bool:
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:  # a torch built without distributed
        return False
    return isinstance(x, DTensor)



def _shard_map_dtensor(body, in_specs, out_specs, args):
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.distributed.sharding import placements

    from torch.distributed.tensor import DTensor, Replicate

    dmesh = next(a.device_mesh for a in args if is_dtensor(a))
    names = dmesh.mesh_dim_names
    # a plain tensor argument is the same on every device (replicated)
    args = tuple(DTensor.from_local(a, dmesh, [Replicate()] * dmesh.ndim, run_check=False)
                 if isinstance(a, torch.Tensor) and not is_dtensor(a) else a for a in args)

    def dims(axes) -> list[int]:
        """The device-mesh dims that ``axes`` make up, whole."""
        out = [i for i, n in enumerate(names) if set(n.split("+")) & set(axes)]
        if sorted(a for i in out for a in names[i].split("+")) != sorted(axes):
            raise ValueError(f"mesh axes {axes} are not whole dims of the device mesh {names}")
        return out

    def pl(spec):
        for e in spec:
            dims(spec_axes(e))
        return placements(spec, names)

    in_pl = tuple(None if not isinstance(x, torch.Tensor)
                  else pl(spec if spec is not None else (None,) * x.ndim)
                  for x, spec in zip(args, in_specs))
    out_pl = []
    for spec, part in out_specs:
        p = pl(spec)
        for i in dims(tuple(part)):
            p[i] = Partial()
        out_pl.append(p)

    def ix(axes):
        i = 0
        for d in dims(tuple(axes)):
            i = i * dmesh.size(d) + dmesh.get_local_rank(names[d])
        return i

    def group(axes):
        d = dims(tuple(axes))
        if len(d) != 1:
            raise ValueError(f"a collective spans one device-mesh dim, not {axes}")
        return (dmesh, d[0])

    def local(*largs):
        prog = body(ix, *largs)
        if not inspect.isgenerator(prog):
            return prog
        res = None
        while True:
            try:
                kind, axes, x, *rest = prog.send(res)
            except StopIteration as stop:
                return stop.value
            if not axes:
                res = x
            elif kind == "psum":
                res = _Psum.apply(x, group(axes))
            elif kind == "pmax":
                res = funcol.wait_tensor(funcol.all_reduce(x.detach(), "max", group(axes)))
            elif kind == "all_gather":
                res = funcol.all_gather_tensor_autograd(x, rest[0], group(axes))
            elif kind == "all_to_all":
                res = funcol.all_to_all_single_autograd(x, None, None, group(axes))
            else:
                raise ValueError(f"unknown collective {kind!r}")

    return local_map(local, out_placements=tuple(out_pl), in_placements=in_pl,
                     device_mesh=dmesh, redistribute_inputs=True)(*args)
