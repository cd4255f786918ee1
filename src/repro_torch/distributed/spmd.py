"""Bodies: one program run on every position of a mesh, in lockstep, from one thread.

The reference partitions a jitted step over its mesh (GSPMD): each device
runs the step on its own shards, and XLA puts collectives where a sharded
dimension meets a whole one.  The port keeps ``core.distributed``'s
single-controller design: inside ``body(mesh)``, a value is a ``Local``,
one tensor a position, and every torch function or tensor method applied
to ``Local`` values runs once a position, each on that position's device and
stream (``Mesh.on``), before the next op starts.  So the models' code runs
unchanged on each position's shards; where a sharded dimension meets a
whole one the model calls a collective (``all_gather``, ``all_reduce``
over mesh axes, ``core.distributed``'s autograd functions), and autograd differentiates the whole program, collectives
included, as one graph across positions.

A plain tensor that meets a ``Local`` stands for the same value on every
position (``Mesh.put``: no copy on a position of its own device); a
``torch.device`` argument that is the first position's stands for each
position's own (``x.to(device=w.device)``, ``w`` a ``Local``, keeps each
part on its position).  A ``Local`` answers ``shape``, ``dtype`` and
``device`` with its first part's: the bodies here give every position parts
of one shape, and code that needs a position's own values (its rows of a
table, its block of the batch) loops over ``parts`` itself.

Tracing.  On a mesh whose positions are all on the meta device (the dry
run, ``launch.dryrun``), a body opened with ``symmetric=True`` runs one
program for all positions: each op, ``per_position`` function and kernel
call runs on position 0's operands once, its result standing for every
position's, and each collective runs over the group of position 0 once,
its results standing for every group's.  ``weight()`` is how many
positions' (or groups') work the running op stands for; the dry run's
tracer counts each op and each new storage that many times, so a step
over 256 positions traces in the time of one.  The positions must run
one program on parts of one shape, and the body must take no gradient
(autograd's backward runs outside the ops a body sees).

Gradients.  A body's loss is a ``Local``: each position's share of the
step's one loss (``distributed.steps``: the mean over its block of the
batch, which the positions that differ only along the model axes compute
alike).  The backward is seeded with 1/P on each of the P positions, so the
copies of one value together count once, and every collective's backward
is its exact transpose: ``all_reduce``'s is an all-reduce, ``all_gather``'s
a reduce-scatter.  A position's gradient of a parameter block is then its
share, and the block's gradient is the sum of the shares over the
positions that hold it (``train.optim.sum_replicas``,
``train.optim.merge_row_grads``).
"""
from __future__ import annotations

import contextlib
import threading

import torch

from repro_torch.core import distributed as KD

_LOCAL = threading.local()


class _Body:
    __slots__ = ("mesh", "batch_axes", "caller", "symmetric")

    def __init__(self, mesh, batch_axes, symmetric=False):
        self.mesh, self.batch_axes = mesh, tuple(batch_axes)
        self.symmetric = symmetric and all(d.type == "meta" for d in mesh.devices)
        # The caller's stream on each card: a plain tensor made during the
        # body (a factory's result, an index) is queued there.
        self.caller = {_card(d): torch.cuda.current_stream(d) for d in set(mesh.devices)
                       if d.type == "cuda"}


def _card(d: torch.device) -> torch.device:
    """A CUDA device with its index (``cuda`` is the current card), as a
    tensor's ``device`` names it."""
    return d if d.index is not None else torch.device("cuda", torch.cuda.current_device())


def current() -> _Body | None:
    """The body the calling thread is in (None outside one)."""
    return getattr(_LOCAL, "body", None)


@contextlib.contextmanager
def body(mesh, batch_axes=(), *, symmetric: bool = False):
    """Run the block as a body over ``mesh``'s positions; ``batch_axes``
    are the mesh axes the batch rows are split over (() whole).
    ``symmetric``: on a mesh of meta positions, trace one program for all
    (module docstring)."""
    prev = current()
    _LOCAL.body = _Body(mesh, batch_axes, symmetric)
    try:
        with mesh.scope():
            yield _LOCAL.body
    finally:
        _LOCAL.body = prev


def weight() -> int:
    """How many positions' (or groups') work the running op stands for
    (module docstring): 1 but inside a symmetric body's op."""
    return getattr(_LOCAL, "weight", 1)


@contextlib.contextmanager
def _weighted(n: int):
    prev = weight()
    _LOCAL.weight = n
    try:
        yield
    finally:
        _LOCAL.weight = prev


def _symmetric(fn, P: int):
    """``fn()`` once, standing for ``P`` positions: its ops weighted ``P``,
    its kernels' shape calls (``kernels._backend.shape_call``) recorded
    ``P`` times."""
    from repro_torch.kernels import _backend as KB

    logs = getattr(KB._SHAPES, "logs", ())
    marks = [len(log) for log in logs]
    with _weighted(P):
        out = fn()
    for log, n in zip(logs, marks):
        log.extend(log[n:] * (P - 1))
    return out


def batch_axes() -> tuple[str, ...]:
    b = current()
    return () if b is None else b.batch_axes


def _mesh():
    b = current()
    if b is None:
        raise RuntimeError("a Local is used outside a body (distributed.spmd.body)")
    return b.mesh


def plain(t: torch.Tensor, p: int, mesh) -> torch.Tensor:
    """A plain (caller's) tensor as position ``p`` reads it: on its device,
    after the caller's queued work, and kept from reuse until the
    position's stream has read it."""
    t = mesh.put(t, p)
    s = mesh.streams[p]
    if s is not None and t.is_cuda:
        b = current()
        caller = None if b is None else b.caller.get(_card(t.device))
        if caller is not None and caller != s:
            s.wait_stream(caller)
            t.record_stream(s)
    return t


def _pick(x, p: int, mesh):
    if isinstance(x, Local):
        return x.parts[p]
    if isinstance(x, torch.Tensor):
        return plain(x, p, mesh)
    if isinstance(x, torch.device):
        return mesh.devices[p] if x == mesh.devices[0] else x
    if isinstance(x, torch.Size):
        return x
    if isinstance(x, (list, tuple)):
        return type(x)(_pick(y, p, mesh) for y in x)
    if isinstance(x, dict):
        return {k: _pick(v, p, mesh) for k, v in x.items()}
    return x


def _spread(x, mesh, P: int) -> list:
    """``[_pick(x, p, mesh) for p in range(P)]``, walking ``x`` once."""
    if type(x) is Local:
        return x.parts
    if isinstance(x, torch.Tensor):
        return [plain(x, p, mesh) for p in range(P)]
    if isinstance(x, (list, tuple)) and not isinstance(x, torch.Size):
        cols = [_spread(y, mesh, P) for y in x]
        return [type(x)(c[p] for c in cols) for p in range(P)]
    if isinstance(x, dict):
        cols = {k: _spread(v, mesh, P) for k, v in x.items()}
        return [{k: c[p] for k, c in cols.items()} for p in range(P)]
    if isinstance(x, torch.device):
        return [_pick(x, p, mesh) for p in range(P)]
    return [x] * P


def _wrap(outs: list):
    o = outs[0]
    if isinstance(o, torch.Tensor):
        return Local(outs)
    if isinstance(o, tuple) and not isinstance(o, torch.Size):
        return tuple(_wrap([x[i] for x in outs]) for i in range(len(o)))
    if isinstance(o, list):
        return [_wrap([x[i] for x in outs]) for i in range(len(o))]
    return o


def _apply(func, args, kwargs):
    mesh = _mesh()
    P = len(mesh.devices)
    if current().symmetric:
        out = _symmetric(lambda: func(*_pick(args, 0, mesh), **_pick(kwargs, 0, mesh)), P)
        return _wrap([out] * P)
    cols = [_spread(a, mesh, P) for a in args]
    kcols = {k: _spread(v, mesh, P) for k, v in kwargs.items()}
    outs = []
    for p in range(P):
        with mesh.on(p):
            outs.append(func(*[c[p] for c in cols], **{k: c[p] for k, c in kcols.items()}))
    return _wrap(outs)


class Local:
    """One value of a body: ``parts``, one tensor a position (module
    docstring); ``sharding`` is a parameter block's ``Sharding`` (None for
    an activation)."""

    __slots__ = ("parts", "sharding")

    def __init__(self, parts, sharding=None):
        self.parts = list(parts)
        self.sharding = sharding

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        return _apply(func, args, kwargs or {})

    def __getattr__(self, name):
        if name in Local.__slots__:
            raise AttributeError(name)
        first = getattr(self.parts[0], name)
        if callable(first):
            method = getattr(torch.Tensor, name)
            return lambda *a, **k: _apply(method, (self, *a), k)
        return _wrap([getattr(t, name) for t in self.parts])

    def __len__(self):
        return len(self.parts[0])

    def __bool__(self):
        raise TypeError("a Local has one value a position")

    __hash__ = object.__hash__

    def __repr__(self):
        return f"Local({len(self.parts)} x {tuple(self.parts[0].shape)})"


def _dunder(name):
    method = getattr(torch.Tensor, name)

    def f(self, *a):
        return _apply(method, (self, *a), {})

    f.__name__ = name
    return f


for _name in ("__add__", "__radd__", "__sub__", "__rsub__", "__mul__", "__rmul__",
              "__truediv__", "__rtruediv__", "__matmul__", "__rmatmul__", "__pow__",
              "__rpow__", "__neg__", "__getitem__", "__setitem__", "__eq__", "__ne__",
              "__lt__", "__le__", "__gt__", "__ge__", "__and__", "__or__", "__invert__",
              "__abs__", "__floordiv__", "__mod__"):
    setattr(Local, _name, _dunder(_name))


def per_position(fn):
    """``Local([fn(p) for each position p])``, each under ``Mesh.on(p)`` (a
    tuple of results a tuple of ``Local`` values)."""
    mesh = _mesh()
    if current().symmetric:
        return _wrap([_symmetric(lambda: fn(0), len(mesh.devices))] * len(mesh.devices))
    outs = []
    for p in range(len(mesh.devices)):
        with mesh.on(p):
            outs.append(fn(p))
    return _wrap(outs)


def part(x, p: int):
    """Position ``p``'s tensor of ``x``: a ``Local``'s part, or a plain
    tensor as the position reads it (``plain``)."""
    return x.parts[p] if isinstance(x, Local) else plain(x, p, _mesh())


def call(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` for a function that ``Local.__torch_function__``
    never sees (a kernel wrapper: a ctypes launch, not a torch op): inside
    a body, with a ``Local`` among the arguments, once a position, on that
    position's device and stream (``Mesh.on``), each ``Local`` its part and
    a plain tensor as the position reads it (``plain``); the results as
    ``Local`` values.  Elsewhere, ``fn`` itself."""
    if current() is None or not any(isinstance(a, Local) for a in (*args, *kwargs.values())):
        return fn(*args, **kwargs)
    return _apply(fn, args, kwargs)


def index_first(x, i: int):
    """``x[i]`` along dimension 0; a parameter block keeps its ``Sharding``
    (the spec past its first entry), so a layer of a stacked leaf still
    answers ``split_axes``."""
    if isinstance(x, Local):
        sh = x.sharding
        return Local([t[i] for t in x.parts],
                     None if sh is None else sh._replace(spec=tuple(sh.spec[1:])))
    return x[i]


def gather_fsdp(x):
    """A parameter block whole along each dimension split over the mesh
    axes of the rule table's ``"fsdp"`` (``sharding.axis_rules``), by
    ``all_gather`` over that dimension's axes, its ``Sharding`` saying so;
    a tree of them leaf by leaf, anything else as it is.  The FSDP gather
    of a layer's leaves: the result is the caller's to drop once used.
    The identity outside a body."""
    from repro_torch.distributed.sharding import current_rules

    rules = current_rules()
    if current() is None or rules is None:
        return x
    return _gather_dims(x, tuple(rules.rules.get("fsdp", ())))


def _gather_dims(x, axes):
    if isinstance(x, dict):
        return {k: _gather_dims(v, axes) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and not isinstance(x, torch.Size):
        return type(x)(_gather_dims(v, axes) for v in x)
    if not isinstance(x, Local) or x.sharding is None or not axes:
        return x
    sh, spec = x.sharding, list(x.sharding.spec)
    for d in range(len(spec)):
        dim_axes = sh.dim_axes(d)
        if dim_axes and set(dim_axes) <= set(axes):
            x = all_gather(x, d, dim_axes)
            spec[d] = None
    return Local(x.parts, sh._replace(spec=tuple(spec)))


def narrow_along(x, dim: int, axes, size: int):
    """Each position's block of ``size`` along ``dim`` of ``x`` (whole along
    ``dim`` on every position): its index along ``axes`` times ``size``."""
    if not axes:
        return x
    mesh = _mesh()
    return per_position(lambda p: part(x, p).narrow(dim, mesh.index_along(p, axes) * size, size))


def split_axes(w, dim: int) -> tuple[str, ...]:
    """The mesh axes a parameter block's dimension ``dim`` is split over:
    () for a whole dimension, and outside a body."""
    if isinstance(w, Local) and w.sharding is not None:
        return w.sharding.dim_axes(dim % len(w.parts[0].shape))
    return ()


def _collective(fn, x: Local, axes, *args) -> Local:
    mesh = _mesh()
    out = [None] * len(x.parts)
    groups = mesh.groups(axes)
    if current().symmetric:  # the first group's, standing for every group's
        with _weighted(len(groups)):
            got = fn(mesh, groups[0], [x.parts[q] for q in groups[0]], *args)
        for group in groups:
            for p, t in zip(group, got):
                out[p] = t
        return Local(out)
    for group in groups:
        for p, t in zip(group, fn(mesh, group, [x.parts[q] for q in group], *args)):
            out[p] = t
    return Local(out)


def all_gather(x, dim: int, axes) -> Local:
    """The parts of each group along ``axes`` concatenated along ``dim``,
    on every position of the group (``core.distributed.all_gather``)."""
    return x if not axes else _collective(KD.all_gather, x, axes, dim)


def all_reduce(x, axes) -> Local:
    """The parts of each group along ``axes`` summed in position order, on
    every position of the group (``core.distributed.all_reduce``)."""
    return x if not axes else _collective(KD.all_reduce, x, axes)


def gather_split(x, w, w_dim: int, x_dim: int):
    """``x`` whole along ``x_dim`` where it came out split because the
    parameter ``w``'s dimension ``w_dim`` is (a column-split layer's
    output before the next layer); ``x`` itself otherwise."""
    return all_gather(x, x_dim, split_axes(w, w_dim))


def row_split_matmul(x, w):
    """``x @ w`` for ``w`` whose rows (dimension 0) may be split: each
    position multiplies its columns of ``x`` (taken from a whole ``x``, or
    ``x`` already split alike) by its rows of ``w``, and the partial
    products are summed (``all_reduce``).  ``x @ w`` for a whole ``w``."""
    axes = split_axes(w, 0)
    if not axes:
        return x @ w
    rows = w.parts[0].shape[0]
    if x.shape[-1] != rows:  # a whole x: each position's block of its columns
        mesh = _mesh()
        x = per_position(lambda p: x.parts[p].narrow(
            -1, mesh.index_along(p, axes) * rows, rows))
    return all_reduce(x @ w, axes)
