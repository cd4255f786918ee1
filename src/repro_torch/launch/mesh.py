"""Device meshes of the port: named axes over positions, each with a device.

Counterpart of ``repro/launch/mesh.py``.  The reference is single-controller:
one process runs ``jax.shard_map`` over a ``jax.sharding.Mesh``, and
``RetrievalIndex(mesh=...)`` takes that mesh as an argument.  The port keeps
that shape.  A ``Mesh`` is a grid of POSITIONS with named axes, each
position holding a ``torch.device`` (row-major order); ``core.distributed``
runs each shard body once per position, from the one calling thread, and
turns the collectives into copies between the positions' tensors.

Positions may share a device.  Four positions on one card run the real
schedule, the real kernels and the real data movement (device-to-device
copies); on four cards the same code copies between peers.  (A port with
one process per rank on ``torch.distributed`` could run only one rank on a
card: NCCL puts no two ranks of one communicator on one device.)

On CUDA each position has a stream of its own (``streams=False``: all of
them the caller's current stream).  A position's work is enqueued on its
stream (``Mesh.on``); a copy from position a to position b makes b's stream
wait for a's (``Mesh.copy``); a collective program (``Mesh.scope``) starts
after the caller's queued work and ends before the caller's next.

``make_production_mesh`` is the reference's pod layout, (16, 16) or
(2, 16, 16), with every position on the meta device: the dry run
(``launch/dryrun.py``) traces a cell over it, copies between positions
included, and allocates nothing.  ``make_host_mesh`` is what
``launch/serve.py --mesh`` uses.
"""
from __future__ import annotations

import contextlib
import math

import torch


class Mesh:
    """Named axes over positions, each on a ``torch.device``.

    ``shape[axis]`` is the axis' size, as ``jax.sharding.Mesh.shape`` gives
    it; ``devices[p]`` and ``streams[p]`` are position p's (row-major over
    ``axis_names``), the stream None on the CPU or with ``streams=False``.
    """

    def __init__(self, shape, axis_names, devices, *, streams: bool = True):
        shape = tuple(int(s) for s in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axis names {axis_names} do not match")
        if any(s < 1 for s in shape):
            raise ValueError(f"mesh axes must be at least 1 long: {shape}")
        devices = tuple(torch.device(d) for d in devices)
        if len(devices) != math.prod(shape):
            raise ValueError(f"a {shape} mesh needs {math.prod(shape)} devices, "
                             f"got {len(devices)}")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        self.devices = devices
        self.streams = tuple(torch.cuda.Stream(device=d) if streams and d.type == "cuda"
                             else None for d in devices)

    def __repr__(self) -> str:
        devs = sorted({str(d) for d in self.devices})
        return f"Mesh({self.shape}, devices={devs})"

    def axes(self, axes) -> tuple[str, ...]:
        """``axes`` as a tuple of this mesh's axis names (None: all of them)."""
        if axes is None:
            return self.axis_names
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in axes if a not in self.shape]
        if unknown:
            raise ValueError(f"axes {unknown} are not in the mesh's {self.axis_names}")
        return axes

    def coords(self, p: int) -> dict[str, int]:
        """Position ``p``'s index along each axis."""
        out = {}
        for a in reversed(self.axis_names):
            p, out[a] = divmod(p, self.shape[a])
        return {a: out[a] for a in self.axis_names}

    def position(self, coords: dict[str, int]) -> int:
        p = 0
        for a in self.axis_names:
            p = p * self.shape[a] + coords[a]
        return p

    def index_along(self, p: int, axes) -> int:
        """Position ``p``'s row-major index over ``axes`` alone (the block of
        an array sharded over them that it holds)."""
        c = self.coords(p)
        i = 0
        for a in self.axes(axes):
            i = i * self.shape[a] + c[a]
        return i

    def groups(self, axes) -> list[list[int]]:
        """The positions along ``axes``, row-major over them, one list for
        each setting of the other axes (in row-major order): the
        participants of one collective over ``axes``."""
        axes = self.axes(axes)
        others = [a for a in self.axis_names if a not in axes]
        out = []
        for o in range(math.prod(self.shape[a] for a in others)):
            oc = {}
            for a in reversed(others):
                o, oc[a] = divmod(o, self.shape[a])
            group = []
            for i in range(math.prod(self.shape[a] for a in axes)):
                c = dict(oc)
                for a in reversed(axes):
                    i, c[a] = divmod(i, self.shape[a])
                group.append(self.position(c))
            out.append(group)
        return out

    @contextlib.contextmanager
    def on(self, p: int):
        """Enqueue the block's work on position ``p``'s device and stream."""
        s = self.streams[p]
        if s is None:
            yield
            return
        with torch.cuda.device(self.devices[p]), torch.cuda.stream(s):
            yield

    def _stream(self, p: int):
        s = self.streams[p]
        if s is None and self.devices[p].type == "cuda":
            s = torch.cuda.current_stream(self.devices[p])
        return s

    def copy(self, t: torch.Tensor, src: int, dst: int) -> torch.Tensor:
        """Position ``src``'s tensor ``t``, copied onto position ``dst``'s
        device on its stream, after ``src``'s queued work.  ``t`` is marked
        as in use on ``dst``'s stream, so its memory is not reused before
        the copy has read it."""
        dev = self.devices[dst]
        if t.device.type != "cuda" and dev.type != "cuda":
            return t.to(dev, copy=True)
        ss, ds = self._stream(src), self._stream(dst)
        if ss is not None and ds is not None and ss != ds:
            ds.wait_stream(ss)
        with self.on(dst):
            out = torch.empty_like(t, device=dev)
            out.copy_(t)
        if t.device.type == "cuda" and ds is not None and ss != ds:
            t.record_stream(ds)
        return out

    def put(self, t: torch.Tensor, p: int) -> torch.Tensor:
        """The caller's tensor ``t`` on position ``p``'s device (itself where
        it already lies there), taken inside a ``scope``."""
        if t.device == self.devices[p]:
            return t
        with self.on(p):
            return t.to(self.devices[p])

    @contextlib.contextmanager
    def scope(self):
        """A collective program: every position's stream first waits for its
        device's current (the caller's) stream, and at the end the caller's
        stream waits for every position's.  So the program reads the
        caller's tensors after the work that made them, and the caller reads
        its results after the work that made them."""
        live = [(d, s) for d, s in zip(self.devices, self.streams) if s is not None]
        for d, s in live:
            s.wait_stream(torch.cuda.current_stream(d))
        try:
            yield self
        finally:
            for d, s in live:
                torch.cuda.current_stream(d).wait_stream(s)


def _cuda_devices() -> list[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass devices=[torch.device('cpu')] * n for a "
                           "mesh of CPU positions")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(shape, axis_names, *, devices=None, streams: bool = True) -> Mesh:
    """A ``Mesh`` of ``shape`` with ``axis_names``.  ``devices``: one per
    position, row-major (a device may repeat: ``[torch.device("cuda")] * 4``
    puts four positions on one card); by default the machine's CUDA devices,
    exactly as many as positions."""
    if devices is None:
        devices = _cuda_devices()
        if len(devices) != math.prod(shape):
            raise ValueError(f"a {tuple(shape)} mesh over this machine's {len(devices)} CUDA "
                             f"devices; pass devices= to place positions")
    return Mesh(shape, axis_names, devices, streams=streams)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production layout: a 16 x 16 ("data", "model") pod,
    or two of them on a leading "pod" axis, every position on the meta
    device (no streams)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, [torch.device("meta")] * math.prod(shape), streams=False)


def make_host_mesh(model_parallel: int | None = None, *, devices=None) -> Mesh:
    """Best-effort ``(data, model)`` mesh over ``devices`` (by default every
    CUDA device), square-ish where their count allows, as the reference's."""
    devices = _cuda_devices() if devices is None else list(devices)
    n = len(devices)
    if model_parallel is None:
        model_parallel = 1
        for m in (4, 2):
            if n % m == 0 and n >= m * m:
                model_parallel = m
                break
    if n % model_parallel:
        raise ValueError(f"{n} devices do not split into model_parallel={model_parallel}")
    return Mesh((n // model_parallel, model_parallel), ("data", "model"), devices)


def mesh_devices(mesh) -> int:
    """The number of positions of ``mesh``."""
    return math.prod(mesh.shape.values())
