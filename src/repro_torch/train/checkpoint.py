"""Fault-tolerant checkpoints: atomic, async, keep-N, streamed from the card.

Port of ``repro/train/checkpoint.py``, with its layout on disk::

    <dir>/step_00000123.tmp-<pid>-<thread>/   (write in progress)
    <dir>/step_00000123/                      (renamed in when complete)
        leaves.npz      (one ``leaf_XXXXX.npy`` member a leaf, zip64, stored)
        manifest.json   (step, tree description, leaf dtypes, time, extra)
    <dir>/LATEST        (text file, replaced last)

The leaves are numbered in ``jax.tree.flatten``'s order (``flatten``):
dict keys sorted, lists and tuples in order, a NamedTuple (``TrainState``,
``OptState``) a node of its fields, ``None`` no leaf, a ``Param`` its
value.  bfloat16 leaves are stored as uint16 words with the dtype
``"bfloat16"`` in the manifest, and the optimizer's step (a Python int in
the port, an int32 scalar in the reference) as int32.  So a checkpoint of
either package restores in the other (``np.load`` reads the archive).

What the port adds:

* **Streamed writes.**  ``leaves.npz`` is written member by member: a leaf
  on the card goes through pinned host blocks of ``BLOCK_BYTES`` straight
  into its member, never whole in host memory, its CRC32 folded in on a
  thread beside the write.  A full-width table (the
  two-tower model's 44.5 GB) is saved with two blocks of host memory.
* **In-place restores.**  ``restore`` reads each member block by block
  into the matching tensor of ``like`` (same shape and dtype), so restoring
  onto the card holds no second copy of the state there; every block's
  CRC is checked against the archive's.  A leaf of ``like`` on the meta
  device (a shape only) gets a new tensor on ``device``.
* **fsync.**  Each file is fsynced before the rename, as the port's
  snapshots are; ``stats`` (an optional dict) receives the bytes and the
  seconds of the write, the fsync and the whole save or restore.
* **Async saves.**  ``CheckpointManager.save(block=False)`` copies every
  leaf to host memory before it returns, because the next step overwrites
  the state in place; only the disk write runs on the thread.
  ``block=True`` streams from the card on the calling thread instead.

Sharded state (``distributed.sharding.Sharded`` leaves, a sharded train
step's) is saved as the reference saves its sharded arrays: each leaf the
global array, in the reference's layout, so checkpoints cross the packages
both ways whatever the meshes.  A leaf split along its first dimension only
(a row-sharded table, its accumulators) streams its blocks in order, the
first replica of each, never whole anywhere; any other split is put
together on its first position's device first.  Restore is elastic:
``shardings``, a tree of ``Sharding`` matching ``like`` (or ``like``'s own
``Sharded`` leaves), places each leaf's blocks on its mesh's positions, from
a checkpoint of any mesh: a first-dimension split is read block by block
straight into the parts (into ``like``'s own parts where they match), then
copied to the replicas.
"""
from __future__ import annotations

import concurrent.futures as cf
import io
import json
import os
import shutil
import struct
import threading
import time
import zlib

import numpy as np
import torch

from repro_torch.distributed.sharding import Sharded, Sharding
from repro_torch.models.nn import Param, is_param

_BF16 = "bfloat16"
BLOCK_BYTES = 256 << 20  # one pinned host block of a streamed leaf

_TORCH_TO_NP = {torch.float32: np.float32, torch.float64: np.float64, torch.float16: np.float16,
                torch.bfloat16: np.uint16, torch.int64: np.int64, torch.int32: np.int32,
                torch.int16: np.int16, torch.int8: np.int8, torch.uint8: np.uint8,
                torch.bool: np.bool_}
_NP_TO_TORCH = {np.dtype(v): k for k, v in _TORCH_TO_NP.items() if k is not torch.bfloat16}


# ---------------------------------------------------------------------------
# Trees in jax.tree.flatten's order.
# ---------------------------------------------------------------------------


def flatten(tree, is_leaf=None) -> list:
    """The leaves of ``tree`` in ``jax.tree.flatten``'s order (module docstring)."""
    out: list = []

    def walk(t):
        if is_leaf is not None and is_leaf(t):
            out.append(t)
        elif t is None:
            return
        elif is_param(t):
            walk(t.value)
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, (list, tuple)):
            for x in t:
                walk(x)
        else:
            out.append(t)

    walk(tree)
    return out


def unflatten(like, leaves):
    """``like``'s structure with its leaves replaced, in ``flatten``'s order."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if is_param(t):
            return Param(build(t.value), t.axes)
        if isinstance(t, dict):
            done = {k: build(t[k]) for k in sorted(t)}
            return {k: done[k] for k in t}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*[build(x) for x in t])
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def describe(tree) -> str:
    """A one-line description of ``tree``'s structure (the manifest's
    ``treedef``; nothing reads it back)."""
    def d(t):
        if t is None:
            return "None"
        if is_param(t):
            return d(t.value)
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {d(t[k])}" for k in sorted(t)) + "}"
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return f"{type(t).__name__}(" + ", ".join(d(x) for x in t) + ")"
        if isinstance(t, (list, tuple)):
            inner = ", ".join(d(x) for x in t)
            return f"[{inner}]" if isinstance(t, list) else f"({inner})"
        return "*"

    return d(tree)


# ---------------------------------------------------------------------------
# Leaves as bytes.
# ---------------------------------------------------------------------------


def _row_blocks(s: Sharding, ndim: int):
    """The positions holding a leaf's blocks in the global layout's order
    (the first replica of each), if ``s`` splits its first dimension only;
    else None."""
    if any(s.dim_axes(d) for d in range(1, ndim)):
        return None
    axes = s.dim_axes(0) if ndim else ()
    return s.mesh.groups(axes)[0] if axes else [0]


class _Leaf:
    """One leaf to write: its stored dtype and shape, the manifest's dtype
    name, and its bytes (tensors' in order, or a numpy array's)."""

    __slots__ = ("np_dtype", "shape", "name", "tensors", "array")

    def __init__(self, leaf):
        self.tensors, self.array = None, None
        if isinstance(leaf, Sharded):
            holders = _row_blocks(leaf.sharding, len(leaf.shape))
            ts = ([leaf.parts[p].detach() for p in holders] if holders is not None
                  else [leaf.whole().detach()])
            self._tensors(ts, leaf.shape)
            return
        if isinstance(leaf, torch.Tensor):
            self._tensors([leaf.detach()], tuple(leaf.shape))
            return
        if isinstance(leaf, bool):
            a = np.asarray(leaf)
        elif isinstance(leaf, int):  # the optimizer's step: int32, as the reference's
            a = np.asarray(leaf, np.int32 if -(1 << 31) <= leaf < (1 << 31) else np.int64)
        else:
            a = np.ascontiguousarray(np.asarray(leaf))
        self.array, self.np_dtype, self.shape = a, a.dtype, a.shape
        self.name = str(a.dtype)

    def _tensors(self, ts: list, shape) -> None:
        dtype = ts[0].dtype
        if dtype not in _TORCH_TO_NP:
            raise TypeError(f"cannot checkpoint a {dtype} tensor")
        self.np_dtype = np.dtype(_TORCH_TO_NP[dtype])
        self.name = _BF16 if dtype == torch.bfloat16 else self.np_dtype.name
        self.shape = tuple(shape)
        self.tensors = [t if t.is_contiguous() else t.contiguous() for t in ts]

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) * self.np_dtype.itemsize

    def host_copy(self) -> "_Leaf":
        """This leaf with its bytes copied to host memory."""
        if self.tensors is not None:
            self.tensors = [t.to("cpu", copy=True) if t.device.type != "cpu" else t.clone()
                            for t in self.tensors]
        else:
            self.array = self.array.copy()
        return self

    def blocks(self, pinned):
        """Yield this leaf's bytes as memoryviews of at most ``BLOCK_BYTES``;
        a block is valid until the next one is asked for."""
        if self.tensors is None:
            yield from self._host_blocks(self.array.reshape(-1).view(np.uint8))
            return
        for t in self.tensors:
            if t.device.type == "cpu":
                yield from self._host_blocks(t.reshape(-1).view(torch.uint8).numpy())
            else:
                yield from self._device_blocks(t, pinned)

    @staticmethod
    def _host_blocks(raw):
        for off in range(0, raw.nbytes, BLOCK_BYTES):
            yield memoryview(raw[off : off + BLOCK_BYTES])

    @staticmethod
    def _device_blocks(t, pinned):
        flat = t.reshape(-1).view(torch.uint8)
        stream = torch.cuda.Stream(device=flat.device)
        stream.wait_stream(torch.cuda.current_stream(flat.device))
        for off in range(0, flat.numel(), BLOCK_BYTES):
            m = min(BLOCK_BYTES, flat.numel() - off)
            buf = pinned.take(m)
            with torch.cuda.stream(stream):
                buf.copy_(flat[off : off + m], non_blocking=True)
            stream.synchronize()
            yield memoryview(buf.numpy())


class _Pinned:
    """Two page-locked host blocks used in turn; a block is handed out again
    only after the CRC computed on it has finished."""

    def __init__(self):
        self.bufs = [None, None]
        self.busy = [None, None]
        self.i = 0

    def take(self, m: int) -> torch.Tensor:
        j = self.i = 1 - self.i
        if self.busy[j] is not None:
            self.busy[j].result()
            self.busy[j] = None
        if self.bufs[j] is None:
            self.bufs[j] = torch.empty(BLOCK_BYTES, dtype=torch.uint8, pin_memory=True)
        return self.bufs[j][:m]

    def hold(self, fut) -> None:
        self.busy[self.i] = fut


# ---------------------------------------------------------------------------
# CRC32 over blocks, on a thread beside the disk.
# ---------------------------------------------------------------------------


class _Crc:
    """A running CRC32 of blocks, each folded in on ``pool`` (one thread, so
    in order) while the caller moves the next block."""

    def __init__(self, pool):
        self.pool, self.crc, self.last = pool, 0, None

    def add(self, mv):
        def fold():
            self.crc = zlib.crc32(mv, self.crc)

        self.last = self.pool.submit(fold)
        return self.last

    def value(self) -> int:
        if self.last is not None:
            self.last.result()
        return self.crc


# ---------------------------------------------------------------------------
# The archive: a zip64 of stored .npy members, as np.savez writes it.
# ---------------------------------------------------------------------------


def _npy_header(np_dtype, shape) -> bytes:
    buf = io.BytesIO()
    d = {"descr": np.lib.format.dtype_to_descr(np_dtype), "fortran_order": False,
         "shape": tuple(shape)}
    np.lib.format.write_array_header_1_0(buf, d)
    return buf.getvalue()


_DOS_TIME, _DOS_DATE = 0, (1 << 5) | 1  # 1980-01-01 00:00, the zip format's epoch


def _write_npz(path: str, leaves: list[_Leaf], stats: dict) -> None:
    """Write ``leaves`` as ``leaf_XXXXX.npy`` members of a zip64 archive
    (stored, as ``np.savez`` writes it), streaming each from its device."""
    central, pinned = [], _Pinned()
    t_write = time.perf_counter()
    with open(path, "wb") as f, cf.ThreadPoolExecutor(1) as pool:
        for i, leaf in enumerate(leaves):
            name = f"leaf_{i:05d}.npy".encode()
            head = _npy_header(leaf.np_dtype, leaf.shape)
            size = len(head) + leaf.nbytes
            offset = f.tell()
            extra = struct.pack("<HHQQ", 1, 16, size, size)
            f.write(struct.pack("<4s2B4HL2L2H", b"PK\x03\x04", 45, 0, 0, 0, _DOS_TIME,
                                _DOS_DATE, 0, 0xFFFFFFFF, 0xFFFFFFFF, len(name), len(extra)))
            f.write(name + extra)
            crc = _Crc(pool)
            crc.add(head)
            f.write(head)
            for mv in leaf.blocks(pinned):
                pinned.hold(crc.add(mv))
                f.write(mv)
            value = crc.value()
            end = f.tell()
            f.seek(offset + 14)
            f.write(struct.pack("<L", value))
            f.seek(end)
            central.append((name, value, size, offset))
        cd_start = f.tell()
        for name, value, size, offset in central:
            extra = struct.pack("<HHQQQ", 1, 24, size, size, offset)
            f.write(struct.pack("<4s4B4HL2L5H2L", b"PK\x01\x02", 45, 3, 45, 0, 0, 0, _DOS_TIME,
                                _DOS_DATE, value, 0xFFFFFFFF, 0xFFFFFFFF, len(name), len(extra),
                                0, 0, 0, 0o600 << 16, 0xFFFFFFFF))
            f.write(name + extra)
        cd_end = f.tell()
        n = len(central)
        f.write(struct.pack("<4sQ2H2L4Q", b"PK\x06\x06", 44, 45, 45, 0, 0, n, n,
                            cd_end - cd_start, cd_start))
        f.write(struct.pack("<4sLQL", b"PK\x06\x07", 0, cd_end, 1))
        f.write(struct.pack("<4s4H2LH", b"PK\x05\x06", 0, 0, min(n, 0xFFFF), min(n, 0xFFFF),
                            min(cd_end - cd_start, 0xFFFFFFFF), min(cd_start, 0xFFFFFFFF), 0))
        f.flush()
        stats["write_s"] = stats.get("write_s", 0.0) + time.perf_counter() - t_write
        t_sync = time.perf_counter()
        os.fsync(f.fileno())
        stats["fsync_s"] = stats.get("fsync_s", 0.0) + time.perf_counter() - t_sync
        stats["bytes"] = stats.get("bytes", 0) + cd_end


def _write_text(path: str, text: str, stats: dict) -> None:
    with open(path, "w") as f:
        f.write(text)
        f.flush()
        t0 = time.perf_counter()
        os.fsync(f.fileno())
        stats["fsync_s"] = stats.get("fsync_s", 0.0) + time.perf_counter() - t0


def _write(path: str, leaves: list[_Leaf], treedef: str, step: int, extra, stats: dict) -> str:
    t0 = time.perf_counter()
    final = os.path.join(path, f"step_{step:08d}")
    tmp = final + f".tmp-{os.getpid()}-{threading.get_ident()}"
    os.makedirs(tmp, exist_ok=True)
    _write_npz(os.path.join(tmp, "leaves.npz"), leaves, stats)
    meta = {"treedef": treedef, "n_leaves": len(leaves),
            "dtypes": {f"leaf_{i:05d}": leaf.name for i, leaf in enumerate(leaves)}}
    _write_text(os.path.join(tmp, "manifest.json"),
                json.dumps({"step": step, "time": time.time(), "meta": meta,
                            "extra": extra or {}, "complete": True}), stats)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _write_text(os.path.join(path, "LATEST.tmp"), str(step), stats)
    os.replace(os.path.join(path, "LATEST.tmp"), os.path.join(path, "LATEST"))
    stats["seconds"] = time.perf_counter() - t0
    return final


def save(path: str, tree, step: int, extra: dict | None = None, *,
         stats: dict | None = None) -> str:
    """Atomic synchronous save of ``tree`` under ``path``/step_<step>,
    streamed from the leaves' devices; returns the step's directory."""
    leaves = [_Leaf(x) for x in flatten(tree)]
    return _write(path, leaves, describe(tree), step, extra, {} if stats is None else stats)


def _valid(path: str, step: int) -> bool:
    d = os.path.join(path, f"step_{step:08d}")
    try:
        with open(os.path.join(d, "manifest.json")) as f:
            m = json.load(f)
        return m.get("complete", False) and os.path.exists(os.path.join(d, "leaves.npz"))
    except (OSError, json.JSONDecodeError):
        return False


def available_steps(path: str) -> list[int]:
    if not os.path.isdir(path):
        return []
    steps = []
    for name in os.listdir(path):
        if name.startswith("step_") and not name.endswith(".tmp") and ".tmp-" not in name:
            try:
                s = int(name[len("step_"):])
            except ValueError:
                continue
            if _valid(path, s):
                steps.append(s)
    return sorted(steps)


def latest_step(path: str) -> int | None:
    """Newest checkpoint that passes validation (torn saves are skipped)."""
    steps = available_steps(path)
    return steps[-1] if steps else None


# ---------------------------------------------------------------------------
# Restore.
# ---------------------------------------------------------------------------


def _members(f) -> dict[str, tuple[int, int, int]]:
    """name -> (data offset, size, crc) of each member of the open archive."""
    import zipfile

    out = {}
    with zipfile.ZipFile(f) as zf:
        for info in zf.infolist():
            f.seek(info.header_offset + 26)
            n_name, n_extra = struct.unpack("<2H", f.read(4))
            out[info.filename] = (info.header_offset + 30 + n_name + n_extra, info.file_size,
                                  info.CRC)
    return out


def _read_header(f, pool, member, key: str, tmpl):
    """(shape, dtype, data bytes, the running CRC, the archive's CRC) of one
    member, the file positioned at its data; its shape must be ``tmpl``'s."""
    offset, size, want_crc = member
    f.seek(offset)
    version = np.lib.format.read_magic(f)
    reader = (np.lib.format.read_array_header_1_0 if version == (1, 0)
              else np.lib.format.read_array_header_2_0)
    shape, fortran, np_dtype = reader(f)
    head_len = f.tell() - offset
    nbytes = size - head_len
    crc = _Crc(pool)
    f.seek(offset)
    crc.add(f.read(head_len))
    tshape = tuple(getattr(tmpl, "shape", ()))
    assert tuple(shape) == tshape and not fortran, (key, shape, tshape)
    return shape, np_dtype, nbytes, crc, want_crc


def _read_into(f, mv) -> None:
    if f.readinto(mv) != len(mv):
        raise OSError(f"{f.name}: the archive ends inside a member")


def _fill(f, dst: torch.Tensor, nbytes: int, crc: _Crc, pinned: _Pinned) -> None:
    """Read ``nbytes`` from ``f`` into the bytes of ``dst`` (contiguous)."""
    flat = dst.reshape(-1).view(torch.uint8)
    if dst.device.type == "cpu":
        view = flat.numpy()
        for off in range(0, nbytes, BLOCK_BYTES):
            mv = memoryview(view[off : off + BLOCK_BYTES])
            _read_into(f, mv)
            crc.add(mv)
        return
    stream = torch.cuda.Stream(device=dst.device)
    stream.wait_stream(torch.cuda.current_stream(dst.device))
    events = [None, None]
    for off in range(0, nbytes, BLOCK_BYTES):
        m = min(BLOCK_BYTES, nbytes - off)
        j = 1 - pinned.i
        if events[j] is not None:
            events[j].synchronize()  # the block's last upload is done
        buf = pinned.take(m)
        mv = memoryview(buf.numpy())
        _read_into(f, mv)
        pinned.hold(crc.add(mv))
        with torch.cuda.stream(stream):
            flat[off : off + m].copy_(buf, non_blocking=True)
            events[j] = torch.cuda.Event()
            events[j].record(stream)
    stream.synchronize()
    torch.cuda.current_stream(dst.device).wait_stream(stream)


def _fill_sharded(f, s: Sharding, shape, dtype, nbytes: int, crc: _Crc, pinned: _Pinned,
                  into: Sharded | None) -> Sharded:
    """A ``Sharded`` of the member's global array of ``shape``, by ``s``
    (module docstring); ``into``'s parts are filled in place where given."""
    mesh = s.mesh
    local = s.shard_shape(shape)

    def part(p):
        if into is not None and into.parts[p].dtype == dtype and into.parts[p].is_contiguous():
            return into.parts[p].detach()
        return torch.empty(local, dtype=dtype, device=mesh.devices[p])

    holders = _row_blocks(s, len(shape))
    if holders is None:
        whole = torch.empty(shape, dtype=dtype, device=mesh.devices[0])
        _fill(f, whole, nbytes, crc, pinned)
        parts = s.shard(whole)
        if into is not None:
            parts = [part(p).copy_(t) for p, t in enumerate(parts)]
        return Sharded(s, shape, parts)
    parts = [None] * len(mesh.devices)
    for p in holders:
        parts[p] = part(p)
        _fill(f, parts[p], nbytes // len(holders), crc, pinned)
    axes = s.dim_axes(0) if shape else ()
    owner = {mesh.index_along(p, axes) if axes else 0: p for p in holders}
    for p in range(len(parts)):  # the replicas, on the current stream, as _fill
        if parts[p] is None:
            src = parts[owner[mesh.index_along(p, axes) if axes else 0]]
            parts[p] = (part(p).copy_(src) if into is not None
                        else src.to(mesh.devices[p], copy=True))
    return Sharded(s, shape, parts)


def restore(path: str, like, step: int | None = None, shardings=None, *, device="cpu",
            stats: dict | None = None):
    """Restore into the structure of ``like``: ``(tree, step, extra)``.

    A tensor leaf of ``like`` with the checkpoint's shape and dtype is
    filled in place (and returned); a meta tensor, or one of another dtype,
    gets a new tensor on its device (``device`` for meta); a Python int or
    float leaf comes back as one.  ``shardings`` (a tree of ``Sharding``
    matching ``like``), or a ``Sharded`` leaf of ``like``, places the leaf's
    blocks on the mesh's positions as a ``Sharded`` (module docstring).
    """
    t0 = time.perf_counter()
    stats = {} if stats is None else stats
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no valid checkpoint under {path}")
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    dtypes = manifest["meta"]["dtypes"]
    leaves_like = flatten(like)
    n = manifest["meta"]["n_leaves"]
    assert n == len(leaves_like), f"checkpoint has {n} leaves, model {len(leaves_like)}"
    places = ([None] * n if shardings is None else
              flatten(shardings, is_leaf=lambda x: isinstance(x, Sharding)))
    places = [t.sharding if p is None and isinstance(t, Sharded) else p
              for t, p in zip(leaves_like, places)]
    out, total, pinned = [], 0, _Pinned()
    with open(os.path.join(d, "leaves.npz"), "rb") as f, \
            cf.ThreadPoolExecutor(1) as pool:
        members = _members(f)
        for i, (tmpl, place) in enumerate(zip(leaves_like, places)):
            key = f"leaf_{i:05d}"
            shape, np_dtype, nbytes, crc, want = _read_header(f, pool, members[key + ".npy"],
                                                              key, tmpl)
            tdtype = torch.bfloat16 if dtypes[key] == _BF16 else _NP_TO_TORCH.get(np_dtype)
            if place is not None and tdtype is not None and isinstance(
                    tmpl, (torch.Tensor, Sharded)):
                into = tmpl if isinstance(tmpl, Sharded) and tmpl.sharding == place else None
                leaf = _fill_sharded(f, place, tuple(shape), tdtype, nbytes, crc, pinned, into)
            elif isinstance(tmpl, torch.Tensor) and tdtype is not None:
                dev = torch.device(device) if tmpl.device.type == "meta" else tmpl.device
                if (tmpl.device.type != "meta" and tmpl.dtype == tdtype
                        and tmpl.is_contiguous()):
                    dst = tmpl.detach()
                else:
                    dst = torch.empty(shape, dtype=tdtype, device=dev)
                _fill(f, dst, nbytes, crc, pinned)
                leaf = dst
            else:
                a = np.empty(shape, np_dtype)
                if nbytes:
                    _read_into(f, memoryview(a.reshape(-1).view(np.uint8)))
                    crc.add(memoryview(a.reshape(-1).view(np.uint8)))
                if dtypes[key] == _BF16:
                    leaf = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
                elif isinstance(tmpl, bool):
                    leaf = bool(a)
                elif isinstance(tmpl, int):
                    leaf = int(a)
                elif isinstance(tmpl, float):
                    leaf = float(a)
                elif isinstance(tmpl, torch.Tensor):
                    leaf = torch.from_numpy(a)
                else:
                    leaf = a
            got = crc.value()
            if got != want:
                raise OSError(f"{d}: {key} fails its CRC ({got:#010x} != {want:#010x})")
            total += nbytes
            out.append(leaf)
    stats.update(bytes=total, seconds=time.perf_counter() - t0)
    return unflatten(like, out), step, manifest["extra"]


# ---------------------------------------------------------------------------
# Async saves + keep-N.
# ---------------------------------------------------------------------------


class CheckpointManager:
    """Async save + keep-N GC.  ``save`` returns once the leaves are in host
    memory; ``wait`` joins the write.  ``last_stats`` holds the newest
    finished save's ``stats``."""

    def __init__(self, path: str, keep: int = 3):
        self.path = path
        self.keep = keep
        os.makedirs(path, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self.last_stats: dict = {}

    def save(self, tree, step: int, extra: dict | None = None, block: bool = False):
        self.wait()  # one in-flight save at a time
        leaves = [_Leaf(x) for x in flatten(tree)]
        treedef = describe(tree)
        if block:  # streamed from the device on this thread, no host copy
            self._work(leaves, treedef, step, extra)
            self.wait()
            return
        # The host copy happens HERE, synchronously: the caller's next step
        # overwrites the state in place; only the disk write is async.
        t0 = time.perf_counter()
        leaves = [leaf.host_copy() for leaf in leaves]
        copy_s = time.perf_counter() - t0
        self._thread = threading.Thread(target=self._work,
                                        args=(leaves, treedef, step, extra, copy_s), daemon=True)
        self._thread.start()

    def _work(self, leaves, treedef, step, extra, copy_s=0.0):
        try:
            stats = {"host_copy_s": copy_s}
            _write(self.path, leaves, treedef, step, extra, stats)
            self.last_stats = stats
            self._gc()
        except BaseException as e:  # surfaced on the next wait()
            self._error = e

    def _gc(self):
        steps = available_steps(self.path)
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.path, f"step_{s:08d}"), ignore_errors=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
