"""RPC wire protocol for process-isolated shard workers (DESIGN.md §15).

Port of ``repro/serving/transport.py``: the same frames, byte for byte, so
a port worker answers a reference parent and the other way round.  One
difference of form: numpy has no bfloat16 and the port takes no
``ml_dtypes``, so a bf16 array is carried as its raw 2-byte words, a numpy
``V2`` array (as ``serving.snapshot`` writes a bf16 replica), under the
dtype name ``"bfloat16"``: ``encode_result`` rounds through
``torch.bfloat16`` (to nearest even, as ``ml_dtypes`` does) and
``decode_result`` widens the words back through torch to fp32.

The aggregator/worker split of the source architecture (and FAISS's
billion-scale blueprint) is a PROCESS boundary: a worker owns its shard
image in its own address space and ships back nothing but a sorted
length-K run.  This module is that boundary's wire format — the framing,
the array codec, and the error codec — kept free of any socket or process
machinery so every byte-level property is testable against plain buffers
(the fuzz suite corrupts frames without a worker in sight).

Framing.  Every message is one frame::

    | magic "RPCW" | version u16 | type u16 | payload_len u32 | crc32 u32 |
    | payload (payload_len bytes)                                         |

The header is fixed (16 bytes, little-endian); ``crc32`` covers the
type-identifying header prefix (magic, version, type) AND the payload, so
a bit-flip in the frame type cannot silently relabel a message — every
header byte is either structurally validated or CRC-covered.  The payload
is ``meta_len u32 | meta json | array blobs``: a
JSON metadata dict whose ``"arrays"`` entry records (name, dtype, shape)
for each raw ndarray blob concatenated after it, in order.  Anything that
does not parse EXACTLY — short header, wrong magic, version skew,
truncated payload, CRC mismatch, undeclared dtype, blob/shape byte-count
disagreement, unknown frame type — raises ``WireError``, a subclass of
``shards.TornResultError``: a corrupt frame fails over precisely like a
torn in-process reply (router validation, health bookkeeping, replica
retry), never hangs a reader and never reaches the merge.

Result wire.  ``encode_result``/``decode_result`` ship a worker's sorted
[m, K] run; ``wire_dtype="bfloat16"`` stores the value leg in bf16 —
idempotent with ``aggregate_topk(wire_dtype="bfloat16")``, which casts
runs to bf16 before the first merge round anyway, so shipping bf16 over
the wire changes zero result bits on the bf16-wire merge path (and the
fp32 default is bit-exact, full stop).

Error wire.  Structured errors cross the boundary as STRUCTURE, not
strings: ``encode_error``/``decode_error`` round-trip the registered
serving exceptions with their context (``cells``, ``shard_ids``,
per-replica ``Attempt`` records), so a parent-side handler sees the same
typed object an in-process worker would have raised.  Unregistered types
arrive as ``RemoteWorkerError`` carrying the original type name.
"""
from __future__ import annotations

import json
import socket
import struct
import zlib
from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.serving.health import Attempt
from repro_torch.serving.shards import (
    MissingShardError,
    ShardUnavailableError,
    TornResultError,
)
from repro_torch.serving.snapshot import SnapshotError

WIRE_MAGIC = b"RPCW"
WIRE_VERSION = 1
_HEADER = struct.Struct("<4sHHII")  # magic, version, type, payload len, crc32
HEADER_BYTES = _HEADER.size
# The CRC seeds from this prefix so a corrupted frame TYPE fails the
# checksum instead of parsing as a different (valid) message kind.
_CRC_PREFIX = struct.Struct("<4sHH")

# Frame types (u16).  HELLO is worker -> parent only; DRAIN/BYE bracket the
# graceful-shutdown handshake; PING/PONG carry the heartbeat.
F_HELLO = 1
F_QUERY = 2
F_RESULT = 3
F_ERROR = 4
F_PING = 5
F_PONG = 6
F_DRAIN = 7
F_BYE = 8
FRAME_TYPES = (F_HELLO, F_QUERY, F_RESULT, F_ERROR, F_PING, F_PONG,
               F_DRAIN, F_BYE)

# Array dtypes admitted on the wire — a closed set, because np.dtype() on an
# attacker-chosen string can name object dtypes whose deserialization is
# arbitrary code.  bfloat16 travels as its 2-byte words (numpy ``V2``).
_WIRE_DTYPES = ("float32", "float64", "bfloat16", "int64", "int32", "int8",
                "uint8", "bool")
_BF16_WORDS = np.dtype("V2")  # a bf16 array's 2-byte words


class WireError(TornResultError):
    """A frame that must not be trusted: truncated/corrupt/version-skewed.

    Subclasses ``TornResultError`` deliberately — the router's failover
    wrapper already treats a torn reply as a worker failure, and a frame
    that fails CRC or framing IS a torn reply at a lower layer.  The one
    outcome this type exists to rule out is a garbage merge.
    """


class WorkerCrashedError(RuntimeError):
    """The worker's connection died (EOF / broken pipe / reset)."""


class WorkerTimeoutError(RuntimeError):
    """The worker did not answer within the socket deadline."""


class BackpressureError(RuntimeError):
    """A bounded queue is full (a worker's in-flight requests, or the
    lifecycle's delta budget): the caller sheds, fails over or retries."""


class RemoteWorkerError(RuntimeError):
    """A worker-side exception of a type this process cannot reconstruct."""

    def __init__(self, message: str, *, remote_type: str = ""):
        super().__init__(message)
        self.remote_type = str(remote_type)


def _wire_dtype(name: str) -> np.dtype:
    if name not in _WIRE_DTYPES:
        raise WireError(f"dtype {name!r} not admitted on the wire "
                        f"(allowed: {_WIRE_DTYPES})")
    if name == "bfloat16":
        return _BF16_WORDS
    return np.dtype(name)


def _dtype_name(dt: np.dtype) -> str:
    name = "bfloat16" if dt == _BF16_WORDS else dt.name
    if name not in _WIRE_DTYPES:
        raise WireError(f"refusing to send dtype {name!r} "
                        f"(allowed: {_WIRE_DTYPES})")
    return name


# -- framing -----------------------------------------------------------------


def pack_frame(ftype: int, meta: Mapping | None = None,
               arrays: Mapping[str, np.ndarray] | None = None) -> bytes:
    """Serialize one frame: header + (meta json | array blobs) payload."""
    if ftype not in FRAME_TYPES:
        raise WireError(f"unknown frame type {ftype}")
    meta = dict(meta or {})
    arrays = dict(arrays or {})
    specs, blobs = [], []
    for name, arr in arrays.items():
        a = np.ascontiguousarray(arr)
        specs.append({"name": str(name), "dtype": _dtype_name(a.dtype),
                      "shape": list(a.shape)})
        blobs.append(a.tobytes())
    meta["arrays"] = specs
    meta_b = json.dumps(meta, separators=(",", ":")).encode()
    payload = b"".join([struct.pack("<I", len(meta_b)), meta_b, *blobs])
    crc = zlib.crc32(payload, zlib.crc32(
        _CRC_PREFIX.pack(WIRE_MAGIC, WIRE_VERSION, ftype)))
    return _HEADER.pack(WIRE_MAGIC, WIRE_VERSION, ftype, len(payload),
                        crc) + payload


def unpack_frame(data: bytes) -> tuple[int, dict, dict, int]:
    """Parse one frame from ``data``; returns (type, meta, arrays, consumed).

    Every malformation raises ``WireError`` — the fuzz suite's contract is
    that NO byte corruption yields anything but this exception or the
    original message back.
    """
    if len(data) < HEADER_BYTES:
        raise WireError(f"truncated frame header: {len(data)} bytes "
                        f"< {HEADER_BYTES}")
    magic, version, ftype, nbytes, crc = _HEADER.unpack_from(data, 0)
    if magic != WIRE_MAGIC:
        raise WireError(f"bad frame magic {magic!r}")
    if version != WIRE_VERSION:
        raise WireError(f"wire version {version} != supported {WIRE_VERSION} "
                        f"(no silent cross-version read)")
    payload = data[HEADER_BYTES : HEADER_BYTES + nbytes]
    if len(payload) != nbytes:
        raise WireError(f"truncated frame payload: {len(payload)} of "
                        f"{nbytes} bytes")
    if zlib.crc32(payload, zlib.crc32(
            _CRC_PREFIX.pack(WIRE_MAGIC, WIRE_VERSION, ftype))) != crc:
        raise WireError("frame payload CRC mismatch")
    if ftype not in FRAME_TYPES:
        raise WireError(f"unknown frame type {ftype}")
    if len(payload) < 4:
        raise WireError("frame payload too short for meta length")
    (meta_len,) = struct.unpack_from("<I", payload, 0)
    meta_b = payload[4 : 4 + meta_len]
    if len(meta_b) != meta_len:
        raise WireError(f"truncated frame meta: {len(meta_b)} of "
                        f"{meta_len} bytes")
    try:
        meta = json.loads(meta_b.decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise WireError(f"frame meta is not valid JSON: {e}") from e
    if not isinstance(meta, dict) or not isinstance(meta.get("arrays"), list):
        raise WireError("frame meta missing its arrays manifest")
    pos = 4 + meta_len
    arrays: dict[str, np.ndarray] = {}
    for spec in meta.pop("arrays"):
        try:
            name, shape = spec["name"], tuple(int(s) for s in spec["shape"])
            dt = _wire_dtype(spec["dtype"])
        except (TypeError, KeyError, ValueError) as e:
            raise WireError(f"malformed array spec {spec!r}: {e}") from e
        if any(s < 0 for s in shape):
            raise WireError(f"negative array dim in {spec!r}")
        count = int(np.prod(shape, dtype=np.int64)) if shape else 1
        nb = count * dt.itemsize
        blob = payload[pos : pos + nb]
        if len(blob) != nb:
            raise WireError(f"array {name!r} truncated: {len(blob)} of "
                            f"{nb} bytes")
        arrays[name] = np.frombuffer(blob, dtype=dt).reshape(shape)
        pos += nb
    if pos != len(payload):
        raise WireError(f"{len(payload) - pos} trailing bytes after the "
                        f"declared arrays")
    return ftype, meta, arrays, HEADER_BYTES + nbytes


def frame_overhead_bytes(meta: Mapping | None = None,
                         n_arrays: int = 0) -> int:
    """Modeled non-blob bytes of a frame (header + meta) — accounting's
    view of the RPC hop; ~tens of bytes per array spec."""
    meta = dict(meta or {})
    meta["arrays"] = [{"name": "x" * 4, "dtype": "float32",
                       "shape": [0, 0]}] * n_arrays
    return HEADER_BYTES + 4 + len(json.dumps(meta, separators=(",", ":")))


# -- socket transport --------------------------------------------------------


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks, got = [], 0
    while got < n:
        try:
            chunk = sock.recv(n - got)
        except socket.timeout as e:
            raise WorkerTimeoutError(
                f"worker did not answer within {sock.gettimeout()}s") from e
        except OSError as e:
            raise WorkerCrashedError(f"worker connection error: {e}") from e
        if not chunk:
            raise WorkerCrashedError(
                f"worker connection closed mid-frame ({got}/{n} bytes)")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def send_frame(sock: socket.socket, ftype: int, meta: Mapping | None = None,
               arrays: Mapping[str, np.ndarray] | None = None) -> None:
    try:
        sock.sendall(pack_frame(ftype, meta, arrays))
    except socket.timeout as e:
        raise WorkerTimeoutError(f"send timed out: {e}") from e
    except OSError as e:
        raise WorkerCrashedError(f"worker connection broken on send: {e}") \
            from e


def recv_frame(sock: socket.socket) -> tuple[int, dict, dict]:
    """Read exactly one frame off ``sock`` (blocking, honors its timeout).

    The header is read first so a corrupt length can never make the reader
    wait on bytes that will not come: payload reads are bounded by the
    declared length, and every parse failure is a loud ``WireError``.
    """
    head = _recv_exact(sock, HEADER_BYTES)
    magic, version, ftype, nbytes, _crc = _HEADER.unpack_from(head, 0)
    if magic != WIRE_MAGIC:
        raise WireError(f"bad frame magic {magic!r}")
    if version != WIRE_VERSION:
        raise WireError(f"wire version {version} != supported {WIRE_VERSION}")
    payload = _recv_exact(sock, nbytes) if nbytes else b""
    ftype, meta, arrays, _ = unpack_frame(head + payload)
    return ftype, meta, arrays


# -- result wire -------------------------------------------------------------


def bf16_words(values) -> np.ndarray:
    """fp32 values rounded to bf16 (to nearest even) as their 2-byte words,
    rounded where the values lie (on the card for a worker's run), so only
    the words come to the host."""
    t = torch.as_tensor(values).float().to(torch.bfloat16)
    return t.view(torch.int16).cpu().numpy().view(_BF16_WORDS)


def encode_result(vals, ids, *, wire_dtype: str | None = None) -> dict:
    """Wire arrays for a sorted [m, K] run (tensors on any device, or numpy).

    ``wire_dtype="bfloat16"`` ships the value leg in bf16: the rounding
    ``aggregate_topk(wire_dtype="bfloat16")`` applies before its first
    merge round, so the bf16 wire is invisible to the bf16-wire merge.
    Ids always travel as int32.
    """
    if wire_dtype == "bfloat16":
        v = bf16_words(vals)
    else:
        v = torch.as_tensor(vals).cpu().float().numpy().astype(
            np.float32 if wire_dtype is None else _wire_dtype(wire_dtype))
    return {"vals": v, "ids": torch.as_tensor(ids).cpu().to(torch.int32).numpy()}


def decode_result(arrays: Mapping[str, np.ndarray]) \
        -> tuple[np.ndarray, np.ndarray]:
    """(values fp32, ids int32) from a RESULT frame's arrays."""
    if "vals" not in arrays or "ids" not in arrays:
        raise WireError(f"RESULT frame missing runs: has {sorted(arrays)}")
    vals = np.asarray(arrays["vals"])
    if vals.dtype == _BF16_WORDS:
        vals = torch.from_numpy(vals.view(np.int16).copy()).view(torch.bfloat16).float().numpy()
    vals = vals.astype(np.float32)
    ids = np.asarray(arrays["ids"])
    if not np.issubdtype(ids.dtype, np.integer):
        raise WireError(f"RESULT ids dtype {ids.dtype} is not integral")
    return vals, ids.astype(np.int32)


# -- error wire --------------------------------------------------------------

# Reconstructable-by-name registry.  MissingShardError's subclass carries the
# same (cells, shard_ids, attempts) context; plain RuntimeErrors rebuild from
# their message alone.
_CONTEXT_ERRORS = {
    "MissingShardError": MissingShardError,
    "ShardUnavailableError": ShardUnavailableError,
}
_PLAIN_ERRORS = {
    "TornResultError": TornResultError,
    "WireError": WireError,
    "SnapshotError": SnapshotError,
    "WorkerCrashedError": WorkerCrashedError,
    "WorkerTimeoutError": WorkerTimeoutError,
    "BackpressureError": BackpressureError,
}


def encode_error(exc: BaseException) -> dict:
    """JSON-able structure for a worker-side exception, context and all."""
    out: dict = {"type": type(exc).__name__, "message": str(exc)}
    if isinstance(exc, MissingShardError):
        out["cells"] = [int(c) for c in exc.cells]
        out["shard_ids"] = [int(s) for s in exc.shard_ids]
        out["attempts"] = [[a.worker, float(a.seconds), a.error]
                           for a in exc.attempts]
    return out


def decode_error(payload: Mapping) -> Exception:
    """Rebuild the typed exception an ERROR frame carries.

    Registered types come back as themselves — ``MissingShardError`` and
    its subclass with their cells/shard_ids/attempts intact (the attempts
    as real ``health.Attempt`` records).  Anything else degrades to
    ``RemoteWorkerError`` tagged with the original type name, so even an
    unknown failure stays diagnosable without being misclassified.
    """
    name = str(payload.get("type", ""))
    message = str(payload.get("message", ""))
    if name in _CONTEXT_ERRORS:
        attempts = tuple(
            Attempt(str(w), float(s), None if e is None else str(e))
            for w, s, e in payload.get("attempts", ()))
        return _CONTEXT_ERRORS[name](
            message, cells=payload.get("cells", ()),
            shard_ids=payload.get("shard_ids", ()), attempts=attempts)
    if name in _PLAIN_ERRORS:
        return _PLAIN_ERRORS[name](message)
    return RemoteWorkerError(f"{name}: {message}", remote_type=name)


def roundtrip_error(exc: BaseException) -> Exception:
    """encode → decode in one step (the serialization tests' pivot)."""
    return decode_error(encode_error(exc))


def attempts_from_wire(raw: Sequence) -> tuple[Attempt, ...]:
    """Decode a wire-format attempts list back into ``Attempt`` records."""
    return tuple(Attempt(str(w), float(s), None if e is None else str(e))
                 for w, s, e in raw)
