"""The port's RPC wire and worker supervisor (``repro_torch.serving.transport``
and ``supervisor``) against the JAX package's.

The reference runs once, in the module-scoped fixture ``R``: it packs one
frame of every type (the RESULT frame with an fp32 and a bf16 value leg,
its bf16 through ``ml_dtypes``), decodes the port's structured errors, and,
as a parent, sends a QUERY over a ``socketpair`` into the port's worker loop
(``_serve_loop`` on a port ``ShardWorker``) and decodes the RESULT with its
own ``recv_frame``/``decode_result``; then a DRAIN, answered by BYE.  The
port must write the same bytes (its bf16 leg rounded through
``torch.bfloat16``, without ``ml_dtypes``), read the reference's frames, and
answer it.

Then the port's own contract, as ``tests/test_transport.py`` pins the
reference's: every malformation and every byte corruption raises
``WireError``; errors keep their structure; and ONE proc fleet of port
workers on the CPU (``--device cpu``, 2 shards x 2 replicas, spawned once
for the module with ``OMP_NUM_THREADS=1`` in the workers' environment) is
bit-identical to the in-process fleet on the fp32 and the bf16 wire,
survives a SIGKILL of one replica of every shard mid-batch (the corpses
respawn into probation and then serve), abandons a slow reply at the
socket deadline and discards it by seq, respawns a SIGSTOPped worker by
heartbeat, and drains: every worker exits 0 and no process is left.  A
broken image's restore failure, and a worker asked for CUDA where there is
none, come back as typed errors through the HELLO path.
"""
import dataclasses
import json
import os
import shutil
import signal
import socket
import struct
import threading
import time
import zlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.accounting import rpc_bytes_per_batch
from repro_torch.core.topk import next_pow2
from repro_torch.serving import (
    BackpressureError,
    CallPolicy,
    FaultPolicy,
    FaultyWorker,
    HealthState,
    HealthTracker,
    QueryFilter,
    RemoteWorkerError,
    RetrievalIndex,
    ShardRouter,
    ShardUnavailableError,
    SnapshotError,
    SupervisorConfig,
    TornResultError,
    WireError,
    WorkerCrashedError,
    WorkerTimeoutError,
    aggregate_topk,
    load_fleet,
    restore_shard,
    run_with_failover,
    save_shards,
    validate_run,
)
from repro_torch.serving import transport as T
from repro_torch.serving.health import Attempt
from repro_torch.serving.shards import MissingShardError
from repro_torch.serving.snapshot import shard_dirs
from repro_torch.serving.supervisor import _serve_loop

N, D, K, NCELLS, NSHARDS = 1024, 16, 10, 8, 2
CFG = dict(ivf_cells=NCELLS, nprobe=4, overfetch=8)
CPU = dict(device="cpu")


def _frame_cases():
    """(name, type, meta, arrays) of one frame of every type; RESULT twice."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((4, D)).astype(np.float32)
    vals = np.sort(rng.standard_normal((4, 16)).astype(np.float32), axis=-1)
    vals[:, -2:] = np.inf
    ids = rng.integers(0, N, (4, 16)).astype(np.int32)
    ids[:, -2:] = -1
    error = {"type": "ShardUnavailableError", "message": "shard 1 down", "cells": [3, 4],
             "shard_ids": [1], "attempts": [["s1r0", 0.5, "WorkerCrashedError: x"],
                                            ["s1r1", 0.25, None]]}
    hello = {"key": "s0r1", "pid": 123, "shard_id": 0, "replica": 1, "cell_lo": 0,
             "cell_hi": 4, "dim": D, "n_live": 512, "n_slots": 1024}
    return [
        ("hello", T.F_HELLO, hello, None),
        ("query", T.F_QUERY, {"seq": 7, "k": K, "nprobe": 4, "overfetch": 8,
                              "wire": "bfloat16"}, {"q": q}),
        ("result_fp32", T.F_RESULT, {"seq": 7}, ("fp32", vals, ids)),
        ("result_bf16", T.F_RESULT, {"seq": 7}, ("bfloat16", vals, ids)),
        ("error", T.F_ERROR, {"seq": 7, "error": error}, None),
        ("ping", T.F_PING, {"seq": 8}, None),
        ("pong", T.F_PONG, {"seq": 8}, None),
        ("drain", T.F_DRAIN, {}, None),
        ("bye", T.F_BYE, {}, None),
        ("mixed", T.F_QUERY, {"seq": 1, "note": "héllo"},
         {"a": np.arange(6, dtype=np.int64).reshape(2, 3), "b": np.array([True, False]),
          "c": np.array(3, np.uint8), "d": np.zeros((0, 2), np.float64),
          "e": np.arange(4, dtype=np.int8)}),
    ]


def _pack(module, ftype, meta, arrays):
    if isinstance(arrays, tuple):
        wire, vals, ids = arrays
        arrays = module.encode_result(vals, ids, wire_dtype=None if wire == "fp32" else wire)
    return module.pack_frame(ftype, meta, arrays)


def _port_errors():
    attempts = (Attempt("s1r0", 0.012, "WorkerCrashedError: down"), Attempt("s1r1", 0.034, None))
    return [
        ShardUnavailableError("every replica of shard 1 failed", cells=(3, 4), shard_ids=(1,),
                              attempts=attempts),
        MissingShardError("cells owned by no loaded shard", cells=(7,)),
        TornResultError("torn"), WireError("crc"), SnapshotError("corrupt"),
        WorkerCrashedError("gone"), WorkerTimeoutError("slow"), BackpressureError("full"),
        ValueError("k must be positive"),
    ]


def _described(e):
    return (type(e).__name__, str(e), tuple(getattr(e, "cells", ())),
            tuple(getattr(e, "shard_ids", ())),
            tuple(tuple(a) for a in getattr(e, "attempts", ())),
            getattr(e, "remote_type", None))


def _index_and_root(base):
    rng = np.random.default_rng(5)
    centers = rng.standard_normal((NCELLS, D)).astype(np.float32) * 4
    vecs = centers[rng.integers(0, NCELLS, N)] + rng.standard_normal((N, D)).astype(np.float32)
    q = (centers[rng.integers(0, NCELLS, 24)] + rng.standard_normal((24, D))).astype(np.float32)
    idx = RetrievalIndex.build(np.arange(N), vecs, **CPU, **CFG)
    root = str(base / "fleet")
    save_shards(idx, root, NSHARDS, replicas=2)
    return q, root


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    base = tmp_path_factory.mktemp("torch_rpc")
    q, root = _index_and_root(base)
    base_res = load_fleet(root, replicas=1, **CPU).search(q, K)
    return SimpleNamespace(base=base, q=q, root=root, inproc=base_res)


@pytest.fixture(scope="module")
def R(images):
    """The reference's side, run once: its frames, its reading of the port's
    errors, and its exchange with a port worker over a socketpair."""
    from repro.serving import transport as RT

    out = {"frames": {name: _pack(RT, ftype, meta, arrays)
                      for name, ftype, meta, arrays in _frame_cases()}}
    out["errors"] = [_described(RT.decode_error(T.encode_error(e))) for e in _port_errors()]
    # The reference's own payloads of the registered types (an unknown type
    # arrives as RemoteWorkerError and is re-sent as that).
    out["error_payloads"] = [RT.encode_error(RT.decode_error(T.encode_error(e)))
                             for e in _port_errors()[:-1]]
    from repro.accounting import rpc_bytes_per_batch as rrpc

    out["rpc"] = [rrpc(m, d, k=k, shards_dispatched=s, wire_bytes_per_value=w)
                  for m, d, k, s, w in [(64, 128, 10, 3.0, 4), (1024, 256, 10, 4.0, 2),
                                        (1, 16, 100, 1.0, 4)]]
    # A reference parent and a port worker: QUERY on the fp32 and bf16 wires,
    # a QUERY without its q array, a PING, then DRAIN.
    worker = restore_shard(shard_dirs(images.root)[0], **CPU)
    parent, child = socket.socketpair()
    rc = {}
    loop = threading.Thread(target=lambda: rc.setdefault("rc", _serve_loop(child, worker)))
    loop.start()
    try:
        replies = []
        RT.send_frame(parent, RT.F_QUERY, {"seq": 1, "k": K}, {"q": images.q})
        replies.append(RT.recv_frame(parent))
        RT.send_frame(parent, RT.F_QUERY, {"seq": 2, "k": K, "wire": "bfloat16"},
                      {"q": images.q})
        replies.append(RT.recv_frame(parent))
        RT.send_frame(parent, RT.F_QUERY, {"seq": 3, "k": K})
        replies.append(RT.recv_frame(parent))
        RT.send_frame(parent, RT.F_PING, {"seq": 4})
        replies.append(RT.recv_frame(parent))
        RT.send_frame(parent, RT.F_DRAIN, {})
        replies.append(RT.recv_frame(parent))
    finally:
        loop.join(timeout=60)
        parent.close()
        child.close()
    out["exchange"] = {
        "types": [r[0] for r in replies], "seqs": [r[1].get("seq") for r in replies[:4]],
        "fp32": RT.decode_result(replies[0][2]),
        "bf16": tuple(np.asarray(a) for a in RT.decode_result(replies[1][2])),
        "bf16_dtype": replies[1][2]["vals"].dtype.name,
        "error": _described(RT.decode_error(replies[2][1]["error"])), "rc": rc.get("rc")}
    out["worker"] = worker
    return out


# -- the reference's bytes -------------------------------------------------------


@pytest.mark.parametrize("case", [c[0] for c in _frame_cases()])
def test_every_frame_is_the_references_bytes(R, case):
    name, ftype, meta, arrays = next(c for c in _frame_cases() if c[0] == case)
    buf = _pack(T, ftype, meta, arrays)
    assert buf == R["frames"][name]
    # Each package reads the other's frame back as the message it was.
    got_type, got_meta, got_arrays, consumed = T.unpack_frame(R["frames"][name])
    assert got_type == ftype and consumed == len(buf) and got_meta == meta
    if isinstance(arrays, tuple):
        wire, vals, ids = arrays
        v, i = T.decode_result(got_arrays)
        np.testing.assert_array_equal(i, ids)
        want = vals if wire == "fp32" else \
            torch.from_numpy(vals).to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(v, want)
    elif arrays is not None:
        for key, a in arrays.items():
            np.testing.assert_array_equal(got_arrays[key], a)
            assert got_arrays[key].dtype == a.dtype


def test_bf16_words_round_to_nearest_even_as_ml_dtypes():
    import ml_dtypes

    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(4096).astype(np.float32) * 1e3,
                        np.array([np.inf, -np.inf, 0.0, -0.0, 1.00390625, 1.01171875,
                                  3.0e38, 1e-40], np.float32)])
    want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    assert (T.bf16_words(x).view(np.uint16) == want).all()


def test_errors_cross_the_packages(R):
    """The port's structured errors decode in the reference as themselves,
    with cells, shard ids and Attempts; the reference's decode in the port."""
    assert R["errors"] == [_described(T.decode_error(T.encode_error(e)))
                           for e in _port_errors()]
    for e, payload in zip(_port_errors()[:-1], R["error_payloads"], strict=True):
        back = T.decode_error(payload)
        assert _described(back) == _described(T.roundtrip_error(e))
    r = T.roundtrip_error(_port_errors()[0])
    assert type(r) is ShardUnavailableError and isinstance(r, MissingShardError)
    assert r.cells == (3, 4) and r.shard_ids == (1,)
    assert all(isinstance(a, Attempt) for a in r.attempts) and r.attempts[1].error is None
    unknown = T.roundtrip_error(ValueError("k must be positive"))
    assert type(unknown) is RemoteWorkerError and unknown.remote_type == "ValueError"


def test_a_port_worker_answers_a_reference_parent(R, images):
    ex = R["exchange"]
    assert ex["types"] == [T.F_RESULT, T.F_RESULT, T.F_ERROR, T.F_PONG, T.F_BYE]
    assert ex["seqs"] == [1, 2, 3, 4] and ex["rc"] == 0
    want = R["worker"].topk(images.q, K)
    np.testing.assert_array_equal(ex["fp32"][0], want.distances.numpy())
    np.testing.assert_array_equal(ex["fp32"][1], want.indices.numpy())
    assert ex["bf16_dtype"] == "bfloat16"
    np.testing.assert_array_equal(
        ex["bf16"][0], want.distances.to(torch.bfloat16).float().numpy())
    np.testing.assert_array_equal(ex["bf16"][1], want.indices.numpy())
    assert ex["error"][0] == "WireError" and "q array" in ex["error"][1]


def test_rpc_bytes_model_equals_the_reference(R):
    got = [rpc_bytes_per_batch(m, d, k=k, shards_dispatched=s, wire_bytes_per_value=w)
           for m, d, k, s, w in [(64, 128, 10, 3.0, 4), (1024, 256, 10, 4.0, 2),
                                 (1, 16, 100, 1.0, 4)]]
    assert got == R["rpc"]
    m = got[0]
    assert m["request"] > 64 * 128 * 4 and m["reply"] < m["request"]


# -- framing --------------------------------------------------------------------


def test_pack_refuses_bad_inputs():
    with pytest.raises(WireError, match="unknown frame type"):
        T.pack_frame(99)
    with pytest.raises(WireError, match="refusing to send"):
        T.pack_frame(T.F_RESULT, {}, {"v": np.zeros(2, np.float16)})


def _craft(ftype: int, payload: bytes) -> bytes:
    crc = zlib.crc32(payload, zlib.crc32(struct.pack("<4sHH", T.WIRE_MAGIC, T.WIRE_VERSION,
                                                     ftype)))
    return T._HEADER.pack(T.WIRE_MAGIC, T.WIRE_VERSION, ftype, len(payload), crc) + payload


def test_unpack_rejects_each_malformation():
    frame = T.pack_frame(T.F_RESULT, {"seq": 1}, {"v": np.arange(8, dtype=np.float32)})
    with pytest.raises(WireError, match="truncated frame header"):
        T.unpack_frame(frame[: T.HEADER_BYTES - 1])
    with pytest.raises(WireError, match="bad frame magic"):
        T.unpack_frame(b"XXXX" + frame[4:])
    with pytest.raises(WireError, match="wire version"):
        T.unpack_frame(T._HEADER.pack(T.WIRE_MAGIC, T.WIRE_VERSION + 1, T.F_RESULT, 0, 0))
    with pytest.raises(WireError, match="truncated frame payload"):
        T.unpack_frame(frame[:-3])
    flip = bytearray(frame)
    flip[-1] ^= 0xFF
    with pytest.raises(WireError, match="CRC mismatch"):
        T.unpack_frame(bytes(flip))
    with pytest.raises(WireError, match="unknown frame type"):
        T.unpack_frame(_craft(77, frame[T.HEADER_BYTES:]))
    relabel = bytearray(frame)
    relabel[6] ^= 1
    with pytest.raises(WireError, match="CRC mismatch"):
        T.unpack_frame(bytes(relabel))

    def crafted(payload: bytes) -> bytes:
        return _craft(T.F_RESULT, payload)

    with pytest.raises(WireError, match="not valid JSON"):
        T.unpack_frame(crafted(struct.pack("<I", 8) + b"not json"))
    with pytest.raises(WireError, match="arrays manifest"):
        T.unpack_frame(crafted(struct.pack("<I", 2) + b"{}"))
    for spec, match in [({"dtype": "object", "shape": [1]}, "not admitted"),
                        ({"dtype": "float32", "shape": [-1]}, "negative array dim"),
                        ({"dtype": "float32"}, "malformed array spec")]:
        meta = json.dumps({"arrays": [{"name": "v", **spec}]}).encode()
        with pytest.raises(WireError, match=match):
            T.unpack_frame(crafted(struct.pack("<I", len(meta)) + meta))
    meta = json.dumps({"arrays": [{"name": "v", "dtype": "float32", "shape": [4]}]}).encode()
    with pytest.raises(WireError, match="truncated"):
        T.unpack_frame(crafted(struct.pack("<I", len(meta)) + meta + b"\0" * 8))
    with pytest.raises(WireError, match="trailing bytes"):
        T.unpack_frame(crafted(struct.pack("<I", len(meta)) + meta + b"\0" * 24))


@pytest.mark.parametrize("wire", [None, "bfloat16"])
def test_fuzz_byte_corruption_never_parses_wrong(wire):
    frame = T.pack_frame(T.F_RESULT, {"seq": 7, "k": 10}, T.encode_result(
        np.linspace(0, 1, 24, dtype=np.float32).reshape(3, 8),
        np.arange(24, dtype=np.int32).reshape(3, 8), wire_dtype=wire))
    want = T.unpack_frame(frame)
    rng = np.random.default_rng(1234)
    for _ in range(300):
        buf = bytearray(frame)
        pos = int(rng.integers(len(buf)))
        buf[pos] ^= int(rng.integers(1, 256))
        try:
            got = T.unpack_frame(bytes(buf))
        except WireError:
            continue
        assert got[0] == want[0] and got[1] == want[1], pos
        for name in want[2]:
            assert got[2][name].tobytes() == want[2][name].tobytes()
    for _ in range(100):
        with pytest.raises(WireError):
            T.unpack_frame(frame[: int(rng.integers(len(frame)))])


def test_wire_error_fails_over_like_torn_result():
    assert issubclass(WireError, TornResultError)

    def corrupt():
        raise WireError("frame payload CRC mismatch")

    tracker = HealthTracker()
    out, attempts = run_with_failover([("bad", corrupt), ("good", lambda: "served")],
                                      policy=CallPolicy(), tracker=tracker)
    assert out == "served" and "CRC" in attempts[0].error
    assert tracker.state("bad") is HealthState.DEGRADED


def test_frame_overhead_model_tracks_framing():
    base = T.frame_overhead_bytes({"seq": 1}, n_arrays=0)
    assert base > T.HEADER_BYTES
    assert T.frame_overhead_bytes({"seq": 1}, n_arrays=2) > \
        T.frame_overhead_bytes({"seq": 1}, n_arrays=1) > base


def test_result_wire_fp32_is_bit_exact_and_bf16_idempotent_with_the_merge():
    rng = np.random.default_rng(11)
    S, m, Kp = 3, 4, next_pow2(K)
    vals = np.sort(rng.random((S, m, Kp)).astype(np.float32), axis=-1)
    ids = rng.integers(0, N, size=(S, m, Kp)).astype(np.int64)
    _, _, arrays, _ = T.unpack_frame(T.pack_frame(T.F_RESULT, {}, T.encode_result(vals[0],
                                                                                  ids[0])))
    v, i = T.decode_result(arrays)
    np.testing.assert_array_equal(v, vals[0])
    np.testing.assert_array_equal(i, ids[0].astype(np.int32))
    assert v.dtype == np.float32 and i.dtype == np.int32
    want = aggregate_topk(torch.from_numpy(vals), torch.from_numpy(ids), K,
                          wire_dtype="bfloat16")
    shipped = []
    for s in range(S):
        _, _, arrays, _ = T.unpack_frame(T.pack_frame(
            T.F_RESULT, {}, T.encode_result(vals[s], ids[s], wire_dtype="bfloat16")))
        shipped.append(T.decode_result(arrays)[0])
    got = aggregate_topk(torch.from_numpy(np.stack(shipped)), torch.from_numpy(ids), K,
                         wire_dtype="bfloat16")
    assert torch.equal(want.distances, got.distances)
    assert torch.equal(want.indices, got.indices)


def test_decode_result_validates():
    with pytest.raises(WireError, match="missing runs"):
        T.decode_result({"vals": np.zeros((1, 2), np.float32)})
    with pytest.raises(WireError, match="not integral"):
        T.decode_result({"vals": np.zeros((1, 2), np.float32),
                         "ids": np.zeros((1, 2), np.float32)})


def test_attempts_from_wire():
    assert T.attempts_from_wire([["w0", 0.5, "err"], ["w1", 1, None]]) == \
        (Attempt("w0", 0.5, "err"), Attempt("w1", 1.0, None))


# -- one proc fleet of port workers on the CPU -----------------------------------


@pytest.fixture(scope="module")
def proc(images):
    """2 shards x 2 replicas of port workers with ``--device cpu``, spawned
    once; one thread each (four workers beside the test run's own)."""
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        router = load_fleet(images.root, workers="proc", replicas=2, degraded="partial",
                            call_policy=CallPolicy(deadline_s=60.0),
                            supervisor_cfg=SupervisorConfig(heartbeat_s=60.0), **CPU)
    finally:
        if old is None:
            os.environ.pop("OMP_NUM_THREADS")
        else:
            os.environ["OMP_NUM_THREADS"] = old
    sup = router.supervisor
    procs = [w._proc for w in sup.workers]
    yield SimpleNamespace(router=router, sup=sup, first_procs=procs)
    sup.shutdown(drain=False)


def _assert_bit_identical(a, b):
    assert torch.equal(a.ids, b.ids)
    assert torch.equal(a.distances, b.distances)


def test_proc_fleet_is_bit_identical_to_the_inproc_fleet(proc, images):
    sup = proc.sup
    assert sup.timeout_s == 60.0 and all(w._sock.gettimeout() == 60.0 for w in sup.workers)
    assert {w.key for w in sup.workers} == {f"s{s}r{r}" for s in range(NSHARDS)
                                            for r in range(2)}
    assert all(w.alive and w.pid is not None and w.device.type == "cpu" for w in sup.workers)
    assert sum(w.n_live for w in sup.workers) == 2 * N and all(w.dim == D for w in sup.workers)
    got = proc.router.search(images.q, K)
    _assert_bit_identical(images.inproc, got)
    assert np.all(got.coverage == 1.0)
    with pytest.raises(NotImplementedError, match="allow-list"):
        proc.router.search(images.q, K, filter=QueryFilter(allowed_ids=[1, 2, 3]))
    # A QUERY without its q array: a typed ERROR with our seq; the worker lives.
    w = sup.workers[0]
    w._seq += 1
    T.send_frame(w._sock, T.F_QUERY, {"seq": w._seq, "k": K})
    ftype, meta, _ = T.recv_frame(w._sock)
    assert ftype == T.F_ERROR and meta["seq"] == w._seq
    err = T.decode_error(meta["error"])
    assert type(err) is WireError and "q array" in str(err)
    _assert_bit_identical(images.inproc, proc.router.search(images.q, K))


def test_proc_bf16_wire_matches_the_inproc_bf16_merge(proc, images):
    inproc = load_fleet(images.root, replicas=1, wire_dtype="bfloat16", **CPU)
    want = inproc.search(images.q, K)
    sup = proc.sup
    try:
        for w in sup.workers:
            w.wire_dtype = "bfloat16"
        router = ShardRouter(sup.workers, wire_dtype="bfloat16")
        _assert_bit_identical(want, router.search(images.q, K))
    finally:
        for w in sup.workers:
            w.wire_dtype = None


def test_sigkill_one_replica_of_every_shard_mid_batch(proc, images):
    sup, base = proc.sup, images.inproc
    kill0 = {f"s{s}r0" for s in range(NSHARDS)}
    kill1 = {f"s{s}r1" for s in range(NSHARDS)}
    pids = {w.key: w.pid for w in sup.workers}
    respawns = sup.respawns
    wrapped = [FaultyWorker(w, FaultPolicy.kill_at(0)) if w.key in kill0
               else FaultyWorker(w, FaultPolicy.kill_at(2)) for w in sup.workers]
    router = ShardRouter(wrapped, degraded="partial", call_policy=CallPolicy(), supervisor=sup)
    got = router.search(images.q, K)  # replica 0 of each shard dies mid-batch
    _assert_bit_identical(base, got)
    assert np.all(got.coverage == 1.0) and all(s == "ok" for _, s in got.shard_status)
    assert all(router.health.state(k) is HealthState.DEGRADED for k in kill0)
    assert all(not w.alive for w in sup.workers if w.key in kill0)
    _assert_bit_identical(base, router.search(images.q, K))  # poll respawns them
    assert sup.respawns == respawns + NSHARDS
    assert all(router.health.state(k) is HealthState.PROBATION for k in kill0)
    for w in sup.workers:
        if w.key in kill0:
            assert w.alive and w.pid != pids[w.key]
    got = router.search(images.q, K)  # the survivors die: the respawned serve
    _assert_bit_identical(base, got)
    assert np.all(got.coverage == 1.0)
    assert all(router.health.state(k) is HealthState.HEALTHY for k in kill0)
    assert all(router.health.state(k) is HealthState.DEGRADED for k in kill1)
    _assert_bit_identical(base, router.search(images.q, K))
    assert sup.respawns == respawns + 2 * NSHARDS
    assert all(w.alive and w.pid != pids[w.key] for w in sup.workers)
    assert all(f.faults_injected == 1 for f in wrapped)
    # Every replaced process is gone, not a zombie.
    assert all(p.poll() is not None for p in proc.first_procs)


def test_deadline_abandons_a_slow_reply_then_discards_it_stale(proc, images):
    w = next(x for x in proc.sup.workers if x.key == "s0r0")
    warm = w.topk(images.q, K)
    validate_run(warm, len(images.q), next_pow2(K))
    w.test_delay_s = 0.6
    w._sock.settimeout(0.15)
    with pytest.raises(WorkerTimeoutError):
        w.topk(images.q, K)
    assert w.alive and w._pending == 1
    w.queue_depth = 1
    with pytest.raises(BackpressureError):
        w.topk(images.q, K)
    w.queue_depth = proc.sup.cfg.queue_depth
    w.test_delay_s = 0.0
    w._sock.settimeout(30.0)
    got = w.topk(images.q, K)
    assert torch.equal(got.distances, warm.distances) and torch.equal(got.indices, warm.indices)
    assert w._pending == 0
    w.ping()
    w._sock.settimeout(proc.sup.timeout_s)


def test_heartbeat_detects_a_wedged_worker_and_respawns(proc, images):
    sup = proc.sup
    cfg = sup.cfg
    sup.cfg = dataclasses.replace(cfg, heartbeat_s=0.05, heartbeat_timeout_s=0.3)
    try:
        w = next(x for x in sup.workers if x.key == "s1r1")
        old_pid, n = w.pid, w.respawns
        os.kill(w.pid, signal.SIGSTOP)
        assert w.alive
        with pytest.raises(WorkerTimeoutError):
            w.ping(timeout_s=0.2)
        time.sleep(0.06)
        tracker = HealthTracker()
        assert "s1r1" in sup.poll(tracker)
        assert tracker.state("s1r1") is HealthState.PROBATION
        assert w.alive and w.pid != old_pid and w.respawns == n + 1
        validate_run(w.topk(images.q, K), len(images.q), next_pow2(K))
    finally:
        sup.cfg = cfg


def test_restore_failure_ships_as_a_typed_error(images, tmp_path):
    root = str(tmp_path / "corrupt")
    shutil.copytree(images.root, root)
    mpath = os.path.join(root, "shard-000", "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    manifest["files"]["shard.npz"]["crc32"] ^= 1
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(SnapshotError, match="corrupted/truncated"):
        load_fleet(root, workers="proc", replicas=1, **CPU)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present: the worker would serve")
def test_a_worker_asked_for_cuda_without_a_card_raises_through_hello(images):
    """``worker_main --device cuda`` on a machine without a card: its first
    frame is the typed ERROR of the HELLO path, and it exits 1."""
    import tempfile

    from repro_torch.serving.supervisor import worker_main

    root = tempfile.mkdtemp(prefix="repro-rpc-")
    path = os.path.join(root, "w.sock")
    listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    listener.bind(path)
    listener.listen(1)
    rc = {}
    t = threading.Thread(target=lambda: rc.setdefault("rc", worker_main(
        ["--shard-dir", shard_dirs(images.root)[0], "--socket", path, "--device", "cuda"])))
    t.start()
    try:
        conn, _ = listener.accept()
        conn.settimeout(60)
        ftype, meta, _ = T.recv_frame(conn)
        conn.close()
    finally:
        t.join(timeout=60)
        listener.close()
        shutil.rmtree(root, ignore_errors=True)
    assert ftype == T.F_ERROR and rc["rc"] == 1
    err = T.decode_error(meta["error"])
    assert type(err) is RemoteWorkerError and "CUDA" in str(err)


def test_load_fleet_rejects_unknown_backend(images):
    with pytest.raises(ValueError, match="workers"):
        load_fleet(images.root, workers="threads", **CPU)


def test_drain_exits_every_worker_and_leaves_no_process(proc, images):
    sup = proc.sup
    _assert_bit_identical(images.inproc, proc.router.search(images.q, K))
    procs = [w._proc for w in sup.workers]
    pids = [p.pid for p in procs]
    sup.shutdown(drain=True)
    assert [p.wait(timeout=10) for p in procs] == [0] * len(procs)
    assert not any(w.alive for w in sup.workers)
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
    with pytest.raises(WorkerCrashedError):
        sup.workers[0].topk(images.q, K)
