"""The port's crash-safe lifecycle (``repro_torch.serving.lifecycle``)
against the JAX package's.

The cases of ``tests/test_lifecycle.py`` on the port, on the CPU, at the
reference tests' sizes (n 512, d 32) or smaller: every ack is durable and
``recover()`` replays every acked record after any crash point (a SIGKILL
mid-append included, the torn in-flight frame dropped); any byte-length
crash prefix of the journal restores exactly the state after the last
acked record; mid-file corruption is refused; a background ``compact()``
hands off an epoch bit-identical to a synchronous compact and first search
on every tier, and the serving thread never enters k-means; a mutation past
``delta_budget`` raises ``BackpressureError`` before anything is applied or
logged.  Across the packages: a WAL the reference wrote, torn at its tail,
recovers in the port with every acked record, and the meter's lifecycle
keys match the reference's.  The kill -9 cases and the launch checks run
the port's ``launch`` modules with ``--device cpu`` in subprocesses.

The case that drives ``serving/service.py``
(``test_service_lifecycle_end_to_end``) waits for the port of the service.
"""
import os
import shutil
import signal
import struct
import subprocess
import sys
import tempfile
import threading
import time

import hypothesis
import hypothesis.strategies as st
import numpy as np
import pytest
import torch

from repro.accounting import ServingMeter as RMeter
from repro.serving import LifecycleConfig as RLifecycleConfig
from repro.serving import LifecycleIndex as RLifecycleIndex
from repro.serving import RetrievalIndex as RIndex
from repro_torch.accounting import ServingMeter
from repro_torch.kernels import _backend as B
from repro_torch.kernels import fused_knn as FK
from repro_torch.serving import (
    BackpressureError,
    EngineConfig,
    LifecycleConfig,
    LifecycleIndex,
    QueryEngine,
    RetrievalIndex,
    SnapshotError,
    WalWriter,
)
from repro_torch.serving.snapshot import _JOURNAL, _JOURNAL_MAGIC_V1, read_manifest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = dict(device="cpu")
CONFIGS = {
    "flat": {},
    "int8": {"scan_dtype": "int8"},
    "bf16": {"scan_dtype": "bfloat16"},
    "ivf": {"ivf_cells": 16, "nprobe": 4},
    "ivfpq": {"ivf_cells": 16, "nprobe": 8, "pq_m": 8},
}


def _base_index(kw, n=512, d=32, seed=0):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    idx = RetrievalIndex.build(np.arange(n), vecs, **kw, **CPU)
    q = rng.standard_normal((16, d)).astype(np.float32)
    return idx, q


def _churn(lc, n=512, d=32, seed=1):
    """Three acked batches: bulk insert, overlapping upsert, delete."""
    rng = np.random.default_rng(seed)
    lc.insert(np.arange(n, n + 32), rng.standard_normal((32, d)).astype(np.float32))
    lc.upsert(np.arange(n + 28, n + 40), rng.standard_normal((12, d)).astype(np.float32))
    lc.delete(np.arange(0, n, 19))


def _recover(snap):
    return LifecycleIndex.recover(LifecycleConfig(snapshot_dir=snap), **CPU)


def _assert_bit_identical(a, b):
    assert torch.equal(a.ids, b.ids)
    assert torch.equal(a.distances, b.distances)


# -- WAL durability round trip ------------------------------------------------


@pytest.mark.parametrize("name", list(CONFIGS))
def test_wal_recover_bit_identical(name, tmp_path):
    idx, q = _base_index(CONFIGS[name])
    snap = str(tmp_path / name)
    lc = LifecycleIndex.attach(idx, LifecycleConfig(snapshot_dir=snap))
    _churn(lc)
    want = lc.search(q, 10)
    want_delta = (int(idx._delta_n), idx._delta_live[: idx._delta_n].copy())
    lc.close()
    lc2, rec = _recover(snap)
    assert rec.wal and rec.torn_bytes == 0
    assert rec.tail_records == 3  # every acked batch survived, none stamped
    got = lc2.index
    assert int(got._delta_n) == want_delta[0]
    np.testing.assert_array_equal(got._delta_live[: got._delta_n], want_delta[1])
    _assert_bit_identical(want, lc2.search(q, 10))
    lc2.close()


def test_vectorized_replay_rebuilds_exact_delta_state(tmp_path):
    idx, q = _base_index(CONFIGS["flat"])
    rng = np.random.default_rng(7)
    idx.upsert(np.arange(512, 512 + 48), rng.standard_normal((48, 32)).astype(np.float32))
    idx.upsert(np.arange(512, 512 + 6), rng.standard_normal((6, 32)).astype(np.float32))
    idx.delete([512 + 2, 512 + 40])
    snap = str(tmp_path / "snap")
    idx.save(snap, wal=True)
    got = RetrievalIndex.restore(snap, **CPU)
    assert int(got._delta_n) == int(idx._delta_n)
    np.testing.assert_array_equal(got._delta_live[: got._delta_n],
                                  idx._delta_live[: idx._delta_n])
    assert got._loc == idx._loc
    _assert_bit_identical(idx.search(q, 10), got.search(q, 10))


# -- torn tail against corruption --------------------------------------------


def test_torn_tail_truncated_and_replay_resumes(tmp_path):
    idx, q = _base_index(CONFIGS["flat"])
    snap = str(tmp_path / "snap")
    lc = LifecycleIndex.attach(idx, LifecycleConfig(snapshot_dir=snap))
    _churn(lc)
    want = lc.search(q, 10)
    lc.close()
    journal = os.path.join(snap, _JOURNAL)
    with open(journal, "ab") as f:  # a header claiming 1 MiB, 40 bytes landed
        f.write(struct.pack("<4sII", b"ADD\0", 1 << 20, 0) + b"\0" * 40)
    lc2, rec = _recover(snap)
    assert rec.torn_bytes == 12 + 40
    assert rec.tail_records == 3
    assert os.path.getsize(journal) == rec.valid_bytes  # physically gone
    _assert_bit_identical(want, lc2.search(q, 10))
    lc2.insert([9000], np.ones((1, 32), np.float32))
    lc2.close()
    lc3, rec3 = _recover(snap)
    assert rec3.torn_bytes == 0 and rec3.tail_records == 4
    assert 9000 in lc3
    lc3.close()


def test_corruption_inside_stamped_prefix_refused(tmp_path):
    idx, _ = _base_index(CONFIGS["flat"])
    rng = np.random.default_rng(2)
    idx.upsert(np.arange(512, 512 + 16), rng.standard_normal((16, 32)).astype(np.float32))
    snap = str(tmp_path / "snap")
    LifecycleIndex.attach(idx, LifecycleConfig(snapshot_dir=snap)).close()
    journal = os.path.join(snap, _JOURNAL)
    stamp = read_manifest(snap, verify=False)["files"][_JOURNAL]["bytes"]
    assert stamp > 32  # the attach image journals the delta rows
    with open(journal, "r+b") as f:
        f.seek(stamp - 5)
        byte = f.read(1)
        f.seek(stamp - 5)
        f.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(SnapshotError):
        _recover(snap)


def test_corruption_mid_tail_refused_not_torn(tmp_path):
    """A CRC-failing tail frame with data after it is damage, not a crash."""
    idx, _ = _base_index(CONFIGS["flat"])
    snap = str(tmp_path / "snap")
    lc = LifecycleIndex.attach(idx, LifecycleConfig(snapshot_dir=snap))
    stamp = lc._wal.tell()
    lc.insert([600], np.ones((1, 32), np.float32))
    end1 = lc._wal.tell()
    lc.insert([601], np.ones((1, 32), np.float32))
    lc.close()
    with open(os.path.join(snap, _JOURNAL), "r+b") as f:
        f.seek(end1 - 3)  # inside frame 1's payload; frame 2 follows
        byte = f.read(1)
        f.seek(end1 - 3)
        f.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(SnapshotError, match="CRC mismatch"):
        _recover(snap)
    assert stamp < end1


def test_journal_shorter_than_stamp_refused(tmp_path):
    idx, _ = _base_index(CONFIGS["flat"])
    snap = str(tmp_path / "snap")
    LifecycleIndex.attach(idx, LifecycleConfig(snapshot_dir=snap)).close()
    stamp = read_manifest(snap, verify=False)["files"][_JOURNAL]["bytes"]
    with open(os.path.join(snap, _JOURNAL), "r+b") as f:
        f.truncate(max(0, stamp - 1))
    with pytest.raises(SnapshotError):
        _recover(snap)


# -- every crash prefix restores the acked prefix -----------------------------

_N_ACKS = 8


def _journaled_history(snap, n=256, d=16):
    """One journaled run: the WAL's frame boundaries and the state after
    each ack (delta rows, search values and ids)."""
    idx, q = _base_index(CONFIGS["flat"], n=n, d=d, seed=3)
    lc = LifecycleIndex.attach(idx, LifecycleConfig(snapshot_dir=snap))
    rng = np.random.default_rng(4)

    def state():
        r = lc.search(q, 8)
        return int(lc.index._delta_n), r.distances.clone(), r.ids.clone()

    boundaries, states, nid = [lc._wal.tell()], [state()], n
    for step in range(_N_ACKS):
        kind = step % 3
        if kind == 0:
            lc.insert(np.arange(nid, nid + 5), rng.standard_normal((5, d)).astype(np.float32))
            nid += 5
        elif kind == 1:
            lc.upsert(np.arange(nid - 3, nid + 2),
                      rng.standard_normal((5, d)).astype(np.float32))
            nid += 2
        else:
            lc.delete(rng.integers(0, n, size=4))
        boundaries.append(lc._wal.tell())
        states.append(state())
    lc.close()
    return q, boundaries, states


@pytest.fixture(scope="module")
def wal_history(tmp_path_factory):
    snap = str(tmp_path_factory.mktemp("walprop") / "snap")
    return (snap, *_journaled_history(snap))


def _recover_cut(snap, cut, q):
    """Recover a copy of ``snap`` with its journal cut at byte ``cut``;
    (recovery stats, delta rows, search result)."""
    work = tempfile.mkdtemp()
    try:
        dst = os.path.join(work, "snap")
        shutil.copytree(snap, dst)
        with open(os.path.join(dst, _JOURNAL), "r+b") as f:
            f.truncate(cut)
        lc, rec = _recover(dst)
        try:
            return rec, int(lc.index._delta_n), lc.search(q, 8)
        finally:
            lc.close()
    finally:
        shutil.rmtree(work, ignore_errors=True)


@hypothesis.settings(max_examples=20, deadline=None)
@hypothesis.given(i=st.integers(0, _N_ACKS), extra=st.integers(0, 1 << 30))
def test_any_crash_prefix_restores_acked_prefix(wal_history, i, extra):
    """A journal cut anywhere in [ack_i, ack_{i+1}) recovers state i."""
    snap, q, boundaries, states = wal_history
    cut = (boundaries[i] if i == _N_ACKS
           else boundaries[i] + extra % (boundaries[i + 1] - boundaries[i]))
    rec, delta_n, got = _recover_cut(snap, cut, q)
    assert rec.tail_records == i
    assert rec.torn_bytes == cut - boundaries[i]
    assert delta_n == states[i][0]
    assert torch.equal(got.distances, states[i][1]) and torch.equal(got.ids, states[i][2])


def test_torn_tail_cut_at_every_byte_of_the_last_frame(tmp_path):
    """Every crash prefix of the last frame, byte by byte, drops exactly the
    torn bytes and recovers the state of the ack before it."""
    snap = str(tmp_path / "snap")
    q, boundaries, states = _journaled_history(snap, n=64, d=8)
    lo, hi = boundaries[-2], boundaries[-1]
    for cut in range(lo, hi + 1):
        rec, delta_n, got = _recover_cut(snap, cut, q)
        i = _N_ACKS if cut == hi else _N_ACKS - 1
        assert rec.tail_records == i and rec.torn_bytes == cut - boundaries[i], cut
        assert delta_n == states[i][0]
        assert torch.equal(got.ids, states[i][2]) and torch.equal(got.distances, states[i][1])


# -- the reference's WAL in the port ------------------------------------------


def test_reference_wal_with_torn_tail_recovers_in_the_port(tmp_path):
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((512, 32)).astype(np.float32)
    ref = RIndex.build(np.arange(512), vecs, ivf_cells=16, nprobe=4)
    snap = str(tmp_path / "snap")
    rlc = RLifecycleIndex.attach(ref, RLifecycleConfig(snapshot_dir=snap))
    _churn(rlc)
    q = rng.standard_normal((16, 32)).astype(np.float32)
    want = rlc.search(q, 10)
    rlc.close()
    with open(os.path.join(snap, _JOURNAL), "ab") as f:
        f.write(struct.pack("<4sII", b"UPS\0", 4096, 0) + b"\1" * 100)
    lc, rec = _recover(snap)
    assert rec.tail_records == 3 and rec.torn_bytes == 112
    assert lc.index.impl == "torch" and lc.index._loc == ref._loc
    got = lc.search(q, 10)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_allclose(got.distances.numpy(), np.asarray(want.distances),
                               rtol=1e-5, atol=1e-4)
    lc.close()


def test_meter_lifecycle_keys_match_the_reference():
    ours, theirs = ServingMeter(), RMeter()
    for m in (ours, theirs):
        m.record(8, 0.01)
        for n, s in ((120, 0.002), (300, 0.004), (77, 0.003)):
            m.record_wal(1, n, s)
        m.record_handoff(1.5)
        m.record_handoff(0.5)
    a, b = ours.summary(), theirs.summary()
    for key in ("wal_records", "wal_bytes", "wal_fsync_ms", "handoffs", "handoff_train_s"):
        assert a[key] == pytest.approx(b[key]), key
    assert ours.wal_ack_ms(50) == pytest.approx(3.0) and ours.wal_ack_ms(100) == pytest.approx(4.0)


# -- kill -9 mid-ingest ---------------------------------------------------------

_KILL9_CHILD = """
import sys
import numpy as np
from repro_torch.serving import LifecycleConfig, LifecycleIndex, RetrievalIndex

snap = sys.argv[1]
rng = np.random.default_rng(0)
vecs = rng.standard_normal((256, 32)).astype(np.float32)
idx = RetrievalIndex.build(np.arange(256), vecs, device="cpu")
lc = LifecycleIndex.attach(idx, LifecycleConfig(snapshot_dir=snap))
nid = 256
for i in range(200):
    lc.insert(np.arange(nid, nid + 4), rng.standard_normal((4, 32)).astype(np.float32))
    nid += 4
    print(f"ACK {i}", flush=True)  # printed strictly after the fsync ack
"""


def _child(snap):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    return subprocess.Popen([sys.executable, "-c", _KILL9_CHILD, snap],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def test_kill9_mid_ingest_loses_no_acked_write(tmp_path):
    """SIGKILL a journaling writer; recovery equals a never-crashed twin."""
    snap = str(tmp_path / "snap")
    proc = _child(snap)
    acked = []
    try:
        deadline = time.monotonic() + 300
        while len(acked) < 3:
            line = proc.stdout.readline()
            if not line:
                break
            if line.startswith("ACK "):
                acked.append(int(line.split()[1]))
            assert time.monotonic() < deadline, "child produced no acks"
        proc.kill()
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.stdout.close()
        proc.stderr.close()
    assert acked and acked == list(range(len(acked)))
    lc, rec = _recover(snap)
    r = rec.tail_records
    assert r >= len(acked), (r, acked)  # no acked write lost
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((256, 32)).astype(np.float32)
    twin = RetrievalIndex.build(np.arange(256), vecs, **CPU)
    nid = 256
    for _ in range(r):
        twin.insert(np.arange(nid, nid + 4), rng.standard_normal((4, 32)).astype(np.float32))
        nid += 4
    assert len(lc) == len(twin)
    q = np.random.default_rng(99).standard_normal((24, 32)).astype(np.float32)
    _assert_bit_identical(twin.search(q, 10), lc.search(q, 10))
    lc.close()


def test_kill9_crash_restart_with_sigkill_signal(tmp_path):
    snap = str(tmp_path / "snap")
    proc = _child(snap)
    try:
        line = proc.stdout.readline()
        while line and not line.startswith("ACK 1"):
            line = proc.stdout.readline()
        assert line, "child never acked"
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.stdout.close()
        proc.stderr.close()
    lc, rec = _recover(snap)
    assert rec.tail_records >= 2
    assert len(lc) == 256 + 4 * rec.tail_records
    lc.close()


@pytest.mark.parametrize("module", ["snapshot_check", "lifecycle_check"])
def test_launch_checks_pass_in_fresh_processes(module, tmp_path):
    """The launch checks on the CPU: build, save or crash, then restore or
    recover in a fresh process with k-means a tripwire, bit-identical."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    proc = subprocess.run(
        [sys.executable, "-m", f"repro_torch.launch.{module}", "--out", str(tmp_path / "out"),
         "--device", "cpu", "--configs", "int8", "ivfpq"],
        capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert proc.stdout.count(": PASS") == 2, proc.stdout


# -- background retrain and epoch handoff --------------------------------------


@pytest.mark.parametrize("name", list(CONFIGS))
def test_background_handoff_bit_identical_to_sync_compact(name, tmp_path):
    idx, q = _base_index(CONFIGS[name])
    twin, _ = _base_index(CONFIGS[name])
    snap = str(tmp_path / name)
    lc = LifecycleIndex.attach(idx, LifecycleConfig(snapshot_dir=snap))
    _churn(lc)
    rng = np.random.default_rng(1)
    twin.insert(np.arange(512, 512 + 32), rng.standard_normal((32, 32)).astype(np.float32))
    twin.upsert(np.arange(512 + 28, 512 + 40), rng.standard_normal((12, 32)).astype(np.float32))
    twin.delete(np.arange(0, 512, 19))
    twin.compact()  # blocking repack; the first search trains synchronously
    want = twin.search(q, 10)
    lc.compact(wait=True)  # the worker trains, then the swap
    assert lc.stats()["epoch"] == twin._main_epoch
    assert lc.stats()["handoffs"] == 1
    _assert_bit_identical(want, lc.search(q, 10))
    lc.close()


def test_handoff_removes_the_old_image_off_the_serving_thread(tmp_path, monkeypatch):
    """The swap renames the old image aside and a thread of its own removes
    it; nothing is left beside the snapshot once the lifecycle closes."""
    from repro_torch.serving import lifecycle as L

    real, removed = L.shutil.rmtree, []

    def rmtree(path, *a, **kw):
        if ".old-" in str(path):
            removed.append(threading.current_thread().name)
        return real(path, *a, **kw)

    monkeypatch.setattr(L.shutil, "rmtree", rmtree)
    idx, q = _base_index(CONFIGS["ivf"])
    snap = str(tmp_path / "snap")
    lc = LifecycleIndex.attach(idx, LifecycleConfig(snapshot_dir=snap))
    _churn(lc)
    lc.compact(wait=True)
    lc.compact(wait=True)  # a second swap reuses the .old-<pid> name
    want = lc.search(q, 10)
    lc.close()
    assert removed == ["lifecycle-reap", "lifecycle-reap"]
    assert sorted(os.listdir(tmp_path)) == ["snap"]
    lc2, _ = _recover(snap)
    _assert_bit_identical(want, lc2.search(q, 10))
    lc2.close()


def test_mutations_during_pending_window_survive_handoff(tmp_path):
    idx, q = _base_index(CONFIGS["ivf"])
    snap = str(tmp_path / "snap")
    lc = LifecycleIndex.attach(idx, LifecycleConfig(snapshot_dir=snap))
    _churn(lc)
    lc.compact()  # the cut is taken; the worker trains
    lc.insert([7001], np.full((1, 32), 0.5, np.float32))
    lc.delete([1])
    assert lc.finish_handoff(wait=True)
    assert 7001 in lc and 1 not in lc
    assert lc.stats()["delta_rows"] == 1
    want = lc.search(q, 10)
    lc.close()
    lc2, _ = _recover(snap)  # a crash right after the swap
    assert 7001 in lc2 and 1 not in lc2
    _assert_bit_identical(want, lc2.search(q, 10))
    lc2.close()


def test_serving_thread_never_trains(tmp_path, monkeypatch):
    """k-means runs in the worker, never on the serving thread."""
    import repro_torch.core.kmeans as KM

    idx, q = _base_index(CONFIGS["ivfpq"])
    idx.search(q, 10)  # train the first epoch before arming
    snap = str(tmp_path / "snap")
    lc = LifecycleIndex.attach(idx, LifecycleConfig(snapshot_dir=snap))
    real, calls = KM.lloyd, []

    def guard(*a, **kw):
        assert threading.current_thread() is not threading.main_thread(), (
            "kmeans.lloyd entered on the serving thread")
        calls.append(threading.current_thread().name)
        return real(*a, **kw)

    monkeypatch.setattr(KM, "lloyd", guard)
    _churn(lc)
    lc.compact(wait=True)
    assert calls and set(calls) == {"lifecycle-train-2"}
    assert len(calls) == 1 + 8  # the cells, then one codebook a subspace
    lc.search(q, 10)
    lc.close()


def test_sync_train_tripwire_raises_instead_of_stalling(tmp_path):
    for name in ("ivf", "ivfpq"):
        idx, q = _base_index(CONFIGS[name])
        snap = str(tmp_path / name)
        lc = LifecycleIndex.attach(idx, LifecycleConfig(snapshot_dir=snap))
        lc.index.compact()  # bypass the lifecycle: the epoch is left untrained
        with pytest.raises(RuntimeError, match="tripwire"):
            lc.search(q, 10)
        lc.close()
    # The PQ side of the tripwire: cells given, codes missing.
    idx, q = _base_index(CONFIGS["ivfpq"])
    idx.search(q, 10)
    cells = idx._dev["main_ivf"]
    fresh = RetrievalIndex(32, **{**idx.config_kwargs()})
    fresh._main_vecs = idx._main_vecs
    fresh._forbid_sync_train = True
    fresh._dev["main_vecs"] = idx._dev["main_vecs"]
    with pytest.raises(RuntimeError, match="tripwire"):
        fresh._install_ivf(cells)


def test_engine_swaps_ready_epoch_at_batch_boundary(tmp_path):
    idx, q = _base_index(CONFIGS["flat"])
    snap = str(tmp_path / "snap")
    lc = LifecycleIndex.attach(idx, LifecycleConfig(snapshot_dir=snap))
    eng = QueryEngine(lc, EngineConfig(k=8, min_batch=8, max_batch=64))
    eng.search(q, 8)
    _churn(lc)
    epoch0 = lc.stats()["epoch"]
    lc.compact()  # no wait: the swap must come from the engine's hook
    lc._pending.thread.join(timeout=120)
    assert not lc._pending.thread.is_alive(), "worker never finished"
    assert lc.stats()["state"] == "handoff"
    assert lc.stats()["epoch"] == epoch0  # not swapped yet: no batch ran
    r = eng.search(q, 8)  # before_batch swaps, then the batch serves
    assert lc.stats()["state"] == "serve"
    assert lc.stats()["epoch"] == epoch0 + 1
    _assert_bit_identical(r, lc.search(q, 8))
    lc.close()


def test_worker_launches_are_tallied_apart_from_the_serving_counters():
    """A thread inside ``launch_tally`` counts into its tally; the module
    counters see only the threads without one.  Many threads, a short
    switch interval: a lost update would break the totals."""
    workers, per = 16, 500
    before = FK.LAUNCHES
    tallies, errors = [None] * workers, []

    def work(w):
        try:
            with B.launch_tally() as tally:
                for _ in range(per):
                    B.count_launch(FK.__name__, LAUNCHES=1, WIDE_LAUNCHES=1)
                tallies[w] = dict(tally)
        except BaseException as e:  # reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(w,)) for w in range(workers)]
        for t in threads:
            t.start()
        for _ in range(per):
            B.count_launch(FK.__name__, LAUNCHES=1)
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
        FK.LAUNCHES = before
    assert not errors and not any(t.is_alive() for t in threads)
    assert all(t == {"fused_knn.LAUNCHES": per, "fused_knn.WIDE_LAUNCHES": per}
               for t in tallies)


def test_handoff_records_worker_launches_and_meter(tmp_path):
    idx, q = _base_index(CONFIGS["ivf"])
    meter = ServingMeter()
    snap = str(tmp_path / "snap")
    lc = LifecycleIndex.attach(idx, LifecycleConfig(snapshot_dir=snap), meter=meter)
    _churn(lc)
    lc.compact(wait=True)
    s = meter.summary()
    assert s["wal_records"] == 3 and s["handoffs"] == 1 and s["handoff_train_s"] > 0
    assert lc.stats()["worker_launches"] == {}  # the CPU runs the plain versions
    lc.close()


# -- admission control ----------------------------------------------------------


def test_backpressure_applies_nothing_and_logs_nothing(tmp_path):
    idx, _ = _base_index(CONFIGS["flat"])
    snap = str(tmp_path / "snap")
    lc = LifecycleIndex.attach(idx, LifecycleConfig(snapshot_dir=snap, delta_budget=16))
    rng = np.random.default_rng(5)
    lc.insert(np.arange(512, 512 + 16), rng.standard_normal((16, 32)).astype(np.float32))
    tell0, delta0 = lc._wal.tell(), int(lc.index._delta_n)
    with pytest.raises(BackpressureError, match="budget"):
        lc.insert([9000], np.ones((1, 32), np.float32))
    assert lc._wal.tell() == tell0
    assert int(lc.index._delta_n) == delta0
    assert 9000 not in lc
    assert lc.stats()["rejected"] == 1
    lc.delete([512])  # deletes are always admitted
    lc.compact(wait=True)
    lc.insert([9000], np.ones((1, 32), np.float32))
    assert 9000 in lc
    lc.close()


# -- incremental checkpoint -----------------------------------------------------


def test_checkpoint_extends_stamp_without_rewriting_main(tmp_path):
    idx, q = _base_index(CONFIGS["flat"])
    snap = str(tmp_path / "snap")
    lc = LifecycleIndex.attach(idx, LifecycleConfig(snapshot_dir=snap))
    main = os.path.join(snap, "main.npz")
    st0 = os.stat(main)
    _churn(lc)
    lc.checkpoint()
    st1 = os.stat(main)
    assert (st0.st_mtime_ns, st0.st_size) == (st1.st_mtime_ns, st1.st_size)
    assert read_manifest(snap, verify=False)["files"][_JOURNAL]["bytes"] == lc._wal.tell()
    want = lc.search(q, 10)
    lc.close()
    lc2, rec = _recover(snap)
    assert rec.tail_records == 0 and rec.prefix_records >= 3
    _assert_bit_identical(want, lc2.search(q, 10))
    lc2.close()


def test_checkpoint_refuses_rebased_main(tmp_path):
    idx, _ = _base_index(CONFIGS["flat"])
    snap = str(tmp_path / "snap")
    lc = LifecycleIndex.attach(idx, LifecycleConfig(snapshot_dir=snap))
    lc._dirty_main = True
    with pytest.raises(SnapshotError, match="full"):
        lc.checkpoint()
    lc.close()


def test_synchronous_compact_rebases_the_image(tmp_path):
    idx, q = _base_index(CONFIGS["ivf"])
    snap = str(tmp_path / "snap")
    lc = LifecycleIndex.attach(idx, LifecycleConfig(snapshot_dir=snap,
                                                    background_retrain=False))
    _churn(lc)
    lc.compact()
    assert lc.stats()["epoch"] == 2 and not lc.stats()["dirty_main"]
    want = lc.search(q, 10)
    lc.close()
    lc2, rec = _recover(snap)
    assert rec.tail_records == 0
    _assert_bit_identical(want, lc2.search(q, 10))
    lc2.close()


# -- format upgrades ------------------------------------------------------------


def test_recover_upgrades_non_wal_snapshot(tmp_path):
    idx, q = _base_index(CONFIGS["flat"])
    snap = str(tmp_path / "snap")
    idx.save(snap)
    assert not read_manifest(snap, verify=False).get("wal")
    lc, rec = _recover(snap)
    assert not rec.wal
    assert read_manifest(snap, verify=False)["wal"]
    lc.insert([9000], np.ones((1, 32), np.float32))
    want = lc.search(q, 10)
    lc.close()
    lc2, rec2 = _recover(snap)
    assert rec2.wal and rec2.tail_records == 1
    _assert_bit_identical(want, lc2.search(q, 10))
    lc2.close()


def test_walwriter_refuses_v1_journal(tmp_path):
    path = str(tmp_path / "journal.bin")
    with open(path, "wb") as f:
        f.write(_JOURNAL_MAGIC_V1)
    with pytest.raises(SnapshotError, match="magic"):
        WalWriter(path)
