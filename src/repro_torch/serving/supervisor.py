"""Process-isolated shard workers: spawn, supervise, respawn (DESIGN.md §15).

Port of ``repro/serving/supervisor.py``.  The child runs the port: it is
started as ``python -c "from repro_torch.serving.supervisor import
worker_main; ..."`` with ``PYTHONPATH`` taken from ``repro_torch`` itself,
and restores its image onto ``--device`` (the parent passes its own; the
default is ``cuda``).  A worker asked for CUDA on a machine without a card
raises through the HELLO error path and never serves from the CPU; on the
card its kernels launch or its query ships a typed ERROR frame, which the
router counts as a failure, as it counts a crash.

This module owns both ends of the worker process boundary:

* **Child** (``worker_main``): one OS process per replica.  It connects to
  the parent's per-worker Unix socket, restores its shard image
  (``snapshot.restore_shard``: no training, the same CRC-verified path the
  in-process backend uses), announces itself with a HELLO frame,
  and then serves a single-threaded QUERY/PING/DRAIN loop over the wire
  protocol (serving/transport.py).  A worker that loses its parent exits;
  one that receives DRAIN answers BYE and exits 0 — FIFO ordering on the
  socket means DRAIN is processed only after every queued query, which IS
  the graceful-drain guarantee.

* **Parent**: ``ProcWorker`` duck-types ``shards.ShardWorker`` (spec /
  config / centroids / ``topk`` / ...), so ``ShardRouter`` and the whole
  failover/health/degraded machinery of DESIGN.md §14 drive real processes
  without a line of routing changed.  Requests carry sequence numbers;
  replies for abandoned requests (a deadline fired and the router moved
  on) are recognized by their stale seq and discarded — a late reply is
  never served, matching ``run_with_failover``'s discard rule at the wire.
  The socket timeout is bound to the router's ``CallPolicy.deadline_s``,
  so health deadlines now bound REAL socket waits.  A bounded in-flight
  counter provides backpressure: once ``queue_depth`` requests are
  outstanding (only abandoned-but-unanswered ones accumulate), further
  calls raise ``BackpressureError`` and fail over instead of piling onto a
  struggling worker.

* **Supervisor**: ``WorkerSupervisor.poll`` runs once per router search —
  crash detection by exit code (``proc.poll``), broken pipe (a send/recv
  that died marks the worker), and heartbeat PING timeout on idle workers
  (catches a LIVE-but-wedged process, e.g. SIGSTOP).  A dead worker is
  respawned in place from its shard directory — same ``ProcWorker``
  object, fresh process + socket — and re-admitted through the health
  tracker's PROBATION state (``HealthTracker.mark_respawned``): a fresh
  process earns its traffic back through a trial call, exactly like a
  replica returning from ejection.  ``shutdown(drain=True)`` drains every
  worker before terminating; a supervisor is also registered with
  ``atexit`` so no run leaks worker processes.
"""
from __future__ import annotations

import atexit
import dataclasses
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from repro_torch.kernels._backend import resolve_device
from repro_torch.serving import transport as T
from repro_torch.serving.snapshot import (
    SnapshotError,
    read_fleet_manifest,
    read_shard_manifest,
    shard_dirs,
)

_SHARD_NPZ = "shard.npz"


@dataclasses.dataclass(frozen=True)
class SupervisorConfig:
    """Knobs of the process-worker tier (README "CLI reference" rows).

    ``call_timeout_s`` is the per-recv socket deadline when the router has
    no ``CallPolicy.deadline_s`` of its own — generous by default because a
    worker's first query legitimately pays an XLA compile.  ``heartbeat_s``
    is how long a worker may sit idle before ``poll`` probes it with a
    PING; ``heartbeat_timeout_s`` bounds that probe.  (A worker's first
    query on the card loads its kernel libraries.)  ``queue_depth``
    bounds abandoned-in-flight requests per worker before calls are
    refused with ``BackpressureError``.
    """

    heartbeat_s: float = 5.0
    heartbeat_timeout_s: float = 10.0
    queue_depth: int = 8
    call_timeout_s: float = 120.0
    spawn_timeout_s: float = 180.0
    respawn: bool = True

    def __post_init__(self):
        assert self.queue_depth >= 1, self.queue_depth
        assert self.heartbeat_s >= 0.0, self.heartbeat_s
        assert self.call_timeout_s > 0 and self.spawn_timeout_s > 0, self


class ProcWorker:
    """Parent-side handle to one worker process; duck-types ``ShardWorker``.

    Routing metadata (spec, config, parent fingerprint, centroids, live
    count) is loaded parent-side from the shard image's manifest + npz —
    the replicated quantizer must live in the router for probe routing
    anyway — while the packed rows, scan replica and PQ state exist ONLY
    in the worker process.  ``topk`` is a seq-numbered QUERY/RESULT
    exchange; every transport failure surfaces as a typed error the
    failover wrapper already understands.
    """

    # v1 QUERY frames carry no allow-list payload; the router checks this
    # flag and refuses allow-list filters before dispatch (DESIGN.md §17).
    supports_allow_filter = False

    def __init__(self, shard_dir: str, *, replica: int, n_replicas: int,
                 supervisor: "WorkerSupervisor"):
        from repro_torch.serving.shards import ShardSpec
        from repro_torch.serving.snapshot import IMPL_FROM_REFERENCE

        self.shard_dir = str(shard_dir)
        self._sup = supervisor
        # Parent-side verify=False: the worker process re-reads the image
        # through the CRC-verified restore path; stamping it twice per
        # replica would double the fleet's cold-start IO.
        manifest = read_shard_manifest(shard_dir, verify=False)
        sh = manifest["shard"]
        self.spec = ShardSpec(int(sh["shard_id"]), int(sh["n_shards"]),
                              int(sh["cell_lo"]), int(sh["cell_hi"]),
                              int(replica), int(n_replicas))
        self.config = dict(manifest["config"])
        self.parent = dict(manifest.get("parent", {}))
        self.extra = dict(manifest.get("extra", {}))
        stored = manifest.get("impl", "jnp")  # an unknown name fails in the worker's restore
        self.impl = (supervisor.impl if supervisor.impl is not None
                     else IMPL_FROM_REFERENCE.get(stored, stored))
        self.device = supervisor.device
        self.cell_cap = int(sh["cell_cap"])
        self.n_slots = self.spec.ncells_local * self.cell_cap
        # np.load is lazy per array: only the (small) centroid table and the
        # boolean live mask are read here, never the packed rows.
        with np.load(os.path.join(shard_dir, _SHARD_NPZ)) as z:
            self.centroids = torch.as_tensor(z["centroids"], dtype=torch.float32,
                                             device=self.device)
            self.n_live = int(z["live"].sum())
        self.dim = int(self.centroids.shape[1])
        self.wire_dtype = supervisor.wire_dtype
        self.queue_depth = supervisor.cfg.queue_depth
        self.pid: int | None = None
        self.respawns = 0
        self.spawn_s = None  # seconds from exec to HELLO of the current process
        self.test_delay_s = 0.0  # chaos hook: worker sleeps before answering
        self._proc: subprocess.Popen | None = None
        self._sock: socket.socket | None = None
        self._dead = True  # not spawned yet
        self._seq = 0
        self._pending = 0  # in-flight (sent, not yet retired by a reply)
        self._last_io = supervisor._clock()

    @property
    def key(self) -> str:
        return f"s{self.spec.shard_id}r{self.spec.replica}"

    @property
    def alive(self) -> bool:
        return (not self._dead and self._proc is not None
                and self._proc.poll() is None)

    # -- lifecycle (driven by the supervisor) -------------------------------

    def _attach(self, proc: subprocess.Popen, sock: socket.socket) -> None:
        self._proc, self._sock = proc, sock
        self.pid = proc.pid
        self._dead = False
        self._pending = 0
        self._last_io = self._sup._clock()

    def _mark_dead(self) -> None:
        self._dead = True

    def kill(self) -> None:
        """SIGKILL the live worker process (the ``kill`` chaos fault).

        Deliberately does NOT mark the handle dead: the next wire
        operation discovers the broken pipe exactly as it would for an
        uncommanded crash, which is the failure path under test.
        """
        if self._proc is not None and self._proc.poll() is None:
            os.kill(self._proc.pid, signal.SIGKILL)
            self._proc.wait()

    def _close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        if self._proc is not None and self._proc.poll() is None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait()

    # -- wire calls ---------------------------------------------------------

    def _retire_reply(self) -> None:
        self._pending = max(0, self._pending - 1)

    def topk(self, queries, k: int, *, nprobe: int | None = None,
             overfetch: int | None = None, allowed_ids=None):
        """One QUERY/RESULT exchange; same signature as ``ShardWorker.topk``.

        Raises ``WorkerCrashedError`` (dead process / broken pipe),
        ``WorkerTimeoutError`` (socket deadline), ``BackpressureError``
        (in-flight budget exhausted), ``WireError`` (corrupt frame), or
        the worker's own typed exception rebuilt from its ERROR frame —
        all of which the router's failover wrapper counts as this
        worker's failure and routes around.

        ``allowed_ids`` is refused: the v1 QUERY frame carries no
        allow-list payload.  Exclusion-only filters never reach workers
        (the router applies them post-merge), so those work unmodified
        over this transport (DESIGN.md §17).
        """
        from repro_torch.core.knn import KNNResult

        if allowed_ids is not None:
            raise NotImplementedError(
                f"{self.key}: allow-list filters are not supported over the "
                f"proc worker transport (v1 QUERY frames carry no "
                f"allow-list); use the inproc backend, or exclusion-only "
                f"filters (DESIGN.md §17)")
        if self._sock is None or self._dead:
            raise T.WorkerCrashedError(f"{self.key}: worker process is down")
        if self._pending >= self.queue_depth:
            raise T.BackpressureError(
                f"{self.key}: {self._pending} requests in flight >= "
                f"queue_depth {self.queue_depth}")
        q = np.ascontiguousarray(torch.as_tensor(queries, dtype=torch.float32).cpu().numpy())
        self._seq += 1
        seq = self._seq
        meta: dict = {"seq": seq, "k": int(k)}
        if nprobe is not None:
            meta["nprobe"] = int(nprobe)
        if overfetch is not None:
            meta["overfetch"] = int(overfetch)
        if self.wire_dtype is not None:
            meta["wire"] = str(self.wire_dtype)
        if self.test_delay_s:
            meta["delay_s"] = float(self.test_delay_s)
        self._pending += 1
        try:
            T.send_frame(self._sock, T.F_QUERY, meta, {"q": q})
            while True:
                ftype, m, arrays = T.recv_frame(self._sock)
                self._last_io = self._sup._clock()
                if ftype == T.F_PONG:
                    continue  # a heartbeat's answer crossed our query
                if ftype not in (T.F_RESULT, T.F_ERROR):
                    raise T.WireError(
                        f"{self.key}: unexpected frame type {ftype} while "
                        f"awaiting seq {seq}")
                self._retire_reply()
                if int(m.get("seq", -1)) != seq:
                    # A reply to a request some earlier deadline abandoned:
                    # late replies are discarded, never served (the wire
                    # analogue of run_with_failover's post-deadline rule).
                    continue
                if ftype == T.F_ERROR:
                    raise T.decode_error(m.get("error", {}))
                vals, ids = T.decode_result(arrays)
                return KNNResult(torch.from_numpy(vals).to(self.device),
                                 torch.from_numpy(ids).to(self.device))
        except T.WorkerCrashedError:
            self._mark_dead()
            raise

    def ping(self, timeout_s: float | None = None) -> None:
        """Heartbeat probe: PING → PONG within ``timeout_s`` or raise."""
        if self._sock is None or self._dead:
            raise T.WorkerCrashedError(f"{self.key}: worker process is down")
        old = self._sock.gettimeout()
        if timeout_s is not None:
            self._sock.settimeout(timeout_s)
        try:
            self._seq += 1
            T.send_frame(self._sock, T.F_PING, {"seq": self._seq})
            while True:
                ftype, m, _arrays = T.recv_frame(self._sock)
                self._last_io = self._sup._clock()
                if ftype == T.F_PONG:
                    return
                if ftype in (T.F_RESULT, T.F_ERROR):
                    self._retire_reply()  # stale reply drained by the probe
                    continue
                raise T.WireError(
                    f"{self.key}: unexpected frame type {ftype} in ping")
        except T.WorkerCrashedError:
            self._mark_dead()
            raise
        finally:
            if self._sock is not None:
                self._sock.settimeout(old)


class WorkerSupervisor:
    """Spawns and supervises one process per (shard, replica).

    ``poll`` is the supervision loop body — the router calls it once per
    search batch, so detection latency is bounded by traffic cadence plus
    ``heartbeat_s`` idle probing, and every respawn lands in the health
    tracker as PROBATION before the worker sees a query.
    """

    def __init__(self, cfg: SupervisorConfig = SupervisorConfig(), *,
                 impl: str | None = None, wire_dtype: str | None = None,
                 deadline_s: float | None = None, clock=time.monotonic,
                 device="cuda"):
        self.cfg = cfg
        self.impl = impl
        # The workers' device, and the router's: the parent passes its own.
        self.device = resolve_device(device)
        self.wire_dtype = wire_dtype
        # The router's per-dispatch deadline bounds the real socket wait;
        # without one, the generous call timeout keeps a wedged worker from
        # hanging a search forever.
        self.timeout_s = (deadline_s if deadline_s is not None
                          else cfg.call_timeout_s)
        self._clock = clock
        self.workers: list[ProcWorker] = []
        self.respawns = 0
        self._sock_root = tempfile.mkdtemp(prefix="repro-rpc-")
        self._closed = False
        atexit.register(self._atexit)

    # -- spawning -----------------------------------------------------------

    def spawn_fleet(self, directory: str, *,
                    replicas: int | None = None) -> list[ProcWorker]:
        """One worker process per (shard image, replica) under ``directory``.

        Mirrors ``shards.load_fleet``'s restore loop at process
        granularity; the fleet manifest's replication factor applies
        unless overridden.
        """
        manifest = read_fleet_manifest(directory)
        R = (int(manifest.get("replicas", 1)) if replicas is None
             else int(replicas))
        if R < 1:
            raise SnapshotError(f"fleet needs replicas >= 1, got {R}")
        out = []
        for d in shard_dirs(directory):
            for r in range(R):
                w = ProcWorker(d, replica=r, n_replicas=R, supervisor=self)
                self._spawn(w)
                self.workers.append(w)
                out.append(w)
        return out

    def _spawn(self, w: ProcWorker) -> None:
        """Start ``w``'s process: listen, exec the worker module, take the
        HELLO handshake, and hand the connected socket to the handle."""
        sock_path = os.path.join(self._sock_root,
                                 f"{w.key}-{w.respawns}.sock")
        if os.path.exists(sock_path):
            os.unlink(sock_path)
        listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        proc = None
        try:
            listener.bind(sock_path)
            listener.listen(1)
            listener.settimeout(self.cfg.spawn_timeout_s)
            env = dict(os.environ)
            # The worker must import repro_torch from the same tree as the
            # parent: derive src/ from the package itself, not from CWD.
            import repro_torch

            src = os.path.dirname(os.path.dirname(
                os.path.abspath(repro_torch.__file__)))
            env["PYTHONPATH"] = (src + os.pathsep + env["PYTHONPATH"]
                                 if env.get("PYTHONPATH") else src)
            # -c, not -m: the package init imports this module, so runpy's
            # -m would warn about re-executing an already-imported module.
            cmd = [sys.executable, "-c",
                   "from repro_torch.serving.supervisor import worker_main; "
                   "raise SystemExit(worker_main())",
                   "--shard-dir", w.shard_dir, "--socket", sock_path,
                   "--replica", str(w.spec.replica),
                   "--n-replicas", str(w.spec.n_replicas),
                   "--device", str(self.device)]
            if self.impl is not None:
                cmd += ["--impl", self.impl]
            t0 = time.perf_counter()
            proc = subprocess.Popen(cmd, env=env)
            try:
                conn, _ = listener.accept()
            except socket.timeout:
                raise SnapshotError(
                    f"worker {w.key} did not connect within "
                    f"{self.cfg.spawn_timeout_s}s (pid {proc.pid}, "
                    f"exit {proc.poll()})")
            conn.settimeout(self.cfg.spawn_timeout_s)
            ftype, meta, _arrays = T.recv_frame(conn)
            if ftype == T.F_ERROR:
                raise T.decode_error(meta.get("error", {}))
            if ftype != T.F_HELLO:
                raise T.WireError(
                    f"worker {w.key} opened with frame type {ftype}, "
                    f"not HELLO")
            if meta.get("key") != w.key or meta.get("n_slots") != w.n_slots:
                raise SnapshotError(
                    f"worker HELLO identity mismatch: announced "
                    f"{meta.get('key')}/{meta.get('n_slots')} slots, parent "
                    f"expected {w.key}/{w.n_slots} — wrong image restored?")
            conn.settimeout(self.timeout_s)
            w._attach(proc, conn)
            w.spawn_s = time.perf_counter() - t0
        except BaseException:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
            raise
        finally:
            listener.close()
            if os.path.exists(sock_path):
                os.unlink(sock_path)

    # -- supervision --------------------------------------------------------

    def poll(self, tracker=None) -> list[str]:
        """One supervision pass; returns the keys respawned this pass.

        Crash detection in priority order: process exit code, a connection
        already marked broken by a failed call, then (for live-but-idle
        workers past ``heartbeat_s``) a bounded PING probe — the path that
        catches a wedged process that still holds its socket open.
        Respawned workers re-enter routing through PROBATION.
        """
        respawned = []
        now = self._clock()
        for w in self.workers:
            dead = w._dead or (w._proc is not None
                               and w._proc.poll() is not None)
            if (not dead and self.cfg.heartbeat_s > 0
                    and now - w._last_io >= self.cfg.heartbeat_s):
                try:
                    w.ping(timeout_s=self.cfg.heartbeat_timeout_s)
                except Exception:  # noqa: BLE001 — any probe failure is death
                    dead = True
            if dead and self.cfg.respawn and not self._closed:
                self._respawn(w)
                respawned.append(w.key)
                if tracker is not None:
                    tracker.mark_respawned(w.key)
        return respawned

    def _respawn(self, w: ProcWorker) -> None:
        w._close()
        w.respawns += 1
        self.respawns += 1
        self._spawn(w)

    # -- shutdown -----------------------------------------------------------

    def shutdown(self, *, drain: bool = True) -> None:
        """Stop the fleet; with ``drain``, let each worker finish its queue.

        DRAIN rides the same FIFO socket as queries, so a worker answers
        everything already queued, replies BYE, and exits 0; workers that
        fail the handshake are terminated, then killed.
        """
        if self._closed:
            return
        self._closed = True
        if drain:
            for w in self.workers:
                if w._sock is None or w._dead:
                    continue
                try:
                    T.send_frame(w._sock, T.F_DRAIN, {})
                    w._sock.settimeout(self.cfg.heartbeat_timeout_s)
                    while True:
                        ftype, _m, _a = T.recv_frame(w._sock)
                        if ftype == T.F_BYE:
                            break
                        if ftype in (T.F_RESULT, T.F_ERROR):
                            w._retire_reply()
                    # BYE promises an exit-0; wait for it so _close below
                    # sees a finished process instead of SIGTERMing a
                    # worker mid-shutdown (that would turn every graceful
                    # drain into a -SIGTERM exit).
                    if w._proc is not None:
                        w._proc.wait(timeout=self.cfg.heartbeat_timeout_s)
                except Exception:  # noqa: BLE001 — drain is best-effort
                    pass
        for w in self.workers:
            w._close()
        shutil.rmtree(self._sock_root, ignore_errors=True)

    def _atexit(self) -> None:
        # Last-resort reaping: never leak worker processes past the parent.
        try:
            self.shutdown(drain=False)
        except Exception:  # noqa: BLE001
            pass

    def summary(self) -> dict:
        return {
            "workers": {w.key: {"pid": w.pid, "alive": w.alive,
                                "respawns": w.respawns, "spawn_s": w.spawn_s,
                                "pending": w._pending}
                        for w in self.workers},
            "respawns": self.respawns,
            "heartbeat_s": self.cfg.heartbeat_s,
            "queue_depth": self.cfg.queue_depth,
        }


# ---------------------------------------------------------------------------
# Worker child mode: ``worker_main`` (see ``WorkerSupervisor._spawn``).
# ---------------------------------------------------------------------------


def _serve_loop(sock: socket.socket, worker) -> int:
    """The worker process's request loop — single-threaded by design.

    The socket is FIFO, so queries are answered strictly in arrival order
    and a DRAIN frame cannot overtake pending work.  Every query is
    answered with RESULT or a typed ERROR carrying the same seq; losing
    the parent (EOF) is a normal exit, not a crash.
    """
    while True:
        try:
            ftype, meta, arrays = T.recv_frame(sock)
        except (T.WorkerCrashedError, T.WorkerTimeoutError):
            return 0  # parent went away; nothing left to serve
        if ftype == T.F_QUERY:
            seq = meta.get("seq")
            delay = float(meta.get("delay_s", 0.0))
            if delay > 0.0:
                time.sleep(delay)  # chaos hook: a deliberately slow worker
            try:
                if "q" not in arrays:
                    raise T.WireError(
                        f"QUERY frame without a q array: {sorted(arrays)}")
                r = worker.topk(
                    arrays["q"], int(meta["k"]),
                    nprobe=meta.get("nprobe"), overfetch=meta.get("overfetch"))
                T.send_frame(
                    sock, T.F_RESULT, {"seq": seq},
                    T.encode_result(r.distances, r.indices,
                                    wire_dtype=meta.get("wire")))
            except Exception as e:  # noqa: BLE001 — ships as a typed ERROR
                T.send_frame(sock, T.F_ERROR,
                             {"seq": seq, "error": T.encode_error(e)})
        elif ftype == T.F_PING:
            T.send_frame(sock, T.F_PONG, {"seq": meta.get("seq")})
        elif ftype == T.F_DRAIN:
            T.send_frame(sock, T.F_BYE, {})
            return 0
        else:
            # A parent speaking an unknown dialect: refuse loudly.
            T.send_frame(sock, T.F_ERROR, {"seq": None, "error": T.encode_error(
                T.WireError(f"worker cannot serve frame type {ftype}"))})
            return 2


def worker_main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="repro_torch.serving.supervisor")
    ap.add_argument("--shard-dir", required=True)
    ap.add_argument("--socket", required=True)
    ap.add_argument("--replica", type=int, default=0)
    ap.add_argument("--n-replicas", type=int, default=1)
    ap.add_argument("--impl", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # Connect BEFORE the (slow: CUDA init + CRC verify + upload) restore so
    # the parent can tell "starting up" from "never launched"; a restore
    # failure ships back as a typed ERROR frame instead of a bare exit code.
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.connect(args.socket)
    try:
        from repro_torch.serving.snapshot import restore_shard

        worker = restore_shard(args.shard_dir, impl=args.impl, device=args.device)
        worker.spec = worker.spec._replace(replica=args.replica,
                                           n_replicas=args.n_replicas)
    except Exception as e:  # noqa: BLE001 — report, then die
        T.send_frame(sock, T.F_ERROR, {"seq": None, "error": T.encode_error(e)})
        sock.close()
        return 1
    T.send_frame(sock, T.F_HELLO, {
        "key": worker.key, "pid": os.getpid(),
        "shard_id": worker.spec.shard_id, "replica": worker.spec.replica,
        "cell_lo": worker.spec.cell_lo, "cell_hi": worker.spec.cell_hi,
        "dim": worker.dim, "n_live": worker.n_live,
        "n_slots": worker.n_slots,
    })
    try:
        return _serve_loop(sock, worker)
    finally:
        sock.close()


if __name__ == "__main__":
    sys.exit(worker_main())
