"""Device policy and the build of the hand-written CUDA kernels.

Policy: a tensor on the CPU runs its kernel's plain PyTorch version; a
tensor on a CUDA device launches the kernel or raises.  Nothing falls back.

Build: each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded with ``ctypes``.  The library name
carries a hash of the sources, so an edited kernel is rebuilt and a stale
library is never loaded.  ``build()`` starts one ``nvcc`` per source, all
at once, and waits for them; a failed build raises.  Outputs go to
``build/repro_torch/`` at the root of the checkout.  Processes that start
together (a fleet's workers) build each library once: ``build()`` holds an
exclusive ``flock`` on ``build/repro_torch/.build.lock`` from its check for
the library to the rename of the new one, so a second process waits and
then finds the library, and no two compilers write one ``.log``.

Every C entry point takes its pointers and its stream as ``void*`` and
returns a CUDA error code (``cudaGetLastError()`` after a launch); ``call``
and ``launch`` raise on a non-zero code.  This module imports nothing of
the package.

Calls into one library are serialized across threads.  An entry point sets
its kernel's shared-memory limit for the launch's width and then launches;
the limit is the kernel's, not the launch's, so two threads launching one
kernel at two widths (the lifecycle's background k-means at K 1 beside a
serving batch's probe at K 8) could interleave the two steps and launch
past the limit the other thread set: ``invalid argument`` (seen on the
card, PERF.md).  A call only enqueues, so the other thread waits
microseconds.

Launch counts: each wrapper counts its launches (``count_launch``) in its
module's counters (``LAUNCHES`` and its variants), which the serving
thread's callers zero and read.  A thread that launches beside it (the
lifecycle's background retrain) opens a ``launch_tally`` first; its
launches then go to its own tally, never to the module counters, so the
two never mix and no counter is written from two threads.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
KERNEL_SOURCES = ("pairwise_distance", "stream_topk", "fused_knn", "fused_knn_masked",
                  "merge_partials", "rescore", "ivf_scan", "pq_scan", "pairwise_cumulative")

BUILT: list[str] = []  # the libraries this process compiled, in order
_LIBS: dict[str, ctypes.CDLL] = {}
_CALLS: dict[str, threading.Lock] = {}  # one a library: its calls, one at a time
_LOCK = threading.Lock()
_TALLY = threading.local()


# ---------------------------------------------------------------------------
# Device policy.
# ---------------------------------------------------------------------------


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; asking for CUDA without one raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' was asked for but torch sees no CUDA device; "
                "pass device='cpu' to run the plain versions on the host")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True if every tensor lies on one CUDA device, False if all on the CPU.

    Mixed or other devices raise: a wrapper never moves data behind the
    caller's back.
    """
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            devs = {str(t.device) for t in tensors}
            raise ValueError(f"operands lie on several devices: {sorted(devs)}")
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"unsupported device {dev}")


def require(cond: bool, msg) -> None:
    """Raise ValueError(msg) unless ``cond``; ``msg`` may be a function
    giving it, so that a launch does not format a message it never shows."""
    if not cond:
        raise ValueError(msg() if callable(msg) else msg)


def require_f32(name: str, t: torch.Tensor, shape: tuple) -> None:
    require(t.dtype == torch.float32, lambda: f"{name}: want float32, got {t.dtype}")
    require(t.shape == tuple(shape),
            lambda: f"{name}: want shape {tuple(shape)}, got {tuple(t.shape)}")
    require(t.is_contiguous(), lambda: f"{name}: must be contiguous")


def require_vec4(d: int, *tensors: torch.Tensor) -> None:
    """The kernels read rows four elements at a time (16 bytes of fp32, 8 of
    bf16, 4 of int8), so d is a multiple of 4 and each operand is aligned
    to four of its elements."""
    require(d % 4 == 0, lambda: f"the kernel reads rows in fours; d={d} is not a multiple of 4")
    require(all(t.data_ptr() % (4 * t.element_size()) == 0 for t in tensors),
            "the kernel's operands must be aligned to four elements")


# ---------------------------------------------------------------------------
# Build and load.
# ---------------------------------------------------------------------------


def _source_hash(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_source_hash(name)}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME); cannot build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build(names=KERNEL_SOURCES) -> float:
    """Compile every library in ``names`` that is not built yet, in parallel.

    Returns the wall seconds spent, the wait for another process's build
    included.  The compiler's report (``-Xptxas -v``: registers, shared
    memory, spills) is kept beside each library as ``<name>-<hash>.log``.
    """
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        jobs = []
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            log = open(out.with_suffix(".log"), "w")
            proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
            jobs.append((name, proc, tmp, out, log))
        failed = []
        for name, proc, tmp, out, log in jobs:
            rc = proc.wait()
            log.close()
            if rc == 0:
                os.replace(tmp, out)
                BUILT.append(name)
            else:
                failed.append(f"{name} (rc {rc}, see {out.with_suffix('.log')}):\n"
                              + out.with_suffix(".log").read_text()[-4000:])
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _CALLS[name] = threading.Lock()
            _LIBS[name] = lib
        return lib


def call(name: str, entry: str, argtypes: list, device: torch.device, *args) -> None:
    """Call C entry point ``entry`` of library ``name`` with ``device``
    current; raise if it reports a CUDA error.  (A launch's host time is
    latency to a small kernel's caller: the entry point is typed once per
    loaded library, and the device switched only when another is
    current.)"""
    lib = load(name)
    fn = getattr(lib, entry)  # ctypes keeps the function object on the library
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    with _CALLS[name]:
        if device.index is None or device.index == torch.cuda.current_device():
            err = fn(*args)
        else:
            with torch.cuda.device(device):
                err = fn(*args)
    if err:
        msg = lib.repro_error_string(err).decode()
        raise RuntimeError(f"{entry}: CUDA error {err}: {msg}")


def launch(name: str, entry: str, argtypes: list, device: torch.device, *args) -> None:
    """``call``, with ``device``'s current stream as the last argument."""
    call(name, entry, argtypes, device, *args, torch.cuda.current_stream(device).cuda_stream)


@contextlib.contextmanager
def launch_tally():
    """Count the calling thread's kernel launches apart from the module
    counters while the block runs; yields the tally, a dict
    ``{"<wrapper module>.<counter>": count}`` filled as launches happen."""
    tally: dict[str, int] = {}
    outer = getattr(_TALLY, "counts", None)
    _TALLY.counts = tally
    try:
        yield tally
    finally:
        _TALLY.counts = outer


def count_launch(module: str, **counts: int) -> None:
    """Add one launch's ``counts`` (counter name -> increment) to the calling
    thread's tally if it holds one, else to the counters of the wrapper
    module named ``module``."""
    tally = getattr(_TALLY, "counts", None)
    short = module.rsplit(".", 1)[-1]
    for name, n in counts.items():
        if tally is None:
            mod = sys.modules[module]
            setattr(mod, name, getattr(mod, name) + int(n))
        else:
            tally[f"{short}.{name}"] = tally.get(f"{short}.{name}", 0) + int(n)


def ptr(t: torch.Tensor | None) -> int | None:
    """A tensor's address for a ``void*`` parameter (None: a null pointer)."""
    return None if t is None else t.data_ptr()


def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count
