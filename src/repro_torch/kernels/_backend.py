"""Device policy and the build of the hand-written CUDA kernels.

Policy: a tensor on the CPU runs its kernel's plain PyTorch version; a
tensor on a CUDA device launches the kernel or raises.  Nothing falls back.

Build: each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded with ``ctypes``.  The library name
carries a hash of the sources, so an edited kernel is rebuilt and a stale
library is never loaded.  ``build()`` starts one ``nvcc`` per source, all
at once, and waits for them; a failed build raises.  Outputs go to
``build/repro_torch/`` at the root of the checkout.

Every C entry point takes its pointers and its stream as ``void*`` and
returns a CUDA error code (``cudaGetLastError()`` after a launch); ``call``
and ``launch`` raise on a non-zero code.  This module imports nothing of
the package.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
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
KERNEL_SOURCES = ("pairwise_distance", "stream_topk", "fused_knn", "merge_partials")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


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
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"operands lie on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"unsupported device {dev}")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def require_f32(name: str, t: torch.Tensor, shape: tuple) -> None:
    require(t.dtype == torch.float32, f"{name}: want float32, got {t.dtype}")
    require(tuple(t.shape) == tuple(shape), f"{name}: want shape {shape}, got {tuple(t.shape)}")
    require(t.is_contiguous(), f"{name}: must be contiguous")


def require_vec4(d: int, *tensors: torch.Tensor) -> None:
    """The GEMM kernels read rows of d floats as float4s."""
    require(d % 4 == 0, f"the kernel reads rows in float4s; d={d} is not a multiple of 4")
    require(all(t.data_ptr() % 16 == 0 for t in tensors),
            "the kernel's operands must be 16-byte aligned")


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

    Returns the wall seconds spent.  The compiler's report (``-Xptxas -v``:
    registers, shared memory, spills) is kept beside each library as
    ``<name>-<hash>.log``.
    """
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
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
        else:
            failed.append(f"{name} (rc {rc}, see {out.with_suffix('.log')}):\n"
                          + out.with_suffix(".log").read_text()[-4000:])
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def call(name: str, entry: str, argtypes: list, device: torch.device, *args) -> None:
    """Call C entry point ``entry`` of library ``name`` with ``device``
    current; raise if it reports a CUDA error."""
    lib = load(name)
    fn = getattr(lib, entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        err = fn(*args)
    if err:
        msg = lib.repro_error_string(err).decode()
        raise RuntimeError(f"{entry}: CUDA error {err}: {msg}")


def launch(name: str, entry: str, argtypes: list, device: torch.device, *args) -> None:
    """``call``, with ``device``'s current stream as the last argument."""
    stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
    call(name, entry, argtypes, device, *args, stream)


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count
