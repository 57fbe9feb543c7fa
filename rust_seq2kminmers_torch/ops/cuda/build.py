"""Builds the port's CUDA kernels and binds them with ctypes.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one ``nvcc``
per source, all started together) and linked into ONE shared library with
a plain C interface, the first time a kernel is launched in a process.
The library lands in ``csrc/build/`` (not committed), keyed by a hash of
the sources and flags, so an edit rebuilds it and an unchanged tree
reuses it.  Each C entry point returns ``cudaGetLastError()`` after
its launch; ``check`` turns a non-zero code into an exception.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel
]

# Kernel launches per wrapper, counted where each wrapper launches, and
# where a captured graph that holds the launch is replayed (``graph.py``).
launches: collections.Counter = collections.Counter()


@contextlib.contextmanager
def counted_as_captured():
    """For a graph capture: the wrappers run inside the block record
    their launches into the graph but launch nothing.  So at the end of
    the block their rise is taken back out of ``launches`` and left in the
    Counter the block yields, which each replay of the graph adds back.
    Launches made meanwhile by another thread would be taken out too; a
    capture runs while no other thread launches."""
    before = launches.copy()
    rise: collections.Counter = collections.Counter()
    try:
        yield rise
    finally:
        rise.update(launches - before)
        launches.clear()
        launches.update(before)


@dataclasses.dataclass(frozen=True)
class Library:
    lib: ctypes.CDLL
    path: Path
    built: bool  # compiled in this process, or loaded from an earlier build
    seconds: float  # time to build (or load) in this process
    log: str  # nvcc's output, kept beside the library


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _compile_and_link(sources, objdir: Path, out: Path) -> str:
    """One nvcc per source, run together, then one link; -> the log."""
    nvcc = _nvcc()
    procs = [
        (src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(objdir / f"{src.stem}.o"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
        for src in sources
    ]
    log, failed = "", []
    for src, proc in procs:  # wait for every compiler before raising
        log += f"== {src.name}\n" + proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(out),
         *(str(objdir / f"{src.stem}.o") for src in sources)],
        capture_output=True, text=True,
    )
    log += link.stdout + link.stderr
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{log}")
    return log


@functools.lru_cache(maxsize=None)
def library() -> Library:
    """Build (once per source hash) and load the kernel library."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        digest.update(p.name.encode() + b"\0" + p.read_bytes())
    so = BUILD_DIR / f"libs2k_{digest.hexdigest()[:16]}.so"
    log_path = so.with_suffix(".log")
    t0 = time.perf_counter()
    built = not so.exists()
    if built:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as objdir:
            log = _compile_and_link(sources, Path(objdir), tmp)
        log_path.write_text(log)
        os.replace(tmp, so)  # atomic: a concurrent build never sees half a file
    log = log_path.read_text() if log_path.exists() else ""
    lib = ctypes.CDLL(str(so))
    lib.s2k_error_string.argtypes = [ctypes.c_int]
    lib.s2k_error_string.restype = ctypes.c_char_p
    return Library(lib, so, built, time.perf_counter() - t0, log)


def function(name: str, argtypes: list):
    """The C entry point ``name`` with its argument types declared."""
    fn = getattr(library().lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(err: int, name: str) -> None:
    if err != 0:
        msg = library().lib.s2k_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def require(t, name: str, dtype, shape, device) -> None:
    """Raise unless t is a tensor of this dtype, shape and device."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")


def require_cuda(device, **tensors) -> None:
    """Raise unless the device is a GPU and every tensor given (None is an
    absent optional input) is contiguous."""
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    for name, t in tensors.items():
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name}: the kernel needs a contiguous tensor")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
