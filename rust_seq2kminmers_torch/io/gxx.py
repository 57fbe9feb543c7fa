"""Builds a host library of the port with g++ and loads it with ctypes.

The FASTA reader (``native/fasta_reader.cpp``) and the string kernels
(``native/rle.cpp``) are each compiled on first use into ``native/build/``
(not committed), keyed by a hash of the source, the flags and the host
CPU's feature flags (``-march=native`` builds for the CPU at hand).  Each
build writes a file of its own and renames it into place, so processes
that build at once never load half a library.  A build that fails raises
with g++'s output: nothing falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

GXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-pthread"]


def cpu_flags() -> bytes:
    """The host CPU's feature flags (Linux), part of a library's key."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((ln for ln in f if ln.startswith(b"flags")), b"")
    except OSError:
        return b""


def build(source: Path, build_dir: Path, prefix: str, signatures: dict) -> ctypes.CDLL:
    """Build ``source`` (once per source, flags and CPU) into ``build_dir``
    as ``{prefix}_{hash}.so`` and load it, declaring each function of
    ``signatures`` (name -> (restype, argtypes)); raises RuntimeError with
    g++'s output if the build fails."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode() + b"\0" + cpu_flags() + b"\0"
                            + source.read_bytes())
    so = build_dir / f"{prefix}_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        build_dir.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        try:
            proc = subprocess.run(
                ["g++", *GXX_FLAGS, str(source), "-o", str(tmp)],
                capture_output=True, text=True,
            )
        except OSError as e:
            raise RuntimeError(f"cannot run g++ to build {source.name}: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"g++ failed ({proc.returncode}) to build {source.name}:\n{proc.stderr}"
            )
        os.replace(tmp, so)  # atomic: a concurrent build never sees half a file
    lib = ctypes.CDLL(str(so))
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib
