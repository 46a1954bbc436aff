"""Build the port's CUDA sources with ``nvcc`` at first use; load with ctypes.

Each ``<name>.cu`` in this directory exports plain ``extern "C"``
launchers, so it compiles straight into a shared library with

    nvcc -O3 -std=c++17 -gencode arch=compute_90a,code=sm_90a -shared \
         -Xcompiler -fPIC -Xptxas -v

and loads through ``ctypes``: no ninja and no PyTorch headers, which keeps
a build to seconds. Objects go to ``.torch_kernels_build/`` at the
repository root (listed in ``.gitignore``), named by a hash of the
source, the ``nvcc`` version and the flags, so an edited source or
another toolkit rebuilds and a stale object is never loaded. Each object
is written under a temporary name and renamed into place, so concurrent
builds never load a half-written file. A failed build raises with the
compiler's output; nothing falls back to a plain version. Several sources
build in parallel, one ``nvcc`` process each (:func:`load_many`), and
``ptxas``'s report of each kernel's registers, shared memory and spills is
kept in :data:`REPORTS` for the sources built by this process.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from functools import lru_cache
from pathlib import Path
from typing import Dict, Sequence

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parents[2] / ".torch_kernels_build"
ARCH = "sm_90a"
# -gencode names the arch-specific virtual target too: "-arch=sm_90a" alone
# lowers through compute_90 PTX, which has no wgmma
FLAGS = ("-O3", "-std=c++17", "-gencode", f"arch=compute_90a,code={ARCH}", "-shared",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
REPORTS: Dict[str, str] = {}  # source name -> ptxas lines of its last build here


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, then ``/usr/local/cuda/bin/nvcc``, then PATH."""
    candidates = []
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            candidates.append(Path(os.environ[env]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH); the port's CUDA kernels are built from source at first use"
    )


@lru_cache(maxsize=None)
def _nvcc_version(nvcc: str) -> str:
    return subprocess.run(
        [nvcc, "--version"], capture_output=True, text=True, check=True
    ).stdout


def _object_path(name: str, nvcc: str) -> Path:
    src = SRC_DIR / f"{name}.cu"
    h = hashlib.sha256()
    h.update(src.read_bytes())
    h.update(_nvcc_version(nvcc).encode())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def load_many(names: Sequence[str]) -> Dict[str, float]:
    """Build (one ``nvcc`` per source, all started together) and load each
    ``<name>.cu`` not loaded yet. Returns the seconds from the start of the
    builds to each one's end (0.0 where the object was already built or
    loaded). Raises on the first failed build, with the compiler's output."""
    seconds: Dict[str, float] = {}
    with _lock:
        todo = [n for n in dict.fromkeys(names) if n not in _loaded]
        if not todo:
            return {n: 0.0 for n in names}
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.monotonic()
        jobs = []
        for name in todo:
            obj = _object_path(name, nvcc)
            proc = tmp = None
            if not obj.is_file():
                tmp = obj.with_name(f"{obj.name}.{os.getpid()}.tmp")
                cmd = [nvcc, *FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
                proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True)
            jobs.append((name, obj, tmp, proc))
        failure = None
        for name, obj, tmp, proc in jobs:
            if proc is not None:
                output, _ = proc.communicate()
                seconds[name] = time.monotonic() - t0
                if proc.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    failure = failure or (f"nvcc failed for {name}.cu "
                                          f"(exit {proc.returncode}):\n{output}")
                    continue
                os.replace(tmp, obj)
                REPORTS[name] = "\n".join(
                    line for line in output.splitlines()
                    if "ptxas" in line or "stack frame" in line)
            if failure is None:
                _loaded[name] = ctypes.CDLL(str(obj))
        if failure is not None:
            raise RuntimeError(failure)
    return {n: seconds.get(n, 0.0) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``<name>.cu``, built first if needed."""
    load_many([name])
    return _loaded[name]


__all__ = ["BUILD_DIR", "REPORTS", "find_nvcc", "load", "load_many"]
