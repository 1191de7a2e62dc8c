"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/*.cu`` source has a plain C interface and is compiled on its
own by ``nvcc -shared`` for ``sm_90a`` into ``paddle_tpu_torch/_build/``
(ignored by git), then loaded with ``ctypes``.  A file that included
PyTorch's headers would take minutes to compile; these take seconds.  The
library's name carries a hash of its source and flags, so an edited source
is rebuilt and an unchanged one is loaded as it is.

Nothing here runs at import: a library is built at its kernel's first
launch, or by ``build_all()``, which starts one ``nvcc`` per source at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["CudaLibrary", "LIBRARIES", "register", "build_all",
           "launch_counts", "reset_launch_counts", "BUILD_DIR", "CSRC_DIR",
           "ARG_PTR", "ARG_INT"]

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I = ctypes.c_void_p, ctypes.c_int


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "are built from csrc/ at first use")


class CudaLibrary:
    """One ``csrc/<name>.cu`` built into ``_build/<name>-<hash>.so``.

    ``functions`` maps each exported C function to its ``argtypes``; every
    exported function returns a ``cudaError_t`` as an ``int``.  ``launches``
    counts the wrapper calls that launched this library's kernel."""

    def __init__(self, name: str, functions: Dict[str, Sequence]):
        self.name = name
        self.source = os.path.join(CSRC_DIR, name + ".cu")
        self.functions = dict(functions)
        self.launches = 0
        self.build_seconds: Optional[float] = None
        self.build_log = ""
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def path(self) -> str:
        h = hashlib.sha256()
        with open(self.source, "rb") as f:
            h.update(f.read())
        h.update(" ".join(NVCC_FLAGS).encode())
        return os.path.join(BUILD_DIR, f"{self.name}-{h.hexdigest()[:16]}.so")

    def start_build(self) -> Optional[Tuple[subprocess.Popen, str, float]]:
        """Start ``nvcc`` unless the library is built; returns the process,
        its temporary output path and its start time."""
        out = self.path()
        if os.path.exists(out):
            return None
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, self.source]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp, time.perf_counter()

    def finish_build(self, started) -> None:
        if started is None:
            return
        proc, tmp, t0 = started
        log, _ = proc.communicate()
        self.build_seconds = time.perf_counter() - t0
        self.build_log = log
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(
                f"nvcc failed on {self.source} (exit {proc.returncode}):\n"
                f"{log}")
        # atomic publish: a concurrent builder of the same source loses
        # the race harmlessly (same content)
        os.replace(tmp, self.path())

    def lib(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self.finish_build(self.start_build())
                lib = ctypes.CDLL(self.path())
                for fn, argtypes in self.functions.items():
                    f = getattr(lib, fn)
                    f.argtypes = list(argtypes)
                    f.restype = ctypes.c_int
                lib.ptt_error_string.argtypes = [ctypes.c_int]
                lib.ptt_error_string.restype = ctypes.c_char_p
                self._lib = lib
            return self._lib

    def call(self, fn: str, *args) -> None:
        """Call an exported launcher; raise on the CUDA error it returns
        (a refused launch never runs, and a later synchronize would not
        report it)."""
        lib = self.lib()
        err = getattr(lib, fn)(*args)
        if err != 0:
            msg = lib.ptt_error_string(err).decode()
            raise RuntimeError(f"{self.name}.{fn}: CUDA error {err}: {msg}")


#: every kernel library of the port, by name (filled by the kernel modules)
LIBRARIES: Dict[str, CudaLibrary] = {}


def register(name: str, functions: Dict[str, Sequence]) -> CudaLibrary:
    lib = CudaLibrary(name, functions)
    LIBRARIES[name] = lib
    return lib


def build_all() -> Dict[str, float]:
    """Build every kernel library at once (one ``nvcc`` per source, all
    started together) and load them.  Returns build seconds per library
    (0.0 where the library was already built)."""
    from paddle_tpu_torch.ops import kernels  # noqa: F401 — registers all

    started: List[Tuple[CudaLibrary, object]] = [
        (lib, lib.start_build()) for lib in LIBRARIES.values()]
    errors = []
    for lib, st in started:
        try:
            lib.finish_build(st)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    for lib in LIBRARIES.values():
        lib.lib()
    return {name: (lib.build_seconds or 0.0)
            for name, lib in LIBRARIES.items()}


def launch_counts() -> Dict[str, int]:
    return {name: lib.launches for name, lib in LIBRARIES.items()}


def reset_launch_counts() -> None:
    for lib in LIBRARIES.values():
        lib.launches = 0


#: ctypes argument types of the launchers: a device pointer or the stream
#: (``ctypes.c_void_p``; an ``int`` argtype would cut a pointer to 32
#: bits) and a 32-bit int
ARG_PTR, ARG_INT = _P, _I
