"""ctypes binding for the port's native data-pipeline core
(``paddle_tpu_torch/csrc/dataio.cc``) — counterpart of
``paddle_tpu/data/native.py``.

The library is compiled on first use with ``g++ -O3 -shared -fPIC
-std=c++17`` into the git-ignored ``paddle_tpu_torch/_build/``, under
``libpaddle_tpu_torch_dataio-<hash>.so`` (the hash over the source and the
flags, so an edited source is rebuilt; a build writes a temporary file and
renames it).  Every entry point has the reference's numpy fallback, taken
when no library loads (no toolchain, or a failed build: ``build_error()``
says why).  The two branches agree on everything but ``shuffle_indices``:
the C++ shuffle (``std::mt19937_64``) and the fallback
(``RandomState.permutation``) give different permutations, so parity holds
branch by branch.  This is host code: nothing here touches the card.

With a compile cache active (``config/compile_cache.py``), a missing
library is first looked up there: a hit is loaded after its smoke call (each
entry point on a small input against its numpy fallback; the shuffle must
give a permutation) and renamed into ``_build/``, with no ``g++`` run; a
miss builds and stores it.  ``NATIVE`` is the core as a cache artifact:
its ``builds`` count ``g++`` runs, its ``cache_loads`` loads from a cache.
"""

from __future__ import annotations

import ctypes
import hashlib
import itertools
import os
import subprocess
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

from paddle_tpu_torch.config.compile_cache import BuiltLibrary
from paddle_tpu_torch.utils.log import logger

__all__ = [
    "NATIVE",
    "native_available",
    "shuffle_indices",
    "bucket_by_length",
    "argsort_by_length",
    "pad_batch_i32",
    "pack_sequences",
    "count_tokens",
    "library_path",
    "build_error",
]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "dataio.cc")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

# re-entrant: the smoke call of a cache-loaded library runs the entry points
_lock = threading.RLock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_error: Optional[str] = None


def library_path() -> str:
    """Where the library is (or will be) built: ``_build/`` of the port,
    named by a hash of the source and the flags."""
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"libpaddle_tpu_torch_dataio-{h.hexdigest()[:16]}.so")


def build_error() -> Optional[str]:
    """Why the library did not load (None when it did or was not tried)."""
    return _error


class _NativeCore(BuiltLibrary):
    """The native data core as a compile-cache artifact."""

    name = "dataio"

    @staticmethod
    def path() -> str:
        return library_path()

    def cache_key(self) -> str:
        from paddle_tpu_torch.config.compile_cache import cache_key

        return cache_key("native_library", self.name,
                         os.path.basename(library_path()))

    @staticmethod
    def platform() -> str:
        from paddle_tpu_torch.config.compile_cache import platform_fingerprint

        return platform_fingerprint("g++")

    def smoke(self) -> dict:
        return _smoke()


NATIVE = _NativeCore()


def _build(so: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SOURCE], check=True,
                       capture_output=True, timeout=120)
        NATIVE.builds += 1
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.ptd_shuffle_indices.argtypes = [ctypes.c_int32, ctypes.c_uint64,
                                        i32p]
    lib.ptd_bucket_by_length.argtypes = [i32p, ctypes.c_int32, i32p,
                                         ctypes.c_int32, i32p]
    lib.ptd_argsort_by_length.argtypes = [i32p, ctypes.c_int32, i32p]
    lib.ptd_pad_batch_i32.argtypes = [i32p, i64p, ctypes.c_int32,
                                      ctypes.c_int32, i32p, i32p]
    lib.ptd_pack_sequences.argtypes = [i32p, i64p, ctypes.c_int32,
                                       ctypes.c_int32, ctypes.c_int32,
                                       i32p, i32p, i32p]
    lib.ptd_pack_sequences.restype = ctypes.c_int32
    lib.ptd_count_tokens.argtypes = [i32p, ctypes.c_int64,
                                     ctypes.c_int32, i64p]
    lib.ptd_version.restype = ctypes.c_int32
    return lib


def _open(path: str) -> None:
    global _lib
    _lib = _configure(ctypes.CDLL(path))


def _drop() -> None:
    global _lib
    _lib = None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, _error
    from paddle_tpu_torch.config import compile_cache

    compile_cache.note_library(NATIVE)
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            if NATIVE.load_from_cache(_open, _drop):
                return _lib
            so = library_path()
            builds = NATIVE.builds
            if not os.path.exists(so):
                _build(so)
            _open(so)
            NATIVE.loaded("built" if NATIVE.builds > builds else "disk")
        except Exception as e:  # toolchain absent or compile failure
            err = getattr(e, "stderr", None)
            _error = f"{e}" + (f": {err.decode(errors='replace')}"
                               if isinstance(err, bytes) and err else "")
            logger.warning("native dataio unavailable (%s); using numpy "
                           "fallback", _error)
            _lib = None
            return None
        NATIVE.store_built()
        return _lib


def native_available() -> bool:
    return _load() is not None


def _i32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _i64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _flatten(seqs: Sequence[Sequence[int]]) -> Tuple[np.ndarray, np.ndarray]:
    """(the ids of every sequence back to back as int32, the [n + 1]
    offsets), in one pass over the ids with no per-row numpy call."""
    lens = np.fromiter(map(len, seqs), np.int64, count=len(seqs))
    offsets = np.zeros(len(seqs) + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    flat = np.fromiter(itertools.chain.from_iterable(seqs), np.int32,
                       count=int(offsets[-1]))
    return flat, offsets


def shuffle_indices(n: int, seed: int) -> np.ndarray:
    lib = _load()
    out = np.empty(n, np.int32)
    if lib is not None:
        lib.ptd_shuffle_indices(n, seed, _i32(out))
        return out
    rng = np.random.RandomState(seed % (2**31))
    return rng.permutation(n).astype(np.int32)


def bucket_by_length(lens: np.ndarray, buckets: Sequence[int]) -> np.ndarray:
    lens = np.ascontiguousarray(lens, np.int32)
    bk = np.ascontiguousarray(buckets, np.int32)
    out = np.empty(len(lens), np.int32)
    lib = _load()
    if lib is not None:
        lib.ptd_bucket_by_length(_i32(lens), len(lens), _i32(bk), len(bk),
                                 _i32(out))
        return out
    return _np_bucket_by_length(lens, bk)


def _np_bucket_by_length(lens: np.ndarray, bk: np.ndarray) -> np.ndarray:
    idx = np.searchsorted(bk, lens)
    return np.minimum(idx, len(bk) - 1).astype(np.int32)


def argsort_by_length(lens: np.ndarray) -> np.ndarray:
    lens = np.ascontiguousarray(lens, np.int32)
    out = np.empty(len(lens), np.int32)
    lib = _load()
    if lib is not None:
        lib.ptd_argsort_by_length(_i32(lens), len(lens), _i32(out))
        return out
    return np.argsort(lens, kind="stable").astype(np.int32)


def pad_batch_i32(seqs: Sequence[Sequence[int]], max_t: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Zero-pad ``seqs`` into [n, max_t] int32, clipping at ``max_t``;
    -> (ids, clipped lengths)."""
    flat, offsets = _flatten(seqs)
    n = len(seqs)
    out = np.zeros((n, max_t), np.int32)
    lens = np.empty(n, np.int32)
    lib = _load()
    if lib is not None:
        lib.ptd_pad_batch_i32(_i32(flat), _i64(offsets), n, max_t, _i32(out),
                              _i32(lens))
        return out, lens
    return _np_pad_batch_i32(seqs, out, lens, max_t)


def _np_pad_batch_i32(seqs, out: np.ndarray, lens: np.ndarray, max_t: int):
    for i, s in enumerate(seqs):
        L = min(len(s), max_t)
        out[i, :L] = list(s)[:L]
        lens[i] = L
    return out, lens


def pack_sequences(seqs: Sequence[Sequence[int]], n_rows: int, T: int):
    """Greedy-pack sequences into [n_rows, T] with 1-based segment ids
    (0 = pad). Returns (ids, seg_ids, row_used, n_placed)."""
    flat, offsets = _flatten(seqs)
    ids = np.zeros((n_rows, T), np.int32)
    seg = np.zeros((n_rows, T), np.int32)
    used = np.zeros(n_rows, np.int32)
    lib = _load()
    if lib is not None:
        placed = lib.ptd_pack_sequences(_i32(flat), _i64(offsets), len(seqs),
                                        n_rows, T, _i32(ids), _i32(seg),
                                        _i32(used))
        return ids, seg, used, int(placed)
    return _np_pack_sequences(seqs, ids, seg, used, n_rows, T)


def _np_pack_sequences(seqs, ids, seg, used, n_rows: int, T: int):
    placed = 0
    for s in seqs:
        L = len(s)
        if L > T:
            continue
        for r in range(n_rows):
            if used[r] + L <= T:
                ids[r, used[r]: used[r] + L] = s
                seg[r, used[r]: used[r] + L] = placed + 1
                used[r] += L
                placed += 1
                break
    return ids, seg, used, placed


def count_tokens(seqs: Sequence[Sequence[int]], vocab_cap: int) -> np.ndarray:
    flat, _ = _flatten(seqs)
    counts = np.zeros(vocab_cap, np.int64)
    lib = _load()
    if lib is not None:
        lib.ptd_count_tokens(_i32(flat), len(flat), vocab_cap, _i64(counts))
        return counts
    np.add.at(counts, flat[(flat >= 0) & (flat < vocab_cap)], 1)
    return counts


def _smoke() -> dict:
    """Each entry point of the loaded library on a small seeded input
    against its numpy fallback (the shuffle, whose branches differ by
    design, must give a permutation); raises on a disagreement, else
    returns 0.0 by entry point."""
    rng = np.random.RandomState(0)
    seqs = [list(rng.randint(0, 50, rng.randint(1, 9))) for _ in range(12)]
    lens = np.asarray([len(q) for q in seqs], np.int32)
    bk = np.asarray([2, 4, 8], np.int32)
    checks = {
        "shuffle_indices": np.array_equal(
            np.sort(shuffle_indices(37, 5)), np.arange(37)),
        "bucket_by_length": np.array_equal(
            bucket_by_length(lens, bk), _np_bucket_by_length(lens, bk)),
        "argsort_by_length": np.array_equal(
            argsort_by_length(lens), np.argsort(lens, kind="stable")),
    }
    got = pad_batch_i32(seqs, 6)
    want = _np_pad_batch_i32(seqs, np.zeros((12, 6), np.int32),
                             np.empty(12, np.int32), 6)
    checks["pad_batch_i32"] = all(np.array_equal(a, b)
                                  for a, b in zip(got, want))
    got = pack_sequences(seqs, 5, 10)
    want = _np_pack_sequences(seqs, np.zeros((5, 10), np.int32),
                              np.zeros((5, 10), np.int32),
                              np.zeros(5, np.int32), 5, 10)
    checks["pack_sequences"] = (all(np.array_equal(a, b) for a, b in
                                    zip(got[:3], want[:3]))
                                and got[3] == want[3])
    want = np.zeros(40, np.int64)
    flat = np.concatenate([np.asarray(q, np.int64) for q in seqs])
    np.add.at(want, flat[flat < 40], 1)
    checks["count_tokens"] = np.array_equal(count_tokens(seqs, 40), want)
    bad = sorted(k for k, ok in checks.items() if not ok)
    if bad:
        raise RuntimeError(f"native data core smoke call: {bad} disagree "
                           f"with the numpy fallback")
    return {k: 0.0 for k in checks}
