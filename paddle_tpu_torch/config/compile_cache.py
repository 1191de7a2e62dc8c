"""Persistent cache of the port's built kernel libraries — counterpart of
``paddle_tpu/config/compile_cache.py`` (the reference's cache of serialized
XLA executables).

The port compiles no per-shape program: what a replica builds at boot is
its kernel libraries — each ``csrc/<name>.cu`` through ``nvcc -shared`` for
``sm_90a`` into ``_build/<name>-<hash>.so`` (``ops/kernels/build.py``), and
the native data core through ``g++`` (``data/native.py``).  This module
stores those built libraries as the reference stores executables, so a warm
replica *loads* them instead of running the compiler:

- :class:`CompileCacheDir` — a shared ``--compile_cache_dir`` of
  ``<key>.aotx`` files (one fleet-wide directory warms every replica after
  the first boot; a publish directory's ``ccache/`` is one);
- :class:`BundleAotCache` — ``aot/<key>.aotx`` members embedded in the
  ``.ptz`` bundle itself (:func:`warm_bundle`): ship one artifact, boot
  without a compiler run;
- :class:`ChainCache` — the bundle's members first, then the directory.

An entry is a JSON header line — the magic string, its key, a label, the
platform fingerprint of the toolchain that built it (torch and CUDA
versions, the ``nvcc`` or ``g++`` version, the card, the build flags) and
a CRC-32 of the payload — then the library's bytes.  The key
(:func:`cache_key`) carries the library's name and its source hash (the
``_build`` file name), so an edited source never meets an old entry.

A stale entry (another platform) or a corrupt one (bad CRC, truncated,
unparsable header) is a LOGGED MISS that falls back to a fresh build —
never a crash, never a wrong library.  A library loaded from a cache is
installed into ``_build/`` by an atomic rename only after its smoke call
has passed: one small launch of each of its kernels, held against the
kernel's plain version (``CudaLibrary.smoke``; the native core against its
numpy fallback).  A failed smoke call is a logged miss and a rebuild, and
the rebuilt library repairs the entry.  A library without a smoke call is
never loaded from a cache: it builds.

How entries are used: ``CudaLibrary.lib`` and ``data/native.py`` (both
:class:`BuiltLibrary`) consult the ACTIVE cache (:func:`using_cache`)
before they build; on a miss they build and store.  :func:`priming` activates a cache for a block and records
the libraries the block ran, which ``InferenceModel.prime(cache=)`` and
``SlotScheduler.prime`` turn into their hit/miss counts.  ``builds`` and
``cache_loads`` on each library (:func:`library_stats`) count compiler runs
and cache loads, so a warm boot shows zero ``nvcc`` runs.

The reference's ``wire_jax_compilation_cache`` has no counterpart: it points
JAX's own persistent compilation cache at a directory when a backend cannot
serialize executables.  The port has no JIT compiler to redirect — a built
library is a file, and every platform can store it
(:func:`serialization_supported`).
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import json
import os
import platform as _platform
import subprocess
import tempfile
import threading
import zipfile
import zlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

from paddle_tpu_torch.utils.log import logger

__all__ = ["CompileCacheDir", "BundleAotCache", "ChainCache", "cache_key",
           "platform_fingerprint", "open_cache", "serialization_supported",
           "warm_bundle", "AOT_PREFIX", "using_cache", "active_cache",
           "priming", "library_stats", "cached_libraries", "BuiltLibrary"]

_AOTX_MAGIC = "paddle_tpu_torch.aotx.v1"
#: zip member prefix for entries embedded in a .ptz bundle
AOT_PREFIX = "aot/"
_SUFFIX = ".aotx"


def serialization_supported() -> bool:
    """Whether built libraries can be stored: always — a library is a file
    (the reference asks whether its JAX can serialize executables)."""
    return True


@functools.lru_cache(maxsize=None)
def _nvcc_version() -> str:
    """The CUDA toolkit's version, read from its ``version.json`` beside
    ``bin/nvcc`` (no compiler run), else from ``nvcc --version``."""
    from paddle_tpu_torch.ops.kernels.build import _nvcc

    try:
        nvcc = _nvcc()
    except RuntimeError:
        return "none"
    home = os.path.dirname(os.path.dirname(os.path.realpath(nvcc)))
    try:
        with open(os.path.join(home, "version.json")) as f:
            return str(json.load(f)["cuda"]["version"])
    except (OSError, ValueError, KeyError, TypeError):
        pass
    try:
        out = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, timeout=60).stdout
        return (out.strip().splitlines() or ["?"])[-1]
    except OSError as e:
        return f"unknown ({e})"


@functools.lru_cache(maxsize=None)
def _gxx_version() -> str:
    try:
        return subprocess.run(["g++", "-dumpfullversion"],
                              capture_output=True, text=True,
                              timeout=60).stdout.strip() or "?"
    except OSError:
        return "none"


def platform_fingerprint(toolchain: str = "nvcc") -> str:
    """What a built library must match to be loaded: for ``"nvcc"`` the
    card, the torch and CUDA versions, the toolkit's version and the build
    flags (a library built for another card or toolkit is garbage, not
    slow); for ``"g++"`` the host's machine type, the compiler's version
    and the flags."""
    if toolchain == "nvcc":
        import torch

        from paddle_tpu_torch.ops.kernels.build import NVCC_FLAGS

        kind = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
                else "no-card")
        return (f"cuda:{kind}:torch {torch.__version__}:cuda "
                f"{torch.version.cuda}:nvcc {_nvcc_version()}:"
                f"{' '.join(NVCC_FLAGS)}")
    if toolchain == "g++":
        from paddle_tpu_torch.data.native import CXX_FLAGS

        return (f"cpu:{_platform.machine()}:g++ {_gxx_version()}:"
                f"{' '.join(CXX_FLAGS)}")
    raise ValueError(f"unknown toolchain {toolchain!r}")


def cache_key(kind: str, *parts: Any) -> str:
    """Deterministic content key: the artifact kind plus its identity (a
    library's name and source hash), hashed.  The platform rides the entry
    HEADER, so a mismatch is a logged stale miss, attributable, instead of
    an unexplained key miss."""
    blob = json.dumps([kind, *[str(p) for p in parts]], sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:32]


def _encode_entry(payload: bytes, *, key: str, label: str, platform: str,
                  meta: Optional[dict] = None) -> bytes:
    header = {"magic": _AOTX_MAGIC, "key": key, "label": label,
              "platform": platform, "crc32": zlib.crc32(payload),
              **(meta or {})}
    return json.dumps(header).encode() + b"\n" + payload


def _decode_entry(blob: bytes, *, key: str, platform: str, where: str,
                  quiet: bool = False) -> Optional[Tuple[bytes, dict]]:
    """One entry -> (payload, header), or None with the miss reason logged.
    Every failure mode — torn header, stale platform, CRC mismatch — is a
    miss that degrades to a fresh build."""
    warn = (lambda *a: None) if quiet else logger.warning
    try:
        head_raw, body = blob.split(b"\n", 1)
        header = json.loads(head_raw)
    except Exception:  # noqa: BLE001 — a torn entry is a miss
        warn("compile cache: %s is corrupt (unparsable header) — "
             "rebuilding", where)
        return None
    if not isinstance(header, dict) or header.get("magic") != _AOTX_MAGIC:
        warn("compile cache: %s is not an aotx entry — rebuilding", where)
        return None
    if header.get("key") != key:
        warn("compile cache: %s key mismatch (stored for %r) — rebuilding",
             where, header.get("key"))
        return None
    if header.get("platform") != platform:
        warn("compile cache: %s is stale (platform %r != %r) — rebuilding",
             where, header.get("platform"), platform)
        return None
    if zlib.crc32(body) != header.get("crc32"):
        warn("compile cache: %s payload CRC mismatch (torn or bit-flipped "
             "entry) — rebuilding", where)
        return None
    return body, header


class _CacheBase:
    """Shared counters and the load/store contract.  ``hits``/``misses``
    count loads; a present-but-untrustworthy entry is a miss."""

    def __init__(self) -> None:
        self.hits = 0
        self.misses = 0

    def _read(self, key: str) -> Optional[bytes]:
        raise NotImplementedError

    def _write(self, key: str, blob: bytes) -> bool:
        raise NotImplementedError

    def _where(self, key: str) -> str:
        raise NotImplementedError

    def peek(self, key: str, platform: str) -> bool:
        """Whether a valid entry is present, without counting or logging."""
        blob = self._read(key)
        return blob is not None and _decode_entry(
            blob, key=key, platform=platform, where="", quiet=True) is not None

    def load(self, key: str, platform: str
             ) -> Optional[Tuple[bytes, dict]]:
        blob = self._read(key)
        if blob is None:
            self.misses += 1
            return None
        got = _decode_entry(blob, key=key, platform=platform,
                            where=self._where(key))
        if got is None:
            self.misses += 1
            return None
        self.hits += 1
        return got

    def store(self, key: str, payload: bytes, *, platform: str,
              label: str = "", meta: Optional[dict] = None) -> bool:
        return self._write(key, _encode_entry(payload, key=key, label=label,
                                              platform=platform, meta=meta))


class CompileCacheDir(_CacheBase):
    """A shared directory of ``<key>.aotx`` entries (``--compile_cache_dir``).
    Writes are atomic (temp + rename), so replicas racing on a cold fleet
    boot never read each other's torn entries."""

    def __init__(self, root: str) -> None:
        super().__init__()
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key + _SUFFIX)

    def _where(self, key: str) -> str:
        return self._path(key)

    def _read(self, key: str) -> Optional[bytes]:
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None
        except OSError as e:
            logger.warning("compile cache: %s unreadable (%s) — rebuilding",
                           self._path(key), e)
            return None

    def _write(self, key: str, blob: bytes) -> bool:
        try:
            fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
            with os.fdopen(fd, "wb") as f:
                f.write(blob)
            os.replace(tmp, self._path(key))
            return True
        except OSError as e:
            logger.warning("compile cache: could not write %s (%s)",
                           self._path(key), e)
            return False


class BundleAotCache(_CacheBase):
    """``aot/<key>.aotx`` members inside a ``.ptz`` bundle — the
    self-contained deploy artifact (:func:`warm_bundle` fills them).  A
    torn member is a logged miss.  Writes (``writable=True``) add members
    to the zip; replicas serving a shared read-only bundle leave
    ``writable`` off."""

    def __init__(self, bundle_path: str, *, writable: bool = False) -> None:
        super().__init__()
        self.bundle_path = bundle_path
        self.writable = writable
        try:
            with zipfile.ZipFile(bundle_path) as z:
                self._members = set(z.namelist())
        except Exception:  # noqa: BLE001 — an unreadable bundle has none
            self._members = set()

    def _member(self, key: str) -> str:
        return AOT_PREFIX + key + _SUFFIX

    def _where(self, key: str) -> str:
        return f"{self.bundle_path}!{self._member(key)}"

    def has_entries(self) -> bool:
        return any(m.startswith(AOT_PREFIX) for m in self._members)

    def _read(self, key: str) -> Optional[bytes]:
        name = self._member(key)
        if name not in self._members:
            return None
        try:
            with zipfile.ZipFile(self.bundle_path) as z:
                return z.read(name)
        except Exception as e:  # noqa: BLE001 — torn member = logged miss
            logger.warning("compile cache: bundle member %s unreadable "
                           "(%s: %s) — rebuilding", self._where(key),
                           type(e).__name__, e)
            return None

    def _write(self, key: str, blob: bytes) -> bool:
        if not self.writable:
            return False
        name = self._member(key)
        try:
            if name in self._members:
                # a store over an existing member is a REPAIR (it missed
                # because it was corrupt or stale): rewrite the archive
                # with the member replaced
                with zipfile.ZipFile(self.bundle_path) as z:
                    members = [(i.filename, z.read(i.filename))
                               for i in z.infolist() if i.filename != name]
                tmp = self.bundle_path + ".tmp"
                with zipfile.ZipFile(tmp, "w", zipfile.ZIP_DEFLATED) as z:
                    for mname, data in members:
                        z.writestr(mname, data)
                    z.writestr(name, blob)
                os.replace(tmp, self.bundle_path)
            else:
                with zipfile.ZipFile(self.bundle_path, "a",
                                     zipfile.ZIP_DEFLATED) as z:
                    z.writestr(name, blob)
            self._members.add(name)
            return True
        except Exception as e:  # noqa: BLE001
            logger.warning("compile cache: could not embed %s (%s: %s)",
                           self._where(key), type(e).__name__, e)
            return False


class ChainCache(_CacheBase):
    """Bundle-embedded entries first, then the shared dir; stores go to
    every writable layer."""

    def __init__(self, caches: List[_CacheBase]) -> None:
        super().__init__()
        self.caches = [c for c in caches if c is not None]

    def peek(self, key: str, platform: str) -> bool:
        return any(c.peek(key, platform) for c in self.caches)

    def load(self, key: str, platform: str
             ) -> Optional[Tuple[bytes, dict]]:
        for c in self.caches:
            got = c.load(key, platform)
            if got is not None:
                self.hits += 1
                return got
        self.misses += 1
        return None

    def store(self, key: str, payload: bytes, *, platform: str,
              label: str = "", meta: Optional[dict] = None) -> bool:
        return any([c.store(key, payload, platform=platform, label=label,
                            meta=meta) for c in self.caches])


def open_cache(bundle: Optional[str] = None, cache_dir: str = ""
               ) -> Optional[_CacheBase]:
    """The serve command line's policy: the bundle's embedded ``aot/``
    members when it carries any (read-only — a fleet shares the
    artifact), plus a writable ``--compile_cache_dir``; None when neither
    is given."""
    layers: List[_CacheBase] = []
    if bundle:
        b = BundleAotCache(bundle)
        if b.has_entries():
            layers.append(b)
    if cache_dir:
        layers.append(CompileCacheDir(cache_dir))
    if not layers:
        return None
    return layers[0] if len(layers) == 1 else ChainCache(layers)


# ---------------------------------------------------------------------------
# the active cache and the libraries a block ran
# ---------------------------------------------------------------------------

_active: List[_CacheBase] = []
_active_lock = threading.Lock()
_tls = threading.local()


def active_cache() -> Optional[_CacheBase]:
    """The cache a library consults before it builds (the innermost
    :func:`using_cache`), or None."""
    return _active[-1] if _active else None


@contextlib.contextmanager
def using_cache(cache: Optional[_CacheBase]) -> Iterator[None]:
    """Make ``cache`` the active one, process-wide, for the block (None
    leaves the active cache as it is)."""
    if cache is None:
        yield
        return
    with _active_lock:
        _active.append(cache)
    try:
        yield
    finally:
        with _active_lock:
            _active.remove(cache)


def note_library(lib) -> None:
    """Called by a library each time it is used: the recording block of
    this thread, if any, learns that the block ran it."""
    rec = getattr(_tls, "rec", None)
    if rec is not None and lib.name not in rec.libs:
        rec.libs[lib.name] = lib


class _Recorder:
    def __init__(self) -> None:
        self.libs: Dict[str, Any] = {}
        self.serial = _load_serial[0]


_load_serial = [0]
_serial_lock = threading.Lock()


def next_serial() -> int:
    """A library's load stamp: loads after a recording started carry a
    larger one."""
    with _serial_lock:
        _load_serial[0] += 1
        return _load_serial[0]


@contextlib.contextmanager
def priming(cache: Optional[_CacheBase]) -> Iterator[Dict[str, Any]]:
    """Run a block with ``cache`` active and settle, afterwards, every
    cacheable library the block ran against it: one loaded from this
    cache during the block is a hit; one rebuilt because its entry failed
    the smoke call repairs the entry and is a miss; one built, found on
    disk or already resident is a hit when the cache holds a valid entry
    for it, else it is stored and is a miss.  Yields the counts, filled on exit:
    ``{"hits", "misses", "libraries": {name: "hit" | "miss"}}``."""
    counts: Dict[str, Any] = {"hits": 0, "misses": 0, "libraries": {}}
    rec = _Recorder()
    prev = getattr(_tls, "rec", None)
    _tls.rec = rec
    try:
        with using_cache(cache):
            yield counts
    finally:
        _tls.rec = prev
        if prev is not None:
            for name, lib in rec.libs.items():
                prev.libs.setdefault(name, lib)
    if cache is None:
        return
    for name, lib in rec.libs.items():
        if getattr(lib, "smoke", None) is None:
            continue                      # not cacheable: always built
        if (lib.origin == "cache" and lib.loaded_serial > rec.serial
                and lib.loaded_from is cache):
            event = "hit"
        elif lib._repair:
            # its entry failed the smoke call: the rebuilt library repairs it
            store(cache, lib, force=True)
            lib._repair = False
            event = "miss"
        elif cache.load(lib.cache_key(), lib.platform()) is not None:
            event = "hit"
        else:
            store(cache, lib)
            event = "miss"
        counts["libraries"][name] = event
        counts["hits" if event == "hit" else "misses"] += 1


def recording() -> bool:
    """Whether this thread runs inside :func:`priming` (which settles the
    libraries the block ran when it ends)."""
    return getattr(_tls, "rec", None) is not None


class BuiltLibrary:
    """A library a compiler builds and this cache can store: the state and
    the cache's side of loading it, shared by ``CudaLibrary`` and the
    native data core.  A subclass gives ``name``, ``path()`` (its
    ``_build`` file), ``cache_key()``, ``platform()`` and ``smoke`` (a
    callable, or None when the library must never load from a cache).

    ``builds`` counts compiler runs, ``cache_loads`` loads from a cache,
    ``origin`` where the loaded library came from (``"built"``, ``"disk"``
    or ``"cache"``), ``smoke_result`` its smoke call's errors."""

    smoke = None

    def __init__(self) -> None:
        self.builds = 0
        self.cache_loads = 0
        self.origin: Optional[str] = None
        self.loaded_serial = 0
        self.loaded_from = None
        self.smoke_result: Optional[Dict[str, float]] = None
        self.build_log = ""
        self._repair = False          # a cached entry failed its smoke call

    def loaded(self, origin: str, cache=None) -> None:
        self.origin = origin
        self.loaded_from = cache
        self.loaded_serial = next_serial()

    def load_from_cache(self, open_lib, drop_lib) -> bool:
        """Load the library from the active cache when its ``_build`` file
        is missing: the entry is written under a temporary name beside it
        (the loader keeps one handle per path, so a rejected library must
        never shadow the rebuilt one), opened with ``open_lib(path)``,
        smoke-called and only then renamed into place.  False on a miss
        or a failed smoke call (logged; ``drop_lib()`` forgets the handle,
        and the rebuild repairs the entry)."""
        cache = active_cache()
        path = self.path()
        if cache is None or self.smoke is None or os.path.exists(path):
            return False
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.{next_serial()}.cache.so"
        got = cache.load(self.cache_key(), self.platform())
        if got is None:
            return False
        payload, header = got
        try:
            with open(tmp, "wb") as f:
                f.write(payload)
            open_lib(tmp)
            self.smoke_result = self.smoke()
        except Exception as e:  # noqa: BLE001 — a bad entry rebuilds
            logger.warning("compile cache: %s loaded from the cache failed "
                           "its smoke call (%s: %s) — rebuilding", self.name,
                           type(e).__name__, e)
            drop_lib()
            self.smoke_result = None
            cache.hits -= 1
            cache.misses += 1
            self._repair = True
            if os.path.exists(tmp):
                os.remove(tmp)
            return False
        os.replace(tmp, path)
        self.build_log = header.get("build_log", "")
        self.cache_loads += 1
        self.loaded("cache", cache)
        return True

    def store_built(self) -> None:
        """After a build or a load from disk: store the library in the
        active cache (repairing the entry that failed its smoke call),
        unless a ``priming`` block settles it."""
        cache = active_cache()
        if cache is not None and self.smoke is not None and not recording():
            store(cache, self, force=self._repair)
            self._repair = False


def store(cache: _CacheBase, lib, *, force: bool = False) -> bool:
    """Store ``lib``'s built file in ``cache`` unless a valid entry is
    already there (``force``: a repair of an entry that failed its smoke
    call)."""
    key, plat = lib.cache_key(), lib.platform()
    if not force and cache.peek(key, plat):
        return False
    try:
        with open(lib.path(), "rb") as f:
            payload = f.read()
    except OSError as e:
        logger.warning("compile cache: %s not stored (%s)", lib.name, e)
        return False
    return cache.store(key, payload, platform=plat, label=lib.name,
                       meta={"library": lib.name,
                             "file": os.path.basename(lib.path()),
                             "build_log": lib.build_log or ""})


def cached_libraries() -> List[Any]:
    """Every library this module manages: the CUDA kernel libraries
    registered so far and the native data core."""
    from paddle_tpu_torch.data import native
    from paddle_tpu_torch.ops.kernels.build import LIBRARIES

    return [*LIBRARIES.values(), native.NATIVE]


def library_stats() -> Dict[str, dict]:
    """Per library: compiler runs (``builds``), cache loads
    (``cache_loads``), where the loaded library came from (``origin``:
    ``"built"``, ``"disk"`` or ``"cache"``; None when not loaded) and its
    smoke call's largest error by kernel (``smoke``; None unless loaded
    from a cache)."""
    return {lib.name: {"builds": lib.builds, "cache_loads": lib.cache_loads,
                       "origin": lib.origin, "smoke": lib.smoke_result}
            for lib in cached_libraries()}


# ---------------------------------------------------------------------------
# bundles
# ---------------------------------------------------------------------------


def warm_bundle(bundle_path: str, *, max_batch: int = 8,
                feeds: Optional[List[Dict[str, Any]]] = None,
                outputs: Optional[List[str]] = None,
                cache: Optional[_CacheBase] = None,
                device=None) -> Dict[str, int]:
    """Prime every warmup batch bucket of a bundle and store the libraries
    its forward runs as ``aot/`` members (or into ``cache``) — run once
    after export, and a replica serving the artifact loads them instead of
    running the compiler.  The bucket ladder and row padding are the
    serving hot path's own (``serving.batching``).  ``device`` is where
    the model runs (the card unless the caller asks otherwise)."""
    from paddle_tpu_torch.config.deploy import load_inference_model
    from paddle_tpu_torch.serving.batching import (batch_bucket,
                                                   warmup_bucket_feeds)
    from paddle_tpu_torch.serving.feeds import example_feed

    model = load_inference_model(bundle_path, device=device)
    if cache is None:
        cache = BundleAotCache(bundle_path, writable=True)
    if feeds is None:
        feeds = [example_feed(model.topology)]
    buckets = sorted({batch_bucket(r, max_batch)
                      for r in range(1, max_batch + 1)})
    counts = {"hits": 0, "misses": 0, "buckets": 0}
    for feed in feeds:
        for padded in warmup_bucket_feeds(feed, buckets):
            r = model.prime(padded, outputs=outputs, cache=cache)
            counts["buckets"] += 1
            counts["hits" if r == "hit" else "misses"] += 1
    return counts
