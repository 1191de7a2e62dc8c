"""Indexed record shards — the on-disk tier of the deterministic data
pipeline (docs/data.md).

The reference's data tier streams Python generators (PyDataProvider2);
production input pipelines need an *addressable* on-disk format so a
seeded permutation over record indices — not the accident of stream
order — defines what each host reads (the tf.data / Grain index-based
determinism model).  A shard file is:

    header   : b"PTSH" + u32 version
    records  : (u32 payload_len, u32 crc32(payload), payload) ...
    index    : u64 little-endian offset per record (offset of its
               length word)
    footer   : u32 crc32(index bytes), u64 index_offset,
               u64 record_count, b"PTSX"     (fixed 24 bytes)

The fixed-size footer makes open O(1): seek to EOF-24, read the index,
and every record is one ``seek`` away (``ShardReader.read(i)``).  Every
record carries its own CRC, so corruption is detected at the exact
record — a failed check raises :class:`ShardCorruptError` naming the
shard file and record index (the chaos model: ``resilience.chaos
.corrupt_shard`` / ``truncate_shard``).

A *shard set* is a directory of ``shard-%05d-of-%05d.ptshard`` files
plus a ``manifest.json`` recording per-shard record counts, byte sizes
and whole-file CRCs.  Sets are written atomically with the same
temp-dir + fsync + rename discipline as ``resilience/checkpoint_io``:
a killed ``pack`` never leaves a half-set a reader would trust.

Payloads are pickled Python samples (protocol 4) — the same row tuples
every ``paddle_tpu_torch.data`` reader yields, so ``write_shard_set`` (the
``pack`` step, also ``python -m paddle_tpu_torch data pack``) converts any
existing reader into shards without a schema.
"""

from __future__ import annotations

import json
import os
import pickle
import struct
import time
import uuid
import zlib
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np

from paddle_tpu_torch.resilience.errors import ReaderError
from paddle_tpu_torch.utils.log import logger

__all__ = [
    "SHARD_VERSION",
    "ShardError",
    "ShardCorruptError",
    "ShardWriter",
    "ShardReader",
    "ShardDataset",
    "write_shard_set",
    "shard_name",
]

SHARD_VERSION = 1
_MAGIC = b"PTSH"
_FOOT_MAGIC = b"PTSX"
_HEADER = struct.Struct("<4sI")          # magic, version
_REC_HEAD = struct.Struct("<II")         # payload_len, crc32
_FOOTER = struct.Struct("<IQQ4s")        # index_crc, index_off, count, magic

_TMP_PREFIX = ".tmp-"


class ShardError(ReaderError):
    """A shard file or shard-set manifest is structurally unusable
    (missing, wrong magic, bad footer).  Subclasses ``ReaderError`` so the
    trainer attributes shard failures to the data tier."""


class ShardCorruptError(ShardError):
    """A specific record (or the index) failed its CRC.  ``path`` names
    the shard file; ``record`` is the record index within it (None for
    index/footer corruption) — the exact address a repair job needs."""

    def __init__(self, message: str, *, path: str,
                 record: Optional[int] = None) -> None:
        super().__init__(message)
        self.path = path
        self.record = record


def shard_name(i: int, n: int) -> str:
    return f"shard-{i:05d}-of-{n:05d}.ptshard"


def _obs_counters():
    from paddle_tpu_torch.obs import get_registry

    reg = get_registry()
    return (reg.counter("data_shard_records_total",
                        "records decoded from shard files"),
            reg.counter("data_shard_read_bytes_total",
                        "payload bytes read from shard files"))


class ShardWriter:
    """Append records to one shard file; ``close()`` writes the index +
    footer.  Tracks a running whole-file CRC for the set manifest."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._f = open(path, "wb")
        self._offsets: List[int] = []
        self._crc = 0
        self._write(_HEADER.pack(_MAGIC, SHARD_VERSION))

    def _write(self, b: bytes) -> None:
        self._crc = zlib.crc32(b, self._crc)
        self._f.write(b)

    def append(self, sample: Any) -> int:
        """Write one record; returns its index within this shard."""
        payload = pickle.dumps(sample, protocol=4)
        self._offsets.append(self._f.tell())
        self._write(_REC_HEAD.pack(len(payload), zlib.crc32(payload)))
        self._write(payload)
        return len(self._offsets) - 1

    @property
    def records(self) -> int:
        return len(self._offsets)

    def close(self) -> Dict[str, Any]:
        """Finalize: index + footer, fsync.  Returns the manifest entry
        (file CRC covers everything INCLUDING the footer)."""
        index_off = self._f.tell()
        index = np.asarray(self._offsets, dtype="<u8").tobytes()
        self._write(index)
        self._write(_FOOTER.pack(zlib.crc32(index), index_off,
                                 len(self._offsets), _FOOT_MAGIC))
        self._f.flush()
        os.fsync(self._f.fileno())
        size = self._f.tell()
        self._f.close()
        return {"file": os.path.basename(self.path),
                "records": len(self._offsets),
                "bytes": size, "crc32": self._crc}

    def __enter__(self) -> "ShardWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class ShardReader:
    """O(1) random access over one shard file.

    Opening reads only the footer + index (CRC-validated); ``read(i)``
    seeks straight to record ``i`` and validates its per-record CRC —
    a mismatch raises :class:`ShardCorruptError` naming this file and
    the record index.  Read volume lands on the ``data_shard_*``
    registry counters (docs/observability.md)."""

    def __init__(self, path: str) -> None:
        self.path = path
        try:
            self._f = open(path, "rb")
        except OSError as e:
            raise ShardError(f"cannot open shard {path!r}: {e}") from e
        try:
            head = self._f.read(_HEADER.size)
            if len(head) < _HEADER.size or \
                    _HEADER.unpack(head)[0] != _MAGIC:
                raise ShardCorruptError(
                    f"shard {path!r}: bad header magic", path=path)
            self._f.seek(0, os.SEEK_END)
            end = self._f.tell()
            if end < _HEADER.size + _FOOTER.size:
                raise ShardCorruptError(
                    f"shard {path!r}: truncated below footer size",
                    path=path)
            self._f.seek(end - _FOOTER.size)
            icrc, ioff, count, magic = _FOOTER.unpack(
                self._f.read(_FOOTER.size))
            if magic != _FOOT_MAGIC:
                raise ShardCorruptError(
                    f"shard {path!r}: bad footer magic (truncated or "
                    f"overwritten tail)", path=path)
            self._f.seek(ioff)
            index = self._f.read(count * 8)
            if len(index) != count * 8 or zlib.crc32(index) != icrc:
                raise ShardCorruptError(
                    f"shard {path!r}: record index failed CRC", path=path)
            self._offsets = np.frombuffer(index, dtype="<u8")
        except Exception:
            self._f.close()
            raise
        self._records_c, self._bytes_c = _obs_counters()

    def __len__(self) -> int:
        return int(self._offsets.shape[0])

    def read(self, i: int) -> Any:
        """Decode record ``i``; CRC-verified."""
        if not 0 <= i < len(self):
            raise IndexError(f"record {i} out of range for shard "
                             f"{self.path!r} ({len(self)} records)")
        self._f.seek(int(self._offsets[i]))
        head = self._f.read(_REC_HEAD.size)
        if len(head) < _REC_HEAD.size:
            raise ShardCorruptError(
                f"shard {self.path!r} record {i}: truncated header",
                path=self.path, record=i)
        ln, crc = _REC_HEAD.unpack(head)
        payload = self._f.read(ln)
        if len(payload) != ln or zlib.crc32(payload) != crc:
            raise ShardCorruptError(
                f"shard {self.path!r} record {i}: payload failed CRC",
                path=self.path, record=i)
        self._records_c.inc()
        self._bytes_c.inc(ln)
        try:
            return pickle.loads(payload)
        except Exception as e:
            raise ShardCorruptError(
                f"shard {self.path!r} record {i}: undecodable payload "
                f"({type(e).__name__}: {e})", path=self.path, record=i) from e

    def __iter__(self) -> Iterator[Any]:
        for i in range(len(self)):
            yield self.read(i)

    def close(self) -> None:
        self._f.close()


class ShardDataset:
    """A shard SET: the manifest + lazily-opened readers, addressed by
    GLOBAL record index (0..num_records) — the domain the deterministic
    sampler permutes (datapipe/sampler.py)."""

    def __init__(self, root: str) -> None:
        self.root = root
        mpath = os.path.join(root, "manifest.json")
        try:
            with open(mpath) as f:
                self.manifest = json.load(f)
        except OSError as e:
            raise ShardError(f"no shard manifest at {mpath!r}: {e}") from e
        except ValueError as e:
            raise ShardCorruptError(
                f"shard manifest {mpath!r} is not valid JSON: {e}",
                path=mpath) from e
        self.shards = list(self.manifest.get("shards", []))
        if not self.shards:
            raise ShardError(f"shard set {root!r} lists no shards")
        counts = [int(s["records"]) for s in self.shards]
        # global record index == ORIGINAL stream position: pack writes
        # round-robin, so sample g lives at (shard g % S, local g // S);
        # "concat" layout (externally-built sets) falls back to cumsum
        self.layout = self.manifest.get("layout", "concat")
        self._counts = counts
        self._cum = np.concatenate([[0], np.cumsum(counts)])
        self._readers: Dict[int, ShardReader] = {}
        #: injectable per-read delay — the chaos.slow_shard hook
        self._read_delay = 0.0

    def __len__(self) -> int:
        return int(self._cum[-1])

    def shard_path(self, i: int) -> str:
        return os.path.join(self.root, self.shards[i]["file"])

    def _reader(self, i: int) -> ShardReader:
        r = self._readers.get(i)
        if r is None:
            r = self._readers[i] = ShardReader(self.shard_path(i))
            if len(r) != int(self.shards[i]["records"]):
                raise ShardCorruptError(
                    f"shard {r.path!r}: index holds {len(r)} records, "
                    f"manifest says {self.shards[i]['records']}",
                    path=r.path)
        return r

    def locate(self, g: int) -> tuple:
        """Global record index (= original stream position for
        round-robin-packed sets) -> (shard_index, local_index)."""
        if not 0 <= g < len(self):
            raise IndexError(f"global record {g} out of range "
                             f"({len(self)} records)")
        if self.layout == "round_robin":
            n = len(self.shards)
            return g % n, g // n
        s = int(np.searchsorted(self._cum, g, side="right")) - 1
        return s, g - int(self._cum[s])

    def read(self, g: int) -> Any:
        if self._read_delay:
            time.sleep(self._read_delay)
        s, i = self.locate(g)
        return self._reader(s).read(i)

    def close(self) -> None:
        for r in self._readers.values():
            r.close()
        self._readers.clear()

    def validate(self) -> Dict[str, Any]:
        """Full verification (``python -m paddle_tpu_torch data verify``):
        whole-file CRCs against the manifest, then every record's own
        CRC through a real decode.  Raises the FIRST failure as a typed
        :class:`ShardCorruptError` naming shard file and record index;
        returns a summary dict on success."""
        total_bytes = 0
        for i, entry in enumerate(self.shards):
            path = self.shard_path(i)
            crc = 0
            try:
                with open(path, "rb") as f:
                    for chunk in iter(lambda: f.read(1 << 20), b""):
                        crc = zlib.crc32(chunk, crc)
                size = os.path.getsize(path)
            except OSError as e:
                raise ShardError(f"shard {path!r}: unreadable: {e}") from e
            if size != int(entry["bytes"]) or crc != int(entry["crc32"]):
                raise ShardCorruptError(
                    f"shard {path!r}: file CRC/size mismatch vs manifest "
                    f"(bytes {size} vs {entry['bytes']})", path=path)
            reader = self._reader(i)
            for j in range(len(reader)):
                reader.read(j)
            total_bytes += size
        return {"shards": len(self.shards), "records": len(self),
                "bytes": total_bytes}


def write_shard_set(out_dir: str, reader: Callable[[], Iterator[Any]], *,
                    num_shards: Optional[int] = None,
                    limit: Optional[int] = None,
                    meta: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The ``pack`` step: drain ``reader()`` (any paddle_tpu_torch.data reader
    creator — samples, not batches) round-robin into ``num_shards``
    indexed shard files and publish the set ATOMICALLY (temp dir + fsync
    + rename, the checkpoint_io discipline): ``out_dir`` either holds a
    complete valid set or does not exist.  Returns the manifest."""
    from paddle_tpu_torch.utils.flags import FLAGS

    n = int(num_shards or FLAGS.data_shards)
    if n < 1:
        raise ValueError(f"num_shards must be >= 1, got {n}")
    if os.path.exists(out_dir):
        # fail in milliseconds, not after draining the whole reader (the
        # same check guards the publish rename against a concurrent pack)
        raise ShardError(f"shard set {out_dir!r} already exists — "
                         f"refusing to overwrite")
    parent = os.path.dirname(os.path.abspath(out_dir)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, _TMP_PREFIX + os.path.basename(out_dir)
                       + "-" + uuid.uuid4().hex[:8])
    os.makedirs(tmp)
    writers = [ShardWriter(os.path.join(tmp, shard_name(i, n)))
               for i in range(n)]
    count = 0
    try:
        for sample in reader():
            writers[count % n].append(sample)
            count += 1
            if limit is not None and count >= limit:
                break
        entries = [w.close() for w in writers]
        writers = []
        manifest = {
            "version": SHARD_VERSION,
            "num_records": count,
            "layout": "round_robin",
            "wall_time": time.time(),
            "shards": entries,
            "meta": dict(meta or {}),
        }
        mpath = os.path.join(tmp, "manifest.json")
        with open(mpath, "w") as f:
            json.dump(manifest, f, indent=1, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        # fsync the directory so the rename below lands durably
        dfd = os.open(tmp, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
        if os.path.exists(out_dir):
            raise ShardError(f"shard set {out_dir!r} already exists — "
                             f"refusing to overwrite")
        os.replace(tmp, out_dir)
    except Exception:
        for w in writers:
            try:
                w.close()
            except Exception:
                pass
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
        raise
    logger.info("packed %d record(s) into %d shard(s) at %s",
                count, n, out_dir)
    return manifest
