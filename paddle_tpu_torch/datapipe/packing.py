"""Sequence packing — multiple short sequences share one padded row
(docs/data.md "Sequence packing"; ``--data_pack``).

The bucketed feeder bounds pad waste per batch, but a pad-heavy
workload (IMDB-style length distributions) still burns most of the
``[B, T]`` grid on dead tokens — the exact waste keeping the textclf /
LSTM bench rows MFU-starved (ROADMAP item 3).  Packing fills each row
with several whole sequences back-to-back and plumbs the segment
structure through the graph:

- the packed seq slot feeds a 5-tuple ``(ids [B,T], lengths [B],
  seg_ids [B,T], positions [B,T], seg_lengths [B,S])`` —
  ``nn.graph._coerce_feed`` turns it into a sequence ``Act`` carrying
  the pack state;
- recurrent layers RESET their carry at segment starts (direction-aware
  — ``ops.segment_starts``), pooling/last/first become per-SEGMENT
  reductions returning a sequence over the segment axis, and the
  sequence losses then reduce over valid segments — so the packed batch
  computes exactly the per-sample math of the unpacked one (the
  bit-parity oracle in tests/test_datapipe.py);
- per-sample slots (the label) feed as ``[B, S]``.

The packer is greedy-in-order (first sequence that does not fit closes
the row): deterministic, order-preserving, and O(1) state — it composes
with the checkpointable ``ShardSource`` cursor.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, \
    Tuple

import numpy as np

from paddle_tpu_torch.data.feeder import DataFeeder, bucket_length, note_padding
from paddle_tpu_torch.utils.error import ConfigError

__all__ = ["pack_samples", "pack_reader", "PackedDataFeeder", "auto_pack",
           "DEFAULT_PACK_LEN", "DEFAULT_PACK_SEGMENTS"]

DEFAULT_PACK_LEN = 256
DEFAULT_PACK_SEGMENTS = 8

#: a packed row: the sequences it holds (in arrival order) and, per
#: segment, the sample's remaining slots (original tuple minus the seq)
PackedRow = Tuple[List[List[int]], List[Tuple]]


def pack_reader(reader: Callable[[], Iterator[Tuple]], *, max_len: int,
                max_segments: int = DEFAULT_PACK_SEGMENTS,
                seq_slot: int = 0) -> Callable[[], Iterator[PackedRow]]:
    """Greedy in-order streaming packer: walk the samples once, appending
    each to the open row until its tokens would overflow ``max_len`` or
    the row already holds ``max_segments`` segments — then the row
    closes.  A single sequence longer than ``max_len`` is truncated to
    it (the feeder ``max_len`` semantics).  Deterministic and
    order-preserving: the concatenation of all segments equals the input
    sample order."""
    if max_len < 1 or max_segments < 1:
        raise ValueError("max_len and max_segments must be >= 1")

    def creator() -> Iterator[PackedRow]:
        seqs: List[List[int]] = []
        rest: List[Tuple] = []
        used = 0
        for sample in reader():
            seq = list(sample[seq_slot])[:max_len]
            other = tuple(v for i, v in enumerate(sample) if i != seq_slot)
            if seqs and (used + len(seq) > max_len
                         or len(seqs) >= max_segments):
                yield seqs, rest
                seqs, rest, used = [], [], 0
            seqs.append(seq)
            rest.append(other)
            used += len(seq)
        if seqs:
            yield seqs, rest

    return creator


def pack_samples(samples: Sequence[Tuple], *, max_len: int,
                 max_segments: int = DEFAULT_PACK_SEGMENTS,
                 seq_slot: int = 0) -> List[PackedRow]:
    """List form of :func:`pack_reader` — ONE packing policy, two call
    shapes (the streamed and listed packers can never disagree)."""
    return list(pack_reader(lambda: iter(samples), max_len=max_len,
                            max_segments=max_segments,
                            seq_slot=seq_slot)())


class PackedDataFeeder:
    """Packed rows -> feed dicts (the packed half of ``DataFeeder``).

    ``types`` uses the DataFeeder kinds with exactly ONE ``ids_seq``
    slot (the packed axis); every other slot must be per-sample
    ``int`` (fed ``[B, S]``) or ``dense`` (fed ``[B, S, D]``).  The seq
    slot feeds the packed 5-tuple; ``S`` is the static
    ``max_segments`` so the step sees one shape per (T-bucket) regardless of
    how full each row is."""

    def __init__(self, types: Dict[str, str],
                 feeding: Optional[Dict[str, int]] = None, *,
                 max_segments: int = DEFAULT_PACK_SEGMENTS,
                 buckets: Sequence[int] = None,
                 dtype: str = "float32") -> None:
        from paddle_tpu_torch.data.feeder import _DEFAULT_BUCKETS

        self.types = dict(types)
        self.feeding = feeding or {n: i for i, n in enumerate(types)}
        self.max_segments = int(max_segments)
        self.buckets = tuple(buckets or _DEFAULT_BUCKETS)
        self.dtype = dtype
        seq = [n for n, k in types.items() if k in ("ids_seq", "dense_seq")]
        if len(seq) != 1 or types[seq[0]] != "ids_seq":
            raise ConfigError(
                f"PackedDataFeeder needs exactly one 'ids_seq' slot to "
                f"pack, got {types}")
        self.seq_name = seq[0]
        for n, k in types.items():
            if n != self.seq_name and k not in ("int", "dense"):
                raise ConfigError(
                    f"PackedDataFeeder slot {n!r}: kind {k!r} is not "
                    f"packable (per-sample slots must be 'int' or "
                    f"'dense')")
        # per-sample slot order: feeding indices minus the seq slot,
        # re-based to the packed row's ``rest`` tuples
        seq_idx = self.feeding[self.seq_name]
        self._rest_index = {
            n: (i if i < seq_idx else i - 1)
            for n, i in self.feeding.items() if n != self.seq_name}
        #: cumulative pad accounting (shares the registry gauges with
        #: DataFeeder — the packed-vs-bucketed A/B reads one metric)
        self.tokens_real = 0
        self.tokens_padded = 0

    @classmethod
    def from_feeder(cls, feeder: DataFeeder, *,
                    max_segments: int = DEFAULT_PACK_SEGMENTS
                    ) -> "PackedDataFeeder":
        return cls(feeder.types, feeder.feeding,
                   max_segments=max_segments, buckets=feeder.buckets,
                   dtype=feeder.dtype)

    @property
    def pad_waste(self) -> float:
        """Cumulative padded-but-dead token fraction."""
        if not self.tokens_padded:
            return 0.0
        return 1.0 - self.tokens_real / self.tokens_padded

    def __call__(self, rows: List[PackedRow]) -> Dict[str, Any]:
        B, S = len(rows), self.max_segments
        tok = 1
        for seqs, rest in rows:
            if len(seqs) > S:
                raise ConfigError(
                    f"packed row holds {len(seqs)} segments but "
                    f"max_segments={S} — pack and feed must agree")
            tok = max(tok, sum(len(s) for s in seqs))
        T = bucket_length(tok, self.buckets)
        ids = np.zeros((B, T), np.int32)
        seg_ids = np.full((B, T), -1, np.int32)
        positions = np.zeros((B, T), np.int32)
        lengths = np.zeros((B,), np.int32)
        seg_lengths = np.zeros((B, S), np.int32)
        for b, (seqs, rest) in enumerate(rows):
            t = 0
            for s, seq in enumerate(seqs):
                L = len(seq)
                ids[b, t:t + L] = seq
                seg_ids[b, t:t + L] = s
                positions[b, t:t + L] = np.arange(L, dtype=np.int32)
                seg_lengths[b, s] = L
                t += L
            lengths[b] = t
        self.tokens_real += int(lengths.sum())
        self.tokens_padded += B * T
        note_padding(int(lengths.sum()), B * T, T,
                     waste=self.pad_waste)
        feed: Dict[str, Any] = {
            self.seq_name: (ids, lengths, seg_ids, positions, seg_lengths)}
        for name, kind in self.types.items():
            if name == self.seq_name:
                continue
            ri = self._rest_index[name]
            if kind == "int":
                out = np.zeros((B, S), np.int32)
                for b, (seqs, rest) in enumerate(rows):
                    for s, other in enumerate(rest):
                        v = other[ri]
                        out[b, s] = int(v[0] if isinstance(
                            v, (list, tuple, np.ndarray)) else v)
            else:  # dense
                D = None
                for seqs, rest in rows:
                    if rest:
                        D = len(np.atleast_1d(rest[0][ri]))
                        break
                out = np.zeros((B, S, D or 1), self.dtype)
                for b, (seqs, rest) in enumerate(rows):
                    for s, other in enumerate(rest):
                        out[b, s] = np.asarray(other[ri], self.dtype)
            feed[name] = out
        return feed


def auto_pack(reader: Callable, feeder: DataFeeder, *,
              batch_size: Optional[int] = None,
              max_len: Optional[int] = None,
              max_segments: int = DEFAULT_PACK_SEGMENTS
              ) -> Tuple[Callable, PackedDataFeeder]:
    """The ``--data_pack`` wiring (CLI train job): re-plumb a
    batch-reader + DataFeeder pair into the packed pipeline.  The
    incoming reader's batches are flattened back to samples, packed,
    and re-batched at ``batch_size`` ROWS — default: the source batch
    size (a cursor source's ``batch_size`` attribute, else peeked from
    a fresh ``reader()`` call — safe for the repo's re-invocable reader
    creators; a stateful source without the attribute should pass
    ``batch_size`` explicitly), so a packed step keeps the same row
    count and processes >= as many SAMPLES per batch.  ``max_len``
    defaults to the feeder's own truncation cap when it has one (packed
    and bucketed training must truncate identically), else
    ``DEFAULT_PACK_LEN`` — packing always needs a finite row budget."""
    from paddle_tpu_torch.utils.log import logger

    pf = PackedDataFeeder.from_feeder(feeder, max_segments=max_segments)
    seq_idx = feeder.feeding[pf.seq_name]
    if max_len is None:
        cap = getattr(feeder, "max_len", None)
        max_len = int(cap or DEFAULT_PACK_LEN)
        if not cap:
            # the bucketed path fed uncapped sequences whole; packing
            # needs a finite row budget — make the new truncation loud
            logger.warning(
                "--data_pack: the feeder has no max_len — sequences "
                "longer than %d tokens will be TRUNCATED to the packed "
                "row budget (pass max_len= to auto_pack, or set the "
                "feeder's max_len, to choose the cap)", max_len)
    if batch_size is None:
        # a checkpointable source advances its cursor when iterated — read
        # its declared batch size instead of consuming a batch
        batch_size = getattr(reader, "batch_size", None)
    if batch_size is None:
        try:
            batch_size = len(next(iter(reader())))
        except StopIteration:
            batch_size = 64
    bs = int(batch_size)

    def sample_stream() -> Iterator[Tuple]:
        for batch in reader():
            for sample in batch:
                yield sample

    packed = pack_reader(sample_stream, max_len=max_len,
                         max_segments=max_segments, seq_slot=seq_idx)

    def creator():
        rows: List[PackedRow] = []
        for row in packed():
            rows.append(row)
            if len(rows) >= bs:
                yield rows
                rows = []
        if rows:
            yield rows

    return creator, pf
