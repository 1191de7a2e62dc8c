"""DataFeeder: python samples -> padded numpy arrays — counterpart of
``paddle_tpu/data/feeder.py``.

Analog of the reference's DataProviderConverter / py_paddle feeder
(py_paddle/dataprovider_converter.py): converts a minibatch of python rows
into the feed dict ``Topology.apply`` expects.  Sequences are padded to a
*bucketed* max length so a run sees a small, finite set of shapes.  The
feeder stays on the host (numpy); ``SGDTrainer`` moves each prepared batch
to its device once.

``BatchPrefetcher`` (``--prefetch_depth``) runs the feeder and the
host-to-device copy of the next batches in a background thread while the
device steps the current one.  On the card the copy runs on a side CUDA
stream from pinned host memory; the consumer's stream waits on the
batch's event, and ``record_stream`` tells the caching allocator that the
consumer's stream uses the batch.

An ``ids_seq`` column is padded by the native C++ core
(``data/native.py``, ``ptd_pad_batch_i32``) when its library loads, else by
the Python loop beside it; both give the same arrays.
"""

from __future__ import annotations

import contextlib
import queue
import threading
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np

from paddle_tpu_torch.utils.log import logger

__all__ = ["DataFeeder", "bucket_length", "feeder_kind_for_layer",
           "PreparedFeed", "PrepareError", "BatchPrefetcher", "note_padding"]

_DEFAULT_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024)


def bucket_length(n: int, buckets: Sequence[int] = _DEFAULT_BUCKETS) -> int:
    """Smallest bucket >= n (n itself past the largest bucket)."""
    for b in buckets:
        if n <= b:
            return b
    return n


# per-bucket cumulative (real, padded) token totals behind the
# ``data_bucket_occupancy`` gauge — process-wide like the registry itself
_BUCKET_TOTALS: Dict[int, List[int]] = {}
_BUCKET_LOCK = threading.Lock()


def note_padding(real: int, padded: int, bucket: int, *,
                 waste: float) -> None:
    """Record one padded batch on the pad-waste gauges of the port's
    registry: ``data_pad_waste`` (the cumulative padded-but-dead token
    fraction) and per-bucket ``data_bucket_occupancy`` (how full the rows
    landing in each T-bucket are).  Host-side only."""
    from paddle_tpu_torch.obs import get_registry

    reg = get_registry()
    reg.gauge("data_pad_waste",
              "cumulative padded-but-dead token fraction").set(waste)
    with _BUCKET_LOCK:
        tot = _BUCKET_TOTALS.setdefault(int(bucket), [0, 0])
        tot[0] += int(real)
        tot[1] += int(padded)
        occ = tot[0] / max(tot[1], 1)
    reg.gauge("data_bucket_occupancy",
              "real-token fraction of batches padded to this T bucket",
              labels=("bucket",), bucket=int(bucket)).set(occ)


def feeder_kind_for_layer(layer) -> str:
    """Derive the feeder slot kind for a data LayerOutput — the single
    mapping from data_spec (or a v2 input type in ``meta``) to DataFeeder
    kinds."""
    t = layer.meta.get("v2_type")
    if t is not None:
        return t.feeder_kind
    spec = layer.data_spec or {}
    if spec.get("sparse") == "binary":
        return "sparse_ids_seq" if spec.get("is_seq") else "sparse_ids"
    if spec.get("sparse") == "float":
        return "sparse_pairs_seq" if spec.get("is_seq") else "sparse_pairs"
    is_int = spec.get("dtype") == "int32"
    if spec.get("nested"):
        return "ids_nested" if is_int else "dense_nested"
    if spec.get("is_seq"):
        return "ids_seq" if is_int else "dense_seq"
    return "int" if is_int else "dense"


class PrepareError(Exception):
    """A batch failed in the prefetcher's ``prepare`` (DataFeeder) or
    ``transfer`` (host-to-device) stage, not in the reader.  Raised at the
    consumer's ``next()`` with the original exception as ``__cause__``;
    the trainer unwraps it so a feeder bug keeps its own type instead of
    being attributed to the reading tier as a ``ReaderError``."""


class PreparedFeed:
    """Marker wrapper for a batch the ``BatchPrefetcher`` has already
    pushed through the feeder (and the host-to-device copy, when it has a
    ``transfer``): the trainer consumes ``.feed`` directly."""

    __slots__ = ("feed",)

    def __init__(self, feed: Any) -> None:
        self.feed = feed


def _tensors(tree: Any) -> Iterator[Any]:
    """The tensors of a feed: a dict of tensors or tuples of them."""
    import torch

    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


class BatchPrefetcher:
    """Double-buffered async feeding (``--prefetch_depth``).

    Wraps a raw batch iterator: a background thread pulls batches
    N+1..N+depth, runs ``prepare`` (the DataFeeder) and ``transfer`` (the
    host-to-device copy) on them, and parks the results in a bounded
    queue while the device steps batch N.  Loop-equivalent to serial
    feeding:

    - order is preserved (one producer, a FIFO queue);
    - a reader exception is re-raised at the consumer's ``next()`` as it
      was raised; a ``prepare``/``transfer`` failure as ``PrepareError``
      with the original as its cause;
    - the queue bounds read-ahead: at most ``depth`` prepared batches (and
      the one in flight) exist, so a preemption at a batch boundary
      abandons a bounded amount of work, and the resume point (the
      batches the step consumed) stays batch-exact;
    - ``close()`` stops the producer and joins it.

    With a CUDA ``device`` the producer runs ``transfer`` on a side stream
    of that device (the current device is per thread, so it is set in the
    producer) under ``torch.no_grad()``, and records an event after the
    copies; ``next()`` makes the consumer's current stream wait on that
    event and calls ``record_stream`` on every tensor of the feed, so the
    caching allocator does not hand the memory to another tensor before
    the consumer's stream is done with it."""

    _DONE = object()

    def __init__(self, it: Iterator, *, prepare: Optional[Callable] = None,
                 transfer: Optional[Callable] = None, depth: int = 2,
                 device: Any = None) -> None:
        import torch

        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, int(depth)))
        self._stop = threading.Event()
        self._prepare = prepare
        self._transfer = transfer
        dev = None if device is None else torch.device(device)
        self._cuda = dev if dev is not None and dev.type == "cuda" else None
        self._thread = threading.Thread(
            target=self._run, args=(it,), name="batch-prefetch", daemon=True)
        self._thread.start()

    def _put(self, item: Any) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _copy(self, feed: Any, stream) -> Tuple[Any, Any]:
        """``transfer(feed)`` on ``stream`` (None off the card) ->
        (feed, the event its copies end at or None)."""
        import torch

        if stream is None:
            return self._transfer(feed), None
        with torch.cuda.stream(stream):
            out = self._transfer(feed)
            ready = torch.cuda.Event()
            ready.record(stream)
        return out, ready

    def _run(self, it: Iterator) -> None:
        import torch

        try:
            with torch.no_grad(), (torch.cuda.device(self._cuda)
                                   if self._cuda is not None
                                   else contextlib.nullcontext()):
                stream = (torch.cuda.Stream(self._cuda)
                          if self._cuda is not None
                          and self._transfer is not None else None)
                for raw in it:
                    if self._stop.is_set():
                        return
                    try:
                        feed = self._prepare(raw) if self._prepare else raw
                        ready = None
                        if self._transfer is not None:
                            feed, ready = self._copy(feed, stream)
                    except BaseException as e:
                        # prepare/h2d failures keep their own identity: the
                        # reader did not raise (see PrepareError)
                        raise PrepareError(
                            f"batch prepare/transfer failed: "
                            f"{type(e).__name__}: {e}") from e
                    if not self._put((PreparedFeed(feed), ready)):
                        return
                self._put(self._DONE)
        except BaseException as e:  # noqa: BLE001 — delivered to consumer
            self._put(e)

    def __iter__(self) -> "BatchPrefetcher":
        return self

    def __next__(self) -> PreparedFeed:
        item = self._q.get()
        if item is self._DONE:
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        prepared, ready = item
        if ready is not None:
            import torch

            consumer = torch.cuda.current_stream(self._cuda)
            consumer.wait_event(ready)
            for t in _tensors(prepared.feed):
                if t.device.type == "cuda":
                    t.record_stream(consumer)
        return prepared

    def close(self) -> None:
        """Stop the producer and join it; pending prepared batches are
        dropped (the consumer's batch count, not the read-ahead, is the
        resume point)."""
        self._stop.set()
        while True:  # unblock a producer stuck in put()
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)


class DataFeeder:
    """feeding: {data_layer_name: slot_index}; types: {name: kind} with kind
    in 'dense' | 'int' | 'ids_seq' | 'dense_seq', the sparse kinds and the
    nested 'ids_nested' | 'dense_nested' (-> (value, outer_lengths,
    sub_lengths)); ``datapipe.PackedDataFeeder`` is its packed half.
    Returns numpy arrays: the trainer moves each batch to its device
    once."""

    def __init__(
        self,
        types: Dict[str, str],
        feeding: Optional[Dict[str, int]] = None,
        *,
        buckets: Sequence[int] = _DEFAULT_BUCKETS,
        max_len: Optional[int] = None,
        max_nnz: Optional[int] = None,
        dtype: str = "float32",
    ) -> None:
        self.types = types
        self.feeding = feeding or {name: i for i, name in enumerate(types)}
        self.buckets = tuple(buckets)
        self.max_len = max_len
        # per-timestep feature-bag cap for sparse *sequence* slots — a
        # separate axis from max_len (which caps TIMESTEPS): reusing
        # max_len as the bag cap silently truncated bags whenever
        # sequences were capped.  None = bags never truncated (the nnz
        # width just buckets up).
        self.max_nnz = max_nnz
        self.dtype = dtype
        #: running count of sparse features dropped by max_len/max_nnz
        #: truncation (logged whenever a batch drops any).  Surfaced as an
        #: observable, not just a log line: the trainer mirrors it into
        #: ``_last_extras['dropped_features']`` each batch, and a serving
        #: process that ``attach_feeder()``s reports it in ``healthz()``.
        self.dropped_features = 0
        #: cumulative real/padded token totals over every padded seq slot
        #: — behind the ``data_pad_waste`` gauge (see ``note_padding``)
        self.tokens_real = 0
        self.tokens_padded = 0

    @property
    def pad_waste(self) -> float:
        """Cumulative padded-but-dead token fraction across every padded
        sequence slot this feeder has produced."""
        if not self.tokens_padded:
            return 0.0
        return 1.0 - self.tokens_real / self.tokens_padded

    def __call__(self, batch_rows: List[Tuple]) -> Dict[str, Any]:
        feed: Dict[str, Any] = {}
        for name, kind in self.types.items():
            idx = self.feeding.get(name)
            if idx is None:
                raise ValueError(
                    f"slot {name!r} is missing from the feeding map "
                    f"{self.feeding} — every typed slot needs a field "
                    f"index")
            try:
                col = [row[idx] for row in batch_rows]
            except (IndexError, KeyError) as e:
                raise ValueError(
                    f"input rows do not carry slot {name!r} (field index "
                    f"{idx}): a row has too few fields — feeding map is "
                    f"{self.feeding}") from e
            if kind == "dense":
                feed[name] = np.asarray(col, self.dtype)
            elif kind == "int":
                arr = np.asarray(col, np.int32)
                if arr.ndim == 1:
                    arr = arr[:, None]
                feed[name] = arr
            elif kind in ("ids_seq", "dense_seq"):
                feed[name] = self._pad_seq(col, kind)
            elif kind in ("sparse_ids", "sparse_pairs"):
                feed[name] = self._pad_sparse(col, kind)
            elif kind in ("sparse_ids_seq", "sparse_pairs_seq"):
                feed[name] = self._pad_sparse_seq(col, kind)
            elif kind in ("ids_nested", "dense_nested"):
                feed[name] = self._pad_nested(col, kind)
            else:
                raise ValueError(f"unknown slot kind {kind!r} for {name!r}")
        return feed

    def _pad_nested(self, col: List, kind: str):
        """Nested sequences (rows are lists of sub-sequences; the
        subSequenceStartPositions analog, Argument.h:90) -> padded
        (value [B, To, Ti(, D)], outer_lengths [B], sub_lengths [B, To])."""
        outer = np.asarray([len(s) for s in col], np.int32)
        n_outer = max(int(outer.max()) if len(outer) else 1, 1)
        ti_max = max((len(sub) for row in col for sub in row), default=1)
        if self.max_len:  # cap BOTH levels, like the flat _pad_seq path
            n_outer = min(n_outer, self.max_len)
            ti_max = min(max(ti_max, 1), self.max_len)
            outer = np.minimum(outer, self.max_len)
        To = bucket_length(n_outer, self.buckets)
        Ti = bucket_length(max(ti_max, 1), self.buckets)
        # buckets round To/Ti UP, so slice to the max_len caps themselves —
        # data beyond the cap must not survive (mirrors _pad_seq's lengths[i])
        row_cap = min(To, self.max_len) if self.max_len else To
        ti_cap = min(Ti, self.max_len) if self.max_len else Ti
        sub_lengths = np.zeros((len(col), To), np.int32)
        if kind == "ids_nested":
            out = np.zeros((len(col), To, Ti), np.int32)
            for i, row in enumerate(col):
                for j, sub in enumerate(list(row)[:row_cap]):
                    sub = list(sub)[:ti_cap]
                    out[i, j, : len(sub)] = sub
                    sub_lengths[i, j] = len(sub)
        else:
            D = next((len(sub[0]) for row in col for sub in row if len(sub)), 1)
            out = np.zeros((len(col), To, Ti, D), self.dtype)
            for i, row in enumerate(col):
                for j, sub in enumerate(list(row)[:row_cap]):
                    sub = np.asarray(sub, self.dtype).reshape(-1, D)[:ti_cap]
                    out[i, j, : len(sub)] = sub
                    sub_lengths[i, j] = len(sub)
        return out, outer, sub_lengths

    def _pad_sparse(self, col: List, kind: str):
        """Sparse rows -> padded COO: 'sparse_ids' rows are id lists
        (sparse_binary_vector), 'sparse_pairs' rows are (id, weight) lists
        (sparse_float_vector).  Returns (ids, nnz) or (ids, weights, nnz)
        with the nnz width bucketed like sequence lengths."""
        nnz = np.asarray([len(s) for s in col], np.int32)
        N = int(nnz.max()) if len(nnz) else 1
        if self.max_len:
            N = min(max(N, 1), self.max_len)
            nnz = np.minimum(nnz, self.max_len)
        N = bucket_length(max(N, 1), self.buckets)
        ids = np.zeros((len(col), N), np.int32)
        if kind == "sparse_ids":
            for i, s in enumerate(col):
                s = list(s)[: nnz[i]]
                ids[i, : len(s)] = s
            return ids, nnz
        weights = np.zeros((len(col), N), self.dtype)
        for i, s in enumerate(col):
            s = list(s)[: nnz[i]]
            for j, (idx, w) in enumerate(s):
                ids[i, j] = idx
                weights[i, j] = w
        return ids, weights, nnz

    def _pad_sparse_seq(self, col: List, kind: str):
        """Sparse *sequence* rows (one sparse bag per timestep, the
        reference's sparse_*_vector_sequence input types) -> padded
        (ids [B,T,N], nnz [B,T], lengths [B]) for 'sparse_ids_seq', with an
        extra weights [B,T,N] slot before nnz for 'sparse_pairs_seq'.  T and
        N are bucketed like sequence lengths; the bag width N is capped by
        ``max_nnz`` (NOT ``max_len`` — that caps timesteps), and any
        features dropped by either cap are counted in
        ``self.dropped_features`` and logged."""
        lengths = np.asarray([len(s) for s in col], np.int32)
        T = max(int(lengths.max()) if len(lengths) else 1, 1)
        if self.max_len:
            T = min(T, self.max_len)
            lengths = np.minimum(lengths, self.max_len)
        # width over SURVIVING timesteps only: a wide bag in a timestep
        # max_len discards must not inflate the padded feed shape
        n_max = max((len(bag) for i, row in enumerate(col)
                     for bag in list(row)[: lengths[i]]), default=1)
        if self.max_nnz:
            n_max = min(max(n_max, 1), self.max_nnz)
        T = bucket_length(T, self.buckets)
        N = bucket_length(max(n_max, 1), self.buckets)
        # buckets round N UP; the hard bag cap stays max_nnz itself
        cap = min(N, self.max_nnz) if self.max_nnz else N
        B = len(col)
        ids = np.zeros((B, T, N), np.int32)
        nnz = np.zeros((B, T), np.int32)
        dropped = 0
        weights = (np.zeros((B, T, N), self.dtype)
                   if kind != "sparse_ids_seq" else None)
        for i, row in enumerate(col):
            row = list(row)
            for t, bag in enumerate(row):
                bag = list(bag)
                if t >= lengths[i]:  # timestep beyond the max_len cap
                    dropped += len(bag)
                    continue
                if len(bag) > cap:
                    dropped += len(bag) - cap
                    bag = bag[:cap]
                if weights is None:
                    ids[i, t, : len(bag)] = bag
                else:
                    for j, (idx, w) in enumerate(bag):
                        ids[i, t, j] = idx
                        weights[i, t, j] = w
                nnz[i, t] = len(bag)
        if dropped:
            self.dropped_features += dropped
            logger.warning(
                "DataFeeder: dropped %d sparse feature(s) this batch "
                "(max_len=%s, max_nnz=%s; %d dropped total)",
                dropped, self.max_len, self.max_nnz, self.dropped_features)
        if weights is None:
            return ids, nnz, lengths
        return ids, weights, nnz, lengths

    def _pad_seq(self, col: List, kind: str) -> Tuple[np.ndarray, np.ndarray]:
        lengths = np.asarray([len(s) for s in col], np.int32)
        T = int(lengths.max()) if len(lengths) else 1
        T = max(T, 1)
        if self.max_len:
            T = min(max(T, 1), self.max_len)
            lengths = np.minimum(lengths, self.max_len)
        T = bucket_length(T, self.buckets)
        self.tokens_real += int(lengths.sum())
        self.tokens_padded += len(col) * T
        note_padding(int(lengths.sum()), len(col) * T, T,
                     waste=self.pad_waste)
        if kind == "ids_seq":
            from paddle_tpu_torch.data import native

            if native.native_available():
                # the C++ pad core: the per-batch Python loop is host time
                # taken from the input pipeline; only rows past the max_len
                # cap are cut (the core clips at T, which may exceed it)
                out, _ = native.pad_batch_i32(
                    [s if len(s) <= L else s[:L]
                     for s, L in zip(col, lengths.tolist())], T)
                return out, lengths
            out = np.zeros((len(col), T), np.int32)
            for i, s in enumerate(col):
                s = list(s)[: lengths[i]]
                out[i, : len(s)] = s
        else:
            D = len(col[0][0])
            out = np.zeros((len(col), T, D), self.dtype)
            for i, s in enumerate(col):
                s = np.asarray(s, self.dtype)[: lengths[i]]
                out[i, : len(s)] = s
        return out, lengths
