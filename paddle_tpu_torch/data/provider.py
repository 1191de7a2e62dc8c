"""PyDataProvider2 ``@provider`` protocol facade — counterpart of
``paddle_tpu/data/provider.py``.

The reference's primary data interface is a decorated per-file sample
generator (reference: python/paddle/trainer/PyDataProvider2.py:318
``provider(input_types, init_hook, cache, should_shuffle, ...)`` consumed by
paddle/gserver/dataproviders/PyDataProvider2.cpp:195-212).  This module
reproduces that protocol ON TOP of this framework's reader/feeder stack: the
decorated function becomes a factory returning a ``DataProvider`` whose
``.reader()`` plugs into ``data.batch``/``SGDTrainer`` and whose
``.feeder()`` is the matching ``DataFeeder`` (whose ``ids_seq`` columns
take the native pad core, ``data/native.py``).

Supported surface: ``input_types`` as list or dict (dict keys name the data
layers and let the generator yield dicts), ``init_hook(settings, file_list,
**kwargs)`` with a free-attribute ``settings`` object, ``should_shuffle`` +
``pool_size`` (buffered-pool shuffle), ``cache=CacheType.CACHE_PASS_IN_MEM``
(first pass materialized, later passes replay), ``check`` (light per-slot
validation, ``check_fail_continue`` to skip bad rows), ``calc_batch_size`` +
``can_over_batch_size`` (cost-based batch assembly via
``DataProvider.batch_reader`` — the PyDataProvider2.cpp:565-586 semantics),
and sparse SEQUENCE slots (``sparse_*_vector_sequence`` / ``seq_type=
SequenceType.SEQUENCE``).  Sparse SUB-sequence slots are the one un-mapped
corner (no repo layer consumes nested sparse; the ctors raise).

Shuffling draws from an explicit ``random.Random`` (``provider(rng=)``,
or ``DataProvider.rng``), never from the module-level ``random``: the
reference shuffles with the global stream, and ``random.Random(seed)``
draws the same sequence as ``random.seed(seed)`` followed by the global
calls, so a seeded run of either package gives the same order.
"""

from __future__ import annotations

import functools
import random as _random
from typing import Any, Callable, List, Optional

from paddle_tpu_torch.data import input_types as _it
from paddle_tpu_torch.data.feeder import DataFeeder
from paddle_tpu_torch.data.input_types import InputType
from paddle_tpu_torch.utils.error import ConfigError
from paddle_tpu_torch.utils.log import logger

__all__ = [
    "provider", "CacheType", "SequenceType", "InputType",
    "dense_vector", "dense_vector_sequence", "dense_vector_sub_sequence",
    "integer_value", "integer_value_sequence", "integer_value_sub_sequence",
    "integer_sequence", "sparse_binary_vector", "sparse_float_vector",
    "sparse_binary_vector_sequence", "sparse_float_vector_sequence",
    "dense_slot", "index_slot", "sparse_non_value_slot", "sparse_value_slot",
]


class SequenceType:
    NO_SEQUENCE = 0
    SEQUENCE = 1
    SUB_SEQUENCE = 2


class CacheType:
    NO_CACHE = 0
    CACHE_PASS_IN_MEM = 1


# One shared InputType (data/input_types.py) serves both the v2
# data_type facade and this v1 protocol — the reference's v2 types ARE the
# PyDataProvider2 types, so @provider accepts either module's constructors.
# The v1-style *_slot constructors below add the seq_type= keyword shape.

_SEQ_CTORS = {
    "dense": (_it.dense_vector, _it.dense_vector_sequence,
              _it.dense_vector_sub_sequence),
    "index": (_it.integer_value, _it.integer_value_sequence,
              _it.integer_value_sub_sequence),
}


def dense_slot(dim, seq_type=SequenceType.NO_SEQUENCE):
    return _SEQ_CTORS["dense"][seq_type](dim)


def index_slot(value_range, seq_type=SequenceType.NO_SEQUENCE):
    return _SEQ_CTORS["index"][seq_type](value_range)


def sparse_non_value_slot(dim, seq_type=SequenceType.NO_SEQUENCE):
    if seq_type == SequenceType.SUB_SEQUENCE:
        raise ConfigError("sparse sub-sequence slots are not supported "
                          "(reference PyDataProvider2.py:75-145 defines "
                          "them; no repo layer consumes nested sparse)")
    if seq_type == SequenceType.SEQUENCE:
        return _it.sparse_binary_vector_sequence(dim)
    return _it.sparse_binary_vector(dim)


def sparse_value_slot(dim, seq_type=SequenceType.NO_SEQUENCE):
    if seq_type == SequenceType.SUB_SEQUENCE:
        raise ConfigError("sparse sub-sequence slots are not supported "
                          "(see sparse_non_value_slot)")
    if seq_type == SequenceType.SEQUENCE:
        return _it.sparse_float_vector_sequence(dim)
    return _it.sparse_float_vector(dim)


dense_vector = dense_slot
integer_value = index_slot
sparse_binary_vector = sparse_non_value_slot
sparse_float_vector = sparse_value_slot
sparse_binary_vector_sequence = _it.sparse_binary_vector_sequence
sparse_float_vector_sequence = _it.sparse_float_vector_sequence


def dense_vector_sequence(dim):
    return dense_vector(dim, seq_type=SequenceType.SEQUENCE)


def dense_vector_sub_sequence(dim):
    return dense_vector(dim, seq_type=SequenceType.SUB_SEQUENCE)


def integer_value_sequence(value_range):
    return integer_value(value_range, seq_type=SequenceType.SEQUENCE)


def integer_value_sub_sequence(value_range):
    return integer_value(value_range, seq_type=SequenceType.SUB_SEQUENCE)


integer_sequence = integer_value_sequence


class _Settings:
    """Free-attribute settings object handed to init_hook / the generator
    (the reference's ``settings`` parameter)."""

    def __init__(self, **kw):
        self.logger = logger
        for k, v in kw.items():
            setattr(self, k, v)


def _check_row(slot_values, input_types, names):
    for v, it, n in zip(slot_values, input_types, names):
        if it.kind == "int" and not it.seq:
            if not (0 <= int(v) < it.dim):
                raise AssertionError(f"slot {n!r}: index {v} not in "
                                     f"[0, {it.dim})")
        elif it.kind == "dense" and not it.seq:
            if len(v) != it.dim:
                raise AssertionError(f"slot {n!r}: dense len {len(v)} != "
                                     f"{it.dim}")
        elif it.kind == "int" and it.seq:
            if any(not (0 <= int(x) < it.dim) for x in v):
                raise AssertionError(f"slot {n!r}: id out of range")


class DataProvider:
    """The object the decorated function produces — reader + feeder pair."""

    def __init__(self, generator, file_list, input_types, names, *,
                 should_shuffle, pool_size, cache, check,
                 check_fail_continue, settings,
                 rng: Optional[_random.Random] = None):
        self._generator = generator
        self.file_list = list(file_list)
        self.input_types = input_types
        self.slot_names = names
        self.settings = settings
        self.should_shuffle = bool(should_shuffle)
        self.pool_size = pool_size if pool_size and pool_size > 0 else 2048
        self.cache = cache
        self.check = check
        self.check_fail_continue = check_fail_continue
        #: the shuffle's stream (an unseeded one unless given)
        self.rng = rng if rng is not None else _random.Random()
        self.calc_batch_size: Optional[Callable] = None
        self.can_over_batch_size = True
        self._cached_rows: Optional[List[tuple]] = None

    # -- rows ----------------------------------------------------------

    def _iter_rows(self):
        for fname in self.file_list:
            for item in self._generator(self.settings, fname):
                if isinstance(item, dict):
                    row = tuple(item[n] for n in self.slot_names)
                elif isinstance(item, (list, tuple)):
                    row = tuple(item)
                else:
                    row = (item,)  # SingleSlotWrapper behavior
                if len(row) != len(self.input_types):
                    raise ConfigError(
                        f"provider yielded {len(row)} slots, expected "
                        f"{len(self.input_types)}")
                if self.check:
                    try:
                        _check_row(row, self.input_types, self.slot_names)
                    except (AssertionError, TypeError, ValueError) as e:
                        logger.warning("provider row failed check: %s", e)
                        if self.check_fail_continue:
                            continue
                        raise
                yield row

    def reader(self) -> Callable:
        """Reader creator: () -> iterator of slot tuples (data.batch-ready),
        with the protocol's shuffle/cache semantics applied."""

        def read():
            if self.cache == CacheType.CACHE_PASS_IN_MEM:
                if self._cached_rows is None:
                    self._cached_rows = list(self._iter_rows())
                rows: Any = self._cached_rows
                if self.should_shuffle:
                    rows = list(rows)
                    self.rng.shuffle(rows)
                yield from rows
                return
            if self.should_shuffle:
                # buffered-pool shuffle (the reference's pool_size semantics)
                pool: List[tuple] = []
                for row in self._iter_rows():
                    pool.append(row)
                    if len(pool) >= self.pool_size:
                        self.rng.shuffle(pool)
                        yield from pool
                        pool = []
                self.rng.shuffle(pool)
                yield from pool
                return
            yield from self._iter_rows()

        return read

    def feeder(self, **kwargs) -> DataFeeder:
        """DataFeeder matching the declared input types (slot order);
        ``kwargs`` go to ``DataFeeder`` (``max_len``, ``buckets``, ...)."""
        return DataFeeder({n: it.feeder_kind
                           for n, it in zip(self.slot_names,
                                            self.input_types)}, **kwargs)

    def batch_reader(self, batch_size: int, *, drop_last: bool = False):
        """Reader creator yielding BATCHES (lists of rows) assembled by
        sample cost — the reference's calc_batch_size semantics
        (PyDataProvider2.cpp:565-586): each row contributes
        ``calc_batch_size(row)`` units (1 when unset), a batch closes once
        the accumulated units reach ``batch_size``, and with
        ``can_over_batch_size=False`` a row that would overshoot is
        deferred to the next batch instead of included.  A single row
        costing more than ``batch_size`` still forms its own batch (the
        reference would otherwise stall the pool)."""

        def read():
            buf: List[tuple] = []
            bsize = 0
            for row in self.reader()():
                cost = (int(self.calc_batch_size(row))
                        if self.calc_batch_size else 1)
                if (buf and not self.can_over_batch_size
                        and bsize + cost > batch_size):
                    yield buf
                    buf, bsize = [row], cost
                else:
                    buf.append(row)
                    bsize += cost
                if bsize >= batch_size:
                    yield buf
                    buf, bsize = [], 0
            if buf and not drop_last:
                yield buf

        return read


def provider(input_types=None, should_shuffle=None, pool_size=-1,
             min_pool_size=-1, can_over_batch_size=True,
             calc_batch_size=None, cache=CacheType.NO_CACHE, check=False,
             check_fail_continue=False, init_hook=None, rng=None,
             **outer_kwargs):
    """Decorator turning ``process(settings, filename) -> yield sample``
    into a DataProvider factory: ``process(file_list, **kwargs)`` returns a
    :class:`DataProvider`.  ``input_types`` may also be assigned by
    ``init_hook`` onto ``settings.input_types`` (the reference allows both).
    ``rng``: the ``random.Random`` the shuffle draws from (each provider
    made gets its own unseeded one when None)."""

    def wrap(func):
        @functools.wraps(func)
        def create(file_list, **kwargs) -> DataProvider:
            files = ([file_list] if isinstance(file_list, str)
                     else list(file_list))
            settings = _Settings(input_types=input_types, **outer_kwargs)
            if init_hook is not None:
                init_hook(settings, file_list=files, **kwargs)
            its = settings.input_types
            if its is None:
                raise ConfigError(
                    "provider: input_types not given (neither in @provider "
                    "nor set by init_hook on settings)")
            if isinstance(its, dict):
                names = list(its.keys())
                types = [its[n] for n in names]
            else:
                types = list(its)
                names = [f"slot{i}" for i in range(len(types))]
            settings.input_types = types
            if calc_batch_size is not None:
                # cost-based assembly lives in DataProvider.batch_reader;
                # the plain data.batch(dp.reader(), n) path counts rows
                logger.info(
                    "provider: calc_batch_size supplied — batch via "
                    "dp.batch_reader(size) to honor it (data.batch is "
                    "row-based)")
            shuffle = (should_shuffle if should_shuffle is not None
                       else kwargs.get("is_train", True))
            dp = DataProvider(
                func, files, types, names,
                should_shuffle=shuffle, pool_size=pool_size, cache=cache,
                check=check, check_fail_continue=check_fail_continue,
                settings=settings, rng=rng)
            dp.calc_batch_size = calc_batch_size
            dp.can_over_batch_size = can_over_batch_size
            dp.min_pool_size = min_pool_size
            return dp

        create.is_data_provider = True  # reference marker attribute
        return create

    return wrap
