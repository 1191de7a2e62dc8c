"""``python -m paddle_tpu_torch data {pack|verify}`` — shard-set tooling.

``pack`` drains any reader — a ``module:callable`` spec resolving to a
reader creator (every ``paddle_tpu_torch.data.datasets`` loader qualifies), or
a ``--config CONF.py`` train config whose reader yields batches — into
an atomically-published indexed shard set.  ``verify`` re-hashes an
existing set: manifest file CRCs, the per-shard footer index, and every
record's own CRC; the first failure exits 2 naming the shard file and
record index (the address ``resilience.chaos.corrupt_shard`` damages).
"""

from __future__ import annotations

import argparse
import importlib
import sys
from typing import List, Optional

__all__ = ["run"]


def _resolve_reader(spec: str):
    """``pkg.mod:attr`` (or dotted ``attr.path``) -> reader creator."""
    if ":" not in spec:
        raise SystemExit(
            f"--reader must be 'module:callable', got {spec!r}")
    mod_name, attr = spec.split(":", 1)
    mod = importlib.import_module(mod_name)
    obj = mod
    for part in attr.split("."):
        obj = getattr(obj, part)
    if not callable(obj):
        raise SystemExit(f"--reader {spec!r} is not callable")
    return obj


def _config_reader(path: str, *, unbatch: bool):
    import runpy

    ns = runpy.run_path(path)
    if "get_config" not in ns:
        raise SystemExit(f"config {path!r} does not define get_config()")
    conf = ns["get_config"]()
    if "reader" not in conf:
        raise SystemExit(f"get_config() in {path!r} returned no 'reader'")
    reader = conf["reader"]
    if not unbatch:
        return reader

    def samples():
        for batch in reader():
            for sample in batch:
                yield sample

    return samples


def run(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch data",
        description="indexed shard-set tooling (docs/data.md)")
    sub = p.add_subparsers(dest="cmd", required=True)

    pk = sub.add_parser("pack", help="build a shard set from a reader")
    pk.add_argument("out", help="output shard-set directory (must not "
                    "exist; published atomically)")
    src = pk.add_mutually_exclusive_group(required=True)
    src.add_argument("--reader", help="module:callable reader creator "
                     "yielding SAMPLES (e.g. mypkg.readers:train, a "
                     "function whose call gives an iterable of samples)")
    src.add_argument("--config", help="train config (get_config()) whose "
                     "batch reader is unbatched into samples")
    pk.add_argument("--shards", type=int, default=None,
                    help="shard count (default: --data_shards)")
    pk.add_argument("--limit", type=int, default=None,
                    help="stop after N samples (smoke packs)")

    vf = sub.add_parser("verify", help="CRC-verify an existing shard set")
    vf.add_argument("root", help="shard-set directory")

    args = p.parse_args(argv)

    from paddle_tpu_torch.datapipe.shards import (ShardDataset, ShardError,
                                            write_shard_set)

    if args.cmd == "pack":
        reader = (_resolve_reader(args.reader) if args.reader
                  else _config_reader(args.config, unbatch=True))
        try:
            manifest = write_shard_set(args.out, reader,
                                       num_shards=args.shards,
                                       limit=args.limit)
        except ShardError as e:
            print(f"pack failed: {e}", file=sys.stderr)
            return 2
        print(f"packed {manifest['num_records']} record(s) into "
              f"{len(manifest['shards'])} shard(s) at {args.out}")
        return 0

    try:
        summary = ShardDataset(args.root).validate()
    except ShardError as e:
        print(f"verify FAILED: {e}", file=sys.stderr)
        return 2
    print(f"verified {summary['records']} record(s) across "
          f"{summary['shards']} shard(s), {summary['bytes']} bytes — OK")
    return 0
