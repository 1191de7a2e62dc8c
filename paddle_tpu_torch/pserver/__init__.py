"""paddle_tpu_torch.pserver — the parameter-server tier over
``torch.distributed``; counterpart of ``paddle_tpu/pserver``.

Embedding tables marked ``sparse_grad`` live row-sharded over the pserver
axis of the mesh (``table.ShardedTable``: vocab padded to a shard
multiple, each shard drawn from its own generator); a lookup buckets ids
by owning shard and exchanges them with ``all_to_all_single``
(``lookup``); the gradient push sends each shard only the segments it owns
and updates only the touched rows and their slots, in place
(``apply.sharded_row_update``); ``tier.PServerTier`` wires this into
``SGDTrainer``.

Not ported yet (ROADMAP.md Queue 1 item 8): ``snapshot.py`` (incremental
snapshots, ``TableReader``) and ``audit.py`` (``lint --pserver``).
"""

from paddle_tpu_torch.pserver.table import (ShardedTable, TableSpec,
                                            init_shard_rows, pad_vocab)
from paddle_tpu_torch.pserver.lookup import (TableProxy, all_to_all_lookup,
                                             bucket_by_owner)
from paddle_tpu_torch.pserver.apply import sharded_row_update
from paddle_tpu_torch.pserver.tier import PServerTier

__all__ = ["TableSpec", "ShardedTable", "pad_vocab", "init_shard_rows",
           "all_to_all_lookup", "bucket_by_owner", "TableProxy",
           "sharded_row_update", "PServerTier"]
