"""paddle_tpu_torch.parallel — the data axis and the launched world over
``torch.distributed``; counterpart of ``paddle_tpu/parallel``.

The reference holds the whole mesh in one JAX process; PyTorch runs one
process per device, so here the mesh is a world of ranks:

- ``MeshConfig`` (``mesh.py``) keeps the named axes and role bindings and
  ``build()``s a ``Mesh`` bound to this rank (one process group per axis);
- ``initialize_distributed`` (``distributed.py``) joins the world the
  launcher (``launcher.py``) started, on an explicit backend and device;
- ``make_parallel_train_step`` and ``shard_batch`` (``api.py``) run the
  data-parallel step: local forward on the rank's slice, the loss scaled
  by the rank's share of the global batch (``loss_shares``), local
  backward, one all-reduce to the global batch's loss and gradients
  (``reduce_loss_and_grads``), the same update on every rank;
- ``shard_table`` / ``sharded_embedding_lookup`` (``embedding.py``) are the
  compat surface over the pserver tier's all-to-all lookup.

Not ported yet (ROADMAP.md Queue 1 item 8, each raising where its entry
point exists): tensor-parallel ``ShardingRules`` on DTensor, the dcn
hierarchy (``hierarchical.py``), the pipeline (``pipeline.py``,
``pipeline_dsl.py``), ring attention and ``compat.py``.
"""

from paddle_tpu_torch.parallel.mesh import Mesh, MeshConfig, as_mesh, mesh_axes
from paddle_tpu_torch.parallel.sharding import (P, ShardingRules,
                                                batch_sharding, replicated,
                                                shard_params)
from paddle_tpu_torch.parallel.api import (agreement_spec,
                                           data_parallel_grads, loss_shares,
                                           make_parallel_train_step,
                                           reduce_loss_and_grads,
                                           shard_batch)
from paddle_tpu_torch.parallel.embedding import (shard_table,
                                                 sharded_embedding_lookup)
from paddle_tpu_torch.parallel.distributed import (comm_stats,
                                                   global_mesh,
                                                   initialize_distributed,
                                                   is_multi_host,
                                                   reset_comm_stats,
                                                   resume_pass,
                                                   shutdown_distributed)
from paddle_tpu_torch.parallel.launcher import (ClusterLauncher, GangTimeout,
                                                launch_local,
                                                launch_supervised)
from paddle_tpu_torch.utils.devices import make_mesh

__all__ = ["Mesh", "MeshConfig", "as_mesh", "mesh_axes", "P",
           "ShardingRules", "batch_sharding", "replicated", "shard_params",
           "agreement_spec", "data_parallel_grads", "loss_shares",
           "make_parallel_train_step", "reduce_loss_and_grads", "shard_batch",
           "shard_table", "sharded_embedding_lookup", "comm_stats",
           "global_mesh", "initialize_distributed", "is_multi_host",
           "reset_comm_stats", "resume_pass", "shutdown_distributed",
           "ClusterLauncher", "GangTimeout", "launch_local",
           "launch_supervised", "make_mesh"]
