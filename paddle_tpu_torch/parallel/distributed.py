"""The launched world of ranks — counterpart of
``paddle_tpu/parallel/distributed.py``.

Reference: ``jax.distributed.initialize`` wires one process per host and
``jax.devices()`` becomes the global chip list.  PyTorch runs one process
per device, so here ``initialize_distributed`` joins this process to a
``torch.distributed`` world: the launcher (``parallel/launcher.py``)
injects the rendezvous (``PADDLE_TPU_TORCH_COORDINATOR``: ``host:port``,
``tcp://host:port`` or ``file:///path``), the world size, this rank, its
local rank and the backend; explicit arguments take their place (the CPU
tests' children).

Backend and device are explicit, and nothing switches either behind a
``try``:
- the device is ``cuda:{local_rank % device_count}`` when ``--device``
  (or ``device=``) is ``cuda``, else the CPU (``paddle_tpu_torch/
  device.py`` resolves it and raises without a card);
- the default backend is NCCL for a rank with a card of its own and gloo
  on the CPU.  Two ranks on one card must ask for gloo by name: NCCL
  refuses two ranks on one device, so a default that would land there
  raises a ``ConfigError`` saying so;
- a gloo group with a CUDA tensor stages each exchange through the host
  in the open (``_staged``): copy to the CPU, exchange, copy back, the
  copies timed apart.

Every collective the port issues goes through the helpers here and is
counted by tag: ``comm_stats()`` gives calls, bytes sent by this rank,
host milliseconds and the staging copies' milliseconds;
``reset_comm_stats()`` clears them.
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Dict, List, Optional, Sequence

import torch

from paddle_tpu_torch.utils.error import ConfigError
from paddle_tpu_torch.utils.log import logger

__all__ = ["initialize_distributed", "shutdown_distributed", "global_mesh",
           "is_multi_host", "resume_pass", "world_size", "rank",
           "backend", "rank_device", "comm_stats", "reset_comm_stats",
           "ENV_COORDINATOR", "ENV_NUM_PROCESSES", "ENV_PROCESS_ID",
           "ENV_LOCAL_RANK", "ENV_LOCAL_WORLD", "ENV_BACKEND"]

#: the launcher's wiring, read by ``initialize_distributed``
ENV_COORDINATOR = "PADDLE_TPU_TORCH_COORDINATOR"
ENV_NUM_PROCESSES = "PADDLE_TPU_TORCH_NUM_PROCESSES"
ENV_PROCESS_ID = "PADDLE_TPU_TORCH_PROCESS_ID"
ENV_LOCAL_RANK = "PADDLE_TPU_TORCH_LOCAL_RANK"
ENV_LOCAL_WORLD = "PADDLE_TPU_TORCH_LOCAL_WORLD"
ENV_BACKEND = "PADDLE_TPU_TORCH_DIST_BACKEND"

_state: Dict[str, object] = {"initialized": False, "device": None,
                             "backend": None}


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def _init_method(addr: str) -> str:
    if addr.startswith(("file://", "tcp://", "env://")):
        return addr
    return f"tcp://{addr}"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           backend: Optional[str] = None,
                           device: Optional[str] = None,
                           local_rank: Optional[int] = None,
                           local_world: Optional[int] = None,
                           timeout_s: float = 300.0) -> None:
    """Join the launched world (idempotent).  Without a coordinator (no
    argument and no launcher environment) this is a world of one process:
    nothing is made or remembered, and the rank's device is ``--device``."""
    import torch.distributed as dist

    if _state["initialized"]:
        return
    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.utils.flags import FLAGS

    addr = coordinator_address or os.environ.get(ENV_COORDINATOR)
    n = num_processes if num_processes is not None else _env_int(
        ENV_NUM_PROCESSES)
    r = process_id if process_id is not None else _env_int(ENV_PROCESS_ID)
    lr = local_rank if local_rank is not None else _env_int(ENV_LOCAL_RANK)
    lw = local_world if local_world is not None else _env_int(
        ENV_LOCAL_WORLD)
    lr = r if lr is None else lr
    want = torch.device(device if device is not None else FLAGS.device)
    if addr is None:
        return
    if n is None or r is None:
        raise ConfigError(
            f"a coordinator ({addr}) needs the world size and this rank "
            f"({ENV_NUM_PROCESSES}, {ENV_PROCESS_ID})")
    if want.type == "cuda":
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        dev = resolve_device(f"cuda:{(lr or 0) % max(count, 1)}")
        torch.cuda.set_device(dev)
    else:
        count = 0
        dev = resolve_device(want)
    backend = (backend or os.environ.get(ENV_BACKEND)
               or ("nccl" if dev.type == "cuda" else "gloo"))
    if backend == "nccl":
        if dev.type != "cuda":
            raise ConfigError("the NCCL backend needs a card: pass "
                              "backend='gloo' for ranks on the CPU")
        sharing = (lw if lw is not None else n) > count
        if sharing:
            raise ConfigError(
                f"{lw if lw is not None else n} ranks on this host share "
                f"{count} card(s): NCCL refuses two ranks on one device, "
                f"so ask for the gloo backend by name")
    dist.init_process_group(backend, init_method=_init_method(addr),
                            world_size=n, rank=r,
                            timeout=datetime.timedelta(seconds=timeout_s))
    _state.update(initialized=True, device=dev, backend=backend)
    logger.info("distributed init: rank %d/%d (local %d) on %s over %s",
                r, n, lr or 0, dev, backend)


def shutdown_distributed() -> None:
    """Leave the world and reset the latch, so a process may join again
    (safe when nothing was initialized)."""
    import torch.distributed as dist

    if _state["initialized"] and dist.is_initialized():
        dist.destroy_process_group()
    _state.update(initialized=False, device=None, backend=None)


def world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def backend() -> Optional[str]:
    """The backend this process joined the world over (None outside
    one)."""
    return _state["backend"]


def rank_device() -> torch.device:
    """This rank's device: the one ``initialize_distributed`` chose, else
    ``--device`` resolved."""
    if _state["device"] is not None:
        return _state["device"]
    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.utils.flags import FLAGS

    return resolve_device(FLAGS.device)


def is_multi_host() -> bool:
    """True when this process is one of several ranks."""
    return world_size() > 1


def global_mesh(shape: Optional[Sequence[int]] = None,
                axis_names: Optional[Sequence[str]] = None, config=None):
    """The mesh over the whole launched world, bound to this rank:
    ``config`` (a ``MeshConfig``), else ``shape``/``axis_names``, else the
    flags (``MeshConfig.from_flags``)."""
    from paddle_tpu_torch.parallel.mesh import MeshConfig

    initialize_distributed()
    if config is not None:
        return config.build()
    if shape is None and axis_names is None:
        return MeshConfig.from_flags().build()
    from paddle_tpu_torch.utils.devices import make_mesh

    return make_mesh(shape, axis_names)


def resume_pass(save_dir: str) -> int:
    """Pass id to resume from after a restart."""
    from paddle_tpu_torch.trainer.checkpoint import latest_pass

    last = latest_pass(save_dir)
    return last + 1 if last >= 0 else 0


# ---------------------------------------------------------------------------
# collectives, counted by tag
# ---------------------------------------------------------------------------

_STATS: Dict[str, Dict[str, float]] = {}


def comm_stats() -> Dict[str, Dict[str, float]]:
    """``{tag: {"calls", "bytes", "ms", "staged_ms"}}`` since the last
    reset: bytes this rank sent, host milliseconds of the whole call, and
    of those the host staging copies' (gloo with a CUDA tensor)."""
    return {k: dict(v) for k, v in _STATS.items()}


def reset_comm_stats() -> None:
    _STATS.clear()


def _count(tag: str, nbytes: int, ms: float, staged_ms: float) -> None:
    s = _STATS.setdefault(tag, {"calls": 0, "bytes": 0, "ms": 0.0,
                                "staged_ms": 0.0})
    s["calls"] += 1
    s["bytes"] += int(nbytes)
    s["ms"] += ms
    s["staged_ms"] += staged_ms


def _staged(t: torch.Tensor, group) -> bool:
    """gloo exchanges host tensors: a CUDA tensor in a gloo group is
    staged through the CPU by the caller, in the open."""
    import torch.distributed as dist

    return t.is_cuda and dist.get_backend(group) == "gloo"


def _run(tag: str, src: torch.Tensor, group, exchange):
    """``exchange(host_or_device_tensor) -> result`` on ``src`` as the
    group's backend takes it; the result comes back on ``src``'s device."""
    t0 = time.perf_counter()
    staged_ms = 0.0
    if _staged(src, group):
        s0 = time.perf_counter()
        host = src.cpu()
        staged_ms += (time.perf_counter() - s0) * 1e3
        out = exchange(host)
        s0 = time.perf_counter()
        out = out.to(src.device)
        staged_ms += (time.perf_counter() - s0) * 1e3
    else:
        out = exchange(src)
    _count(tag, src.numel() * src.element_size(),
           (time.perf_counter() - t0) * 1e3, staged_ms)
    return out


def all_reduce_flat(tensors: List[torch.Tensor], group, *, tag: str,
                    op: str = "sum") -> None:
    """Reduce every tensor in place over ``group``: one flat exchange per
    dtype."""
    import torch.distributed as dist

    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])

        def exchange(x):
            dist.all_reduce(x, op=red, group=group)
            return x

        flat = _run(tag, flat, group, exchange)
        off = 0
        with torch.no_grad():
            for t in ts:
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()


def all_gather_cat(tensor: torch.Tensor, group, n: int, *,
                   tag: str) -> torch.Tensor:
    """Concatenation along dim 0 of every member's ``tensor`` (equal
    shapes), in group order."""
    import torch.distributed as dist

    def exchange(x):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts)

    return _run(tag, tensor, group, exchange)


def all_to_all_rows(tensor: torch.Tensor, group, *, tag: str
                    ) -> torch.Tensor:
    """``all_to_all_single`` with equal splits along dim 0."""
    import torch.distributed as dist

    def exchange(x):
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    return _run(tag, tensor, group, exchange)
