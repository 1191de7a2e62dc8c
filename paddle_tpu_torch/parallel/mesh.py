"""MeshConfig — the port's one description of the world of ranks;
counterpart of ``paddle_tpu/parallel/mesh.py``.

The reference holds the whole mesh in one process (a ``jax.sharding.Mesh``
over every device).  PyTorch runs one process per device, so the port's
mesh is a world of ranks: ``MeshConfig`` keeps the reference's named axes
and role bindings (``data``, ``model``, ``stage``, ``seq``, the pserver
axis, the elastic and dcn axes), and ``build()`` binds it to this process's
rank in the launched world (``parallel/distributed.py``): a :class:`Mesh`
with this rank's coordinates and one process group per axis of size > 1
(the ranks that differ from this one along that axis only).

Ranks are laid out row-major over ``axes`` (the first axis varies
slowest), the reference's device-assignment order.  A world of 1 needs no
launcher: a config of size 1 builds without a process group.  A config
whose size is not the world size raises a ``ConfigError`` naming both.

Collectives go through :class:`Mesh` (``all_reduce``, ``all_gather``,
``all_to_all``), which counts their calls, bytes and host milliseconds by
tag (``distributed.comm_stats``).  A gloo group with a CUDA tensor stages
through the host in the open: the tensor is copied to the CPU, exchanged
and copied back, and the copies are timed apart (``staged_ms``).
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple

from paddle_tpu_torch.utils.error import ConfigError

__all__ = ["MeshConfig", "Mesh", "as_mesh", "mesh_axes"]


@dataclass(frozen=True)
class MeshConfig:
    """Named-axis description of the world + role bindings.

    ``axes`` is an ordered ``((name, size), ...)`` tuple, the order of the
    rank layout.  A role whose axis is absent from ``axes`` has size 1
    (asking for it never errors)."""

    axes: Tuple[Tuple[str, int], ...]
    data_axis: str = "data"        # batch slices + gradient all-reduce
    model_axis: str = "model"      # tensor-parallel weight shards
    pipe_axis: str = "stage"       # pipeline stages
    seq_axis: str = "seq"          # ring-attention sequence shards
    pserver_axis: Optional[str] = None   # embedding-table shards
                                         # (None = FLAGS.pserver_axis)
    #: the axis elastic resize rescales; defaults to ``data_axis``
    elastic_axis: Optional[str] = None
    #: the pod-crossing axis of a multi-pod world (``parallel/
    #: hierarchical.py`` in the reference; not ported: ``make_parallel_
    #: train_step`` refuses a config that binds it)
    dcn_axis: Optional[str] = None

    def __post_init__(self):
        object.__setattr__(self, "axes",
                           tuple((str(n), int(s)) for n, s in self.axes))
        names = [n for n, _ in self.axes]
        if len(set(names)) != len(names):
            raise ConfigError(f"duplicate mesh axis names in {names}")
        for n, s in self.axes:
            if s < 1:
                raise ConfigError(f"mesh axis {n!r} must have size >= 1, "
                                  f"got {s}")

    # -- construction ----------------------------------------------------

    @classmethod
    def of(cls, **axis_sizes: int) -> "MeshConfig":
        """``MeshConfig.of(data=2, model=2)`` — ordered as given."""
        return cls(axes=tuple(axis_sizes.items()))

    @classmethod
    def named(cls, shape: Sequence[int],
              axis_names: Optional[Sequence[str]] = None) -> "MeshConfig":
        """Config from a shape plus optional names: names truncate to the
        shape's rank, and a missing or short list falls back to the default
        ``data, model, seq, expert, stage`` prefix."""
        shape = tuple(int(s) for s in shape)
        names = tuple(axis_names or ())[: len(shape)]
        if len(names) != len(shape):
            base = ("data", "model", "seq", "expert", "stage")
            if len(shape) > len(base):
                raise ConfigError(
                    f"mesh shape {shape} has {len(shape)} dimensions but "
                    f"only {len(base)} default axis names exist — pass "
                    f"axis_names covering every dimension")
            names = base[: len(shape)]
        return cls(axes=tuple(zip(names, shape)))

    @classmethod
    def from_flags(cls, world_size: Optional[int] = None) -> "MeshConfig":
        """The flag plane (``--mesh_shape`` / ``--mesh_axes`` /
        ``--pserver_axis``) as a config; an empty ``--mesh_shape`` is one
        data axis over the whole world (``world_size``, default the
        launched world's size, 1 outside one)."""
        from paddle_tpu_torch.utils.flags import FLAGS

        if world_size is None:
            from paddle_tpu_torch.parallel.distributed import world_size as ws

            world_size = ws()
        cfg = cls.named(parse_mesh_shape(FLAGS.mesh_shape, world_size),
                        FLAGS.mesh_axes.split(","))
        return replace(cfg, pserver_axis=FLAGS.pserver_axis)

    # -- shape queries ---------------------------------------------------

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.axes)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self.axes)

    @property
    def size(self) -> int:
        return math.prod(s for _, s in self.axes) if self.axes else 1

    def axis_size(self, name: str) -> int:
        """Size of axis ``name``; 1 when the axis is absent."""
        return self.shape.get(name, 1)

    @property
    def dcn_size(self) -> int:
        return self.axis_size(self.dcn_axis) if self.dcn_axis else 1

    @property
    def pod_size(self) -> int:
        return self.size // self.dcn_size

    def pod_of(self, rank: int) -> int:
        if not 0 <= rank < self.size:
            raise ConfigError(f"rank {rank} outside mesh of size "
                              f"{self.size}")
        return rank // self.pod_size

    def role_axis(self, role: str) -> str:
        """Axis name bound to ``role`` ('data'|'model'|'pipe'|'seq'|
        'pserver')."""
        if role == "pserver" and self.pserver_axis is None:
            from paddle_tpu_torch.utils.flags import FLAGS

            return FLAGS.pserver_axis
        name = getattr(self, f"{role}_axis", None)
        if name is None:
            raise ConfigError(f"unknown mesh role {role!r}")
        return name

    # -- resize ------------------------------------------------------------

    def resize(self, **axis_sizes: int) -> "MeshConfig":
        """New config with the named axes resized (an absent axis is
        appended)."""
        known = dict(self.axes)
        updated = tuple((n, axis_sizes.get(n, s)) for n, s in self.axes)
        appended = tuple((n, s) for n, s in axis_sizes.items()
                         if n not in known)
        return replace(self, axes=updated + appended)

    def fit_world(self, n_ranks: int) -> "MeshConfig":
        """Rescale the elastic axis so the mesh fits ``n_ranks``: the
        other axes are fixed, the elastic one becomes ``n_ranks //
        prod(others)`` (with a dcn axis bound, whole pods)."""
        el = (self.dcn_axis if self.dcn_axis and
              self.dcn_axis in self.shape else
              self.elastic_axis or self.data_axis)
        others = math.prod(s for n, s in self.axes if n != el)
        new = n_ranks // others
        if new < 1:
            raise ConfigError(
                f"cannot fit mesh {dict(self.axes)} into {n_ranks} "
                f"rank(s): non-elastic axes already need {others}")
        return self.resize(**{el: new})

    # -- rank layout -----------------------------------------------------

    def coords_of(self, rank: int) -> Dict[str, int]:
        """The rank's index along each axis (row-major layout)."""
        if not 0 <= rank < self.size:
            raise ConfigError(f"rank {rank} outside mesh of size "
                              f"{self.size}")
        out = {}
        for name, s in reversed(self.axes):
            out[name] = rank % s
            rank //= s
        return {n: out[n] for n in self.axis_names}

    def rank_of(self, coords: Dict[str, int]) -> int:
        rank = 0
        for name, s in self.axes:
            rank = rank * s + int(coords.get(name, 0))
        return rank

    def axis_groups(self, name: str) -> List[List[int]]:
        """Every group of ranks that differ along ``name`` only, in a fixed
        order (each list ordered by the index along ``name``)."""
        others = [(n, s) for n, s in self.axes if n != name]
        groups = []
        for idx in itertools.product(*(range(s) for _, s in others)):
            fixed = dict(zip((n for n, _ in others), idx))
            groups.append([self.rank_of({**fixed, name: i})
                           for i in range(self.axis_size(name))])
        return groups

    # -- materialization -------------------------------------------------

    def build(self, device=None) -> "Mesh":
        """Bind the config to this process's rank in the launched world
        (``initialize_distributed``): one process group per axis of size
        > 1.  A size-1 config builds outside a launched world."""
        import torch.distributed as dist

        from paddle_tpu_torch.parallel import distributed as D

        live = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if live else 1
        if self.size != world:
            raise ConfigError(
                f"mesh {dict(self.axes)} has {self.size} ranks but the "
                f"launched world has {world} process(es): --mesh_shape must "
                f"equal the world size the launcher started")
        rank = dist.get_rank() if live else 0
        groups: Dict[str, Any] = {}
        for name, s in self.axes:
            if s < 2:
                continue
            for ranks in self.axis_groups(name):
                # every rank creates every group, in the same order
                g = dist.new_group(ranks)
                if rank in ranks:
                    groups[name] = g
        dev = D.rank_device() if device is None else device
        return Mesh(self, rank, groups, dev)

    # -- manifest plumbing -----------------------------------------------

    def to_json(self) -> Dict[str, Any]:
        return {
            "axes": [[n, s] for n, s in self.axes],
            "data_axis": self.data_axis,
            "model_axis": self.model_axis,
            "pipe_axis": self.pipe_axis,
            "seq_axis": self.seq_axis,
            "pserver_axis": self.pserver_axis,
            "elastic_axis": self.elastic_axis,
            "dcn_axis": self.dcn_axis,
        }

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "MeshConfig":
        return cls(axes=tuple((n, int(s)) for n, s in d["axes"]),
                   data_axis=d.get("data_axis", "data"),
                   model_axis=d.get("model_axis", "model"),
                   pipe_axis=d.get("pipe_axis", "stage"),
                   seq_axis=d.get("seq_axis", "seq"),
                   pserver_axis=d.get("pserver_axis"),
                   elastic_axis=d.get("elastic_axis"),
                   dcn_axis=d.get("dcn_axis"))

    def __repr__(self) -> str:
        body = ",".join(f"{n}={s}" for n, s in self.axes)
        return f"MeshConfig({body})"


def parse_mesh_shape(spec: str, world: int) -> Tuple[int, ...]:
    """``'4x2'`` / ``'4,2'`` -> ``(4, 2)``; empty -> ``(world,)``."""
    if not spec:
        return (world,)
    return tuple(int(d) for d in spec.replace(",", "x").split("x") if d)


class Mesh:
    """A :class:`MeshConfig` bound to one rank: its coordinates, its
    device and the process group of each axis it spans (none for an axis
    of size 1, where every collective is the identity)."""

    def __init__(self, config: MeshConfig, rank: int,
                 groups: Dict[str, Any], device) -> None:
        self.config = config
        self.rank = rank
        self.groups = groups
        self.device = device
        self.coords = config.coords_of(rank)

    # the config's queries, so a Mesh stands wherever a config does
    @property
    def axis_names(self) -> Tuple[str, ...]:
        return self.config.axis_names

    @property
    def shape(self) -> Dict[str, int]:
        return self.config.shape

    @property
    def size(self) -> int:
        return self.config.size

    def axis_size(self, name: str) -> int:
        return self.config.axis_size(name)

    def axis_index(self, name: str) -> int:
        """This rank's index along ``name`` (0 when the axis is absent)."""
        return self.coords.get(name, 0)

    def group(self, name: str):
        return self.groups.get(name)

    # -- collectives (counted by tag) -------------------------------------

    def all_reduce(self, tensors: Sequence, axis: str, *, tag: str,
                   op: str = "sum") -> None:
        """In-place sum (or max) of each tensor over ``axis``'s group, one
        flat exchange for all of them."""
        from paddle_tpu_torch.parallel.distributed import all_reduce_flat

        g = self.group(axis)
        if g is None or not tensors:
            return
        all_reduce_flat(list(tensors), g, tag=tag, op=op)

    def all_gather(self, tensor, axis: str, *, tag: str):
        """``[n * rows, ...]``: every member's tensor, in axis order
        (equal shapes across the group)."""
        from paddle_tpu_torch.parallel.distributed import all_gather_cat

        g = self.group(axis)
        if g is None:
            return tensor
        return all_gather_cat(tensor, g, self.axis_size(axis), tag=tag)

    def all_to_all(self, tensor, axis: str, *, tag: str):
        """Row block ``k`` of ``tensor`` ([n * cap, ...]) goes to member
        ``k``; the result's block ``k`` came from member ``k``."""
        from paddle_tpu_torch.parallel.distributed import all_to_all_rows

        g = self.group(axis)
        if g is None:
            return tensor
        return all_to_all_rows(tensor, g, tag=tag)

    def __repr__(self) -> str:
        at = ",".join(f"{n}={self.coords[n]}/{s}"
                      for n, s in self.config.axes)
        return f"<Mesh rank {self.rank} ({at}) on {self.device}>"


def as_mesh(mesh_or_config, device=None) -> Optional[Mesh]:
    """A ``Mesh`` passes through, a ``MeshConfig`` builds, ``None`` stays
    ``None``."""
    if mesh_or_config is None or isinstance(mesh_or_config, Mesh):
        return mesh_or_config
    if isinstance(mesh_or_config, MeshConfig):
        return mesh_or_config.build(device)
    raise ConfigError(f"expected a MeshConfig or Mesh, got "
                      f"{type(mesh_or_config).__name__}")


def mesh_axes(mesh_or_config) -> Tuple[str, ...]:
    """Axis names of either form without binding a rank."""
    return tuple(mesh_or_config.axis_names)
