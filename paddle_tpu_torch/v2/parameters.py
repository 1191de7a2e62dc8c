"""``paddle.v2.parameters`` — counterpart of
``paddle_tpu/v2/parameters.py``: ``Parameters`` with numpy get/set and tar
checkpoints (python/paddle/v2/parameters.py:192-285).

A tar holds ``params/<name>.npy`` and ``state/<name>.npy`` in the
parameters' order, then ``meta.json``: the reference's members, written
the same way, so a tar of either package loads into the other.
"""

from __future__ import annotations

import io
import json
import tarfile
import time
from typing import Any, Dict, Iterator

import numpy as np
import torch

from paddle_tpu_torch.nn.graph import LayerOutput, Topology

__all__ = ["Parameters", "create"]


def to_numpy(v) -> np.ndarray:
    """A host copy of a tensor (bfloat16 widened to float32) or array."""
    if torch.is_tensor(v):
        v = v.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.to("cpu", copy=True).numpy()
    return np.asarray(v)


class Parameters:
    """Name-addressable parameter store: numpy arrays by name, the
    parameters (``params``) and the layer state (``state``)."""

    def __init__(self, topology: Topology, params: Dict[str, Any],
                 state: Dict[str, Any]):
        self.topology = topology
        self.params = {k: to_numpy(v) for k, v in params.items()}
        self.state = {k: to_numpy(v) for k, v in state.items()}

    # dict-style access (parameters.py __getitem__/__setitem__)
    def __getitem__(self, name: str) -> np.ndarray:
        if name in self.params:
            return self.params[name]
        return self.state[name]

    def __setitem__(self, name: str, value) -> None:
        store = self.params if name in self.params else self.state
        old = store[name]
        value = np.asarray(value, dtype=old.dtype)
        if value.shape != old.shape:
            raise ValueError(
                f"parameter {name!r} has shape {old.shape}, got {value.shape}")
        store[name] = value

    def __contains__(self, name: str) -> bool:
        return name in self.params or name in self.state

    def keys(self) -> Iterator[str]:
        return iter([*self.params, *self.state])

    def names(self):
        return list(self.keys())

    # -- tar checkpoints (to_tar/from_tar, parameters.py:266-285) ----------
    def to_tar(self, f) -> None:
        with tarfile.open(fileobj=f, mode="w") as tar:
            for group, d in (("params", self.params), ("state", self.state)):
                for name, arr in d.items():
                    buf = io.BytesIO()
                    np.save(buf, arr, allow_pickle=False)
                    data = buf.getvalue()
                    info = tarfile.TarInfo(f"{group}/{name}.npy")
                    info.size = len(data)
                    info.mtime = int(time.time())
                    tar.addfile(info, io.BytesIO(data))
            meta = json.dumps({"params": list(self.params),
                               "state": list(self.state)}).encode()
            info = tarfile.TarInfo("meta.json")
            info.size = len(meta)
            tar.addfile(info, io.BytesIO(meta))

    def from_tar(self, f) -> None:
        """Load every array of a tar.  Each member is checked (a known name,
        the same shape) before any is assigned, so a mismatched tar leaves
        this object as it was."""
        with tarfile.open(fileobj=f, mode="r") as tar:
            loaded = {}
            for member in tar.getmembers():
                if not member.name.endswith(".npy"):
                    continue
                name = member.name.split("/", 1)[1][: -len(".npy")]
                if name not in self:
                    raise ValueError(
                        f"checkpoint contains unknown parameter {name!r}; "
                        f"known: {sorted(self.names())}")
                arr = np.load(io.BytesIO(tar.extractfile(member).read()),
                              allow_pickle=False)
                if arr.shape != self[name].shape:
                    raise ValueError(
                        f"parameter {name!r} has shape {self[name].shape}, "
                        f"checkpoint has {arr.shape}")
                loaded[name] = arr
            for name, arr in loaded.items():
                self[name] = arr  # converts the dtype


def create(cost: LayerOutput, *, seed: int = 0) -> Parameters:
    """``paddle.parameters.create(cost)``: the topology's initial values
    from ``Topology.init(seed)`` on ``FLAGS.device``.  The values are the
    port's numpy-seeded draws, not the reference's ``jax.random`` ones;
    carry a reference's values across with ``from_tar``."""
    from paddle_tpu_torch.utils.flags import FLAGS

    costs = [cost] if isinstance(cost, LayerOutput) else list(cost)
    topo = Topology(costs, device=FLAGS.device)
    params, state = topo.init(seed)
    return Parameters(topo, params, state)
