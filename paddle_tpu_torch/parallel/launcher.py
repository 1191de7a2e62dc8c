"""Cluster job launcher — counterpart of ``paddle_tpu/parallel/launcher.py``
(the reference's fabric launcher, paddle/scripts/cluster_train/
paddle.py:101-175: one process per HOSTS entry, the wiring flags injected).

Every rank runs the same program; the launcher starts it once per entry of
``hosts`` with the rendezvous, the world size, the rank, its local rank
and local world (the entries on the same host) and the backend in the
environment (``parallel/distributed.py``'s ``PADDLE_TPU_TORCH_*``), which
``initialize_distributed()`` reads.  Local entries fork; remote entries
run through ssh with the same wiring exported on the command line.

The rendezvous is ``coordinator`` when given (``file:///path`` for a
shared file, or ``host:port``), else ``tcp://<hosts[0]>:<coordinator_
port>``.  ``log_dir`` sends each local rank's output to
``rank-<i>.out`` / ``rank-<i>.err`` there; ``join(timeout)`` waits for the
gang and, past the limit, SIGKILLs all of it (a rank wedged in a
collective ignores SIGTERM) and raises with each rank's stderr tail.

Not ported here: ``launch_supervised`` (the gang supervisor, ROADMAP.md
Queue 1 item 9) raises naming its item.
"""

from __future__ import annotations

import os
import shlex
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from paddle_tpu_torch.parallel.distributed import (ENV_BACKEND,
                                                   ENV_COORDINATOR,
                                                   ENV_LOCAL_RANK,
                                                   ENV_LOCAL_WORLD,
                                                   ENV_NUM_PROCESSES,
                                                   ENV_PROCESS_ID)
from paddle_tpu_torch.utils.log import logger

__all__ = ["ClusterLauncher", "launch_local", "launch_supervised",
           "GangTimeout"]

_LOCAL_HOSTS = ("localhost", "127.0.0.1", "::1", "")


class GangTimeout(RuntimeError):
    """A launched gang outlived its time limit and was killed."""


def _parse_host(entry: str):
    """'user@host[:port]' -> (user|None, host, port|None).  A bare IPv6
    address never carries a port; '[addr]:port' attaches one."""
    user, _, rest = entry.rpartition("@")
    user = user or None
    if rest.startswith("["):
        host, _, tail = rest[1:].partition("]")
        port = tail[1:] if tail.startswith(":") else None
    elif rest.count(":") == 1:
        host, _, port = rest.partition(":")
    else:
        host, port = rest, None
    return user, host, port or None


def _host_part(entry: str) -> str:
    return _parse_host(entry)[1]


@dataclass
class ClusterLauncher:
    """Start one process per entry of ``hosts`` running the same program
    (``hosts[0]`` also holds the TCP rendezvous)."""

    hosts: Sequence[str]
    coordinator_port: int = 12355
    coordinator: Optional[str] = None
    backend: Optional[str] = None
    python: str = sys.executable
    remote_python: str = "python3"
    ssh_cmd: Sequence[str] = ("ssh", "-o", "BatchMode=yes")
    log_dir: Optional[str] = None
    procs: List[subprocess.Popen] = field(default_factory=list)

    def _coordinator(self) -> str:
        if self.coordinator:
            return self.coordinator
        host = _host_part(self.hosts[0])
        if host in _LOCAL_HOSTS:
            host = "127.0.0.1"
        if ":" in host:
            host = f"[{host}]"
        return f"tcp://{host}:{self.coordinator_port}"

    def _wiring(self, i: int) -> Dict[str, str]:
        me = _host_part(self.hosts[i])
        same = [j for j, h in enumerate(self.hosts) if _host_part(h) == me]
        wiring = {
            ENV_COORDINATOR: self._coordinator(),
            ENV_NUM_PROCESSES: str(len(self.hosts)),
            ENV_PROCESS_ID: str(i),
            ENV_LOCAL_RANK: str(same.index(i)),
            ENV_LOCAL_WORLD: str(len(same)),
        }
        if self.backend:
            wiring[ENV_BACKEND] = self.backend
        return wiring

    def _rank_spec(self, i: int, script: str, args: Sequence[str],
                   env: Optional[Dict[str, str]], cwd: Optional[str]
                   ) -> Dict:
        wiring = self._wiring(i)
        user, hname, port = _parse_host(self.hosts[i])
        if hname in _LOCAL_HOSTS and port is None:
            penv = {**os.environ, **(env or {}), **wiring}
            return dict(args=[self.python, script, *args], env=penv,
                        cwd=cwd)
        q = shlex.quote
        dest = f"{user}@{hname}" if user else hname
        exports = " ".join(f"{q(k)}={q(str(v))}"
                           for k, v in {**(env or {}), **wiring}.items())
        remote = (f"cd {q(cwd or '.')} && env {exports} "
                  f"{q(self.remote_python)} {q(script)} "
                  + " ".join(q(str(a)) for a in args))
        port_flag = ("-p", port) if port else ()
        return dict(args=[*self.ssh_cmd, *port_flag, dest, remote])

    def _log_paths(self, i: int):
        return (os.path.join(self.log_dir, f"rank-{i}.out"),
                os.path.join(self.log_dir, f"rank-{i}.err"))

    def launch(self, script: str, args: Sequence[str] = (),
               env: Optional[Dict[str, str]] = None,
               cwd: Optional[str] = None) -> List[subprocess.Popen]:
        """Start ``python script args...`` on every host with the wiring
        injected (``script`` may be ``-m`` with the module first in
        ``args``); returns the Popen handles."""
        if self.procs:
            raise RuntimeError("launcher already started a job")
        if self.log_dir:
            os.makedirs(self.log_dir, exist_ok=True)
        for i, host in enumerate(self.hosts):
            spec = self._rank_spec(i, script, args, env, cwd)
            if self.log_dir:
                out, err = self._log_paths(i)
                with open(out, "wb") as fo, open(err, "wb") as fe:
                    p = subprocess.Popen(**spec, stdout=fo, stderr=fe)
            else:
                p = subprocess.Popen(**spec)
            logger.info("launched rank %d on %s (pid %d)", i,
                        host or "local", p.pid)
            self.procs.append(p)
        return self.procs

    def poll(self) -> List[Optional[int]]:
        return [p.poll() for p in self.procs]

    def kill_gang(self) -> List[Optional[int]]:
        """SIGKILL every rank and reap; returns the exit codes."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        codes = []
        for p in self.procs:
            try:
                codes.append(p.wait(timeout=10))
            except subprocess.TimeoutExpired:
                codes.append(p.poll())
        return codes

    def wait(self, timeout: Optional[float] = None) -> List[int]:
        """Wait for all ranks; returns exit codes (raises
        ``subprocess.TimeoutExpired`` on timeout, leaving them running)."""
        deadline = time.time() + timeout if timeout else None
        codes = []
        for p in self.procs:
            left = (deadline - time.time()) if deadline else None
            codes.append(p.wait(timeout=left))
        return codes

    def join(self, timeout: float) -> List[int]:
        """Wait up to ``timeout`` seconds for the gang.  A rank that exits
        non-zero ends the wait at once (the others would hang in their
        next collective); past the limit or after such an exit the whole
        gang is killed.  Raises ``GangTimeout`` on the limit, with each
        rank's stderr tail when ``log_dir`` holds it."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            codes = self.poll()
            if all(c is not None for c in codes):
                return codes
            if any(c not in (None, 0) for c in codes):
                time.sleep(2.0)       # let the others report their error
                self.kill_gang()
                return [p.returncode for p in self.procs]
            time.sleep(0.05)
        self.kill_gang()
        raise GangTimeout(f"gang of {len(self.procs)} ranks outlived "
                          f"{timeout:.0f} s and was killed\n"
                          + self.stderr_tails())

    def stderr_tails(self, nbytes: int = 4000) -> str:
        if not self.log_dir:
            return ""
        parts = []
        for i in range(len(self.procs)):
            path = self._log_paths(i)[1]
            try:
                with open(path, "rb") as f:
                    f.seek(max(0, os.path.getsize(path) - nbytes))
                    tail = f.read().decode("utf-8", "replace")
            except OSError as e:
                tail = f"<{e}>"
            parts.append(f"--- rank {i} stderr ---\n{tail}")
        return "\n".join(parts)

    def terminate(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.terminate()
        for p in self.procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()


def launch_local(n: int, script: str, args: Sequence[str] = (),
                 env: Optional[Dict[str, str]] = None,
                 coordinator_port: int = 12355, *,
                 coordinator: Optional[str] = None,
                 backend: Optional[str] = None,
                 log_dir: Optional[str] = None,
                 cwd: Optional[str] = None) -> ClusterLauncher:
    """Start ``n`` local ranks of ``script`` (``-m`` runs a module)."""
    launcher = ClusterLauncher(hosts=["localhost"] * n,
                               coordinator_port=coordinator_port,
                               coordinator=coordinator, backend=backend,
                               log_dir=log_dir)
    launcher.launch(script, args, env=env, cwd=cwd)
    return launcher


def launch_supervised(n: int, script: str, args: Sequence[str] = (),
                      env: Optional[Dict[str, str]] = None, **kw):
    from paddle_tpu_torch.utils.error import not_ported

    raise not_ported("launch_supervised (the gang supervisor, "
                     "resilience/cluster.py)", 9)
