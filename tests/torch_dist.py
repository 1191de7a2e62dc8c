"""Multi-process harness of the port's parallel and pserver tests.

``run_world(tmp_path, n, case, inputs, config)`` starts ``n`` ranks of
``tests/torch_dist_worker.py``'s ``case`` with the port's own launcher
(``paddle_tpu_torch.parallel.launch_local``) and returns each rank's
outputs.  The rules it keeps:

- no process group in the pytest worker: every ``init_process_group``
  happens in a child;
- the rendezvous is a file under ``tmp_path`` (``file://``), never a
  fixed TCP port, so worlds of parallel test workers cannot collide;
- each world runs under its own time limit (default 120 s): past it, or
  after a rank exits non-zero, the launcher SIGKILLs the whole gang and
  the test fails with every rank's stderr tail;
- children run with ``OMP_NUM_THREADS=1`` (and ``torch.set_num_threads(1)``
  in the worker) and import neither jax nor the JAX package.

Inputs go to the children as ``in.npz`` (arrays) and ``in.json``; each
rank writes ``out-<rank>.npz`` and ``out-<rank>.json``.
"""

import json
import os

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT_S = 120.0


def run_world(tmp_path, n, case, inputs=None, config=None,
              timeout=WORLD_TIMEOUT_S, expect_ok=True, device="cpu"):
    """-> [(arrays dict, json dict)] by rank.  ``device="cuda"`` puts every
    rank on the card (gloo still: the ranks share it)."""
    from paddle_tpu_torch.parallel import launch_local

    d = os.path.join(str(tmp_path), f"world-{case}-{n}")
    os.makedirs(d, exist_ok=True)
    np.savez(os.path.join(d, "in.npz"), **(inputs or {}))
    with open(os.path.join(d, "in.json"), "w") as f:
        json.dump({**(config or {}), "device": device}, f)
    env = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
           "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "PADDLE_TPU_TORCH_COMPUTE_DTYPE": "float32",
           "PADDLE_TPU_TORCH_DEVICE": device}
    launcher = launch_local(
        n, os.path.join(ROOT, "tests", "torch_dist_worker.py"), [case, d],
        env=env, coordinator=f"file://{os.path.join(d, 'rendezvous')}",
        backend="gloo", log_dir=os.path.join(d, "logs"), cwd=ROOT)
    codes = launcher.join(timeout)
    if not expect_ok:
        return codes, launcher
    if any(codes):
        pytest.fail(f"world {case} x{n}: exit codes {codes}\n"
                    + launcher.stderr_tails())
    outs = []
    for r in range(n):
        with np.load(os.path.join(d, f"out-{r}.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        with open(os.path.join(d, f"out-{r}.json")) as f:
            outs.append((arrays, json.load(f)))
    return outs


