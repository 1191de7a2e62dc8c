"""``python -m paddle_tpu_torch serve`` (``paddle_tpu_torch/serving/cli.py``)
on the CPU: the serve cases of ``tests/test_cli.py`` (``:103`` the smoke
round trip, ``:157`` the continuous smoke with zero silent drops, ``:310``
continuous needs a smoke count, ``:318`` a required and a corrupt bundle,
``:361`` the help listing the serve flags) on a bundle the port merged,
with ``--device=cpu``; the refused flags and modes name their ROADMAP.md
items; and the SIGTERM path of ``serve`` without ``--serve_smoke`` in a
fresh process.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_serve_cli.py -q
"""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

from paddle_tpu_torch.__main__ import main
from paddle_tpu_torch.config.deploy import BundleCorruptError
from paddle_tpu_torch.ops import compute_dtype_scope
from paddle_tpu_torch.utils.error import ConfigError
from paddle_tpu_torch.utils.flags import FLAGS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def restore_flags():
    keep = FLAGS.as_dict()
    yield
    for k, v in keep.items():
        setattr(FLAGS, k, v)


def serve_bundle(path, quantize=None):
    """The reference's ``_serve_bundle``: one Adam step of a tiny fc
    classifier on the CPU, merged to ``path`` (sized so int8 quantizes a
    matmul when asked)."""
    import paddle_tpu_torch.nn as nn
    from paddle_tpu_torch.config import merge_model
    from paddle_tpu_torch.param.optimizers import Adam
    from paddle_tpu_torch.trainer import SGDTrainer

    with compute_dtype_scope("float32"):
        nn.reset_naming()
        size = 4 if quantize is None else 32
        x = nn.data("x", size=size)
        out = nn.fc(x, 3 if quantize is None else 16, act="softmax",
                    name="out")
        label = nn.data("label", size=1, dtype="int32")
        cost = nn.classification_cost(out, label, name="cost")
        tr = SGDTrainer(cost, Adam(learning_rate=0.05), seed=0,
                        device="cpu")
        rng = np.random.RandomState(0)
        tr.train_batch({"x": rng.randn(4, size).astype(np.float32),
                        "label": np.zeros((4, 1), np.int32)})
        return merge_model(str(path), tr.topology, tr.params, tr.state,
                           name="cli", quantize=quantize)


def _lines(capsys):
    return [json.loads(l) for l in
            capsys.readouterr().out.strip().splitlines()]


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_cli_serve_smoke_roundtrip(tmp_path, capsys, quantize):
    bundle = serve_bundle(tmp_path / "m.ptz", quantize)
    rc = main(["serve", f"--serve_bundle={bundle}", "--serve_smoke=3",
               "--serve_deadline_ms=60000", "--device=cpu"])
    assert rc == 0
    out = _lines(capsys)
    first, last = out[0], out[-1]
    assert first["ready"] is True  # the readiness gate passed first
    assert first["counters"]["warmup_compiles"] == 4  # buckets 1, 2, 4, 8
    assert last["counters"]["completed"] == 3
    assert last["counters"]["shed"] == 0
    assert last["counters"]["worker_crashed"] == 0
    assert last["breaker"]["state"] == "closed"
    # CPU tensors take the plain versions: no kernel launched
    assert last["launches"] == {"by_kernel": {}, "by_path": {}}


@pytest.mark.parametrize("spec", [False, True])
def test_cli_serve_continuous_smoke_zero_silent_drops(capsys, spec):
    """11 mixed-length requests through a 3-slot table (with
    ``--spec_decode``, the greedy wide-verify arm): every request resolves
    and the slots recycle."""
    args = ["serve", "--serve_continuous", "--serve_smoke=11",
            "--serve_slots=3", "--serve_deadline_ms=60000", "--device=cpu"]
    assert main(args + (["--spec_decode"] if spec else [])) == 0
    out = _lines(capsys)
    first, last = out[0], out[-1]
    assert first["ready"] is True and first["mode"] == "generation"
    assert last["counters"]["completed"] == 11
    assert last["counters"]["worker_crashed"] == 0
    assert last["slots"]["capacity"] == 3
    assert last["slots"]["recycled"] == 11
    assert last["launches"] == {"by_kernel": {}, "by_path": {}}
    if spec:
        s = last["spec"]
        assert s["k"] > 0
        assert s["draft_tokens_total"] >= s["accepted_tokens_total"] >= 0


def test_cli_serve_continuous_requires_smoke():
    with pytest.raises(ConfigError, match="serve_continuous|smoke"):
        main(["serve", "--serve_continuous"])


def test_cli_serve_requires_bundle_and_rejects_corrupt(tmp_path):
    with pytest.raises(ConfigError, match="serve_bundle"):
        main(["serve", "--serve_smoke=1"])
    bad = tmp_path / "bad.ptz"
    bad.write_bytes(b"this is not a zip archive")
    with pytest.raises(BundleCorruptError):
        main(["serve", f"--serve_bundle={bad}", "--serve_smoke=1",
              "--device=cpu"])
    with pytest.raises(ConfigError, match="unrecognized"):
        main(["serve", "--serve_bogus=1"])


def test_cli_help_lists_serve_flags(capsys):
    assert main(["serve", "--help"]) == 0
    assert "serve_bundle" in capsys.readouterr().out
    assert main(["--help"]) == 0
    out = capsys.readouterr().out
    assert "python -m paddle_tpu_torch serve" in out
    for flag in ("--serve_bundle", "--serve_max_batch",
                 "--serve_queue_depth", "--serve_deadline_ms",
                 "--serve_breaker_threshold", "--serve_smoke",
                 "--serve_continuous", "--serve_slots", "--spec_decode",
                 "--deploy_quantize"):
        assert f"{flag}=" in out, flag
    for flag in ("--serve_preflight", "--serve_watch", "--serve_fleet",
                 "--compile_cache_dir", "--deploy_lint"):
        assert f"{flag}=" not in out, flag


@pytest.mark.parametrize("flag,item", [
    ("--serve_watch", 7), ("--serve_fleet", 7), ("--compile_cache_dir=c", 7),
    ("--tenant_spec=a:1", 7), ("--serve_canary_pct=5", 7),
    ("--serve_preflight", 9), ("--serve_preflight=false", 9),
    ("--deploy_lint=false", 9), ("--metrics_port=9000", 9)])
def test_cli_serve_refused_flags_name_their_item(flag, item):
    with pytest.raises(ConfigError, match=f"Queue 1 item {item}\\b"):
        main(["serve", flag, "--serve_smoke=1", "--device=cpu"])


def test_cli_serve_until_sigterm(tmp_path):
    """Without ``--serve_smoke`` the server runs until SIGTERM, then exits
    0 after closing (a fresh process; the ready line comes first)."""
    bundle = serve_bundle(tmp_path / "m.ptz")
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch", "serve",
         f"--serve_bundle={bundle}", "--device=cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": ROOT})
    try:
        ready = json.loads(proc.stdout.readline())
        assert ready["ready"] is True
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0, proc.stderr.read()[-2000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
