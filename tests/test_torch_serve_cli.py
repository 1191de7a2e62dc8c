"""``python -m paddle_tpu_torch serve`` (``paddle_tpu_torch/serving/cli.py``)
on the CPU: the serve cases of ``tests/test_cli.py`` (``:103`` the smoke
round trip, ``:157`` the continuous smoke with zero silent drops, ``:310``
continuous needs a smoke count, ``:318`` a required and a corrupt bundle,
``:361`` the help listing the serve flags) on a bundle the port merged,
with ``--device=cpu``; the refused flags and modes name their ROADMAP.md
items; and the SIGTERM path of ``serve`` without ``--serve_smoke`` in a
fresh process.  The continuous-delivery cases of ``tests/test_cli.py``
(``:121`` the watch smoke's publish->reload round trip, ``:152`` watch
needs a publish dir, ``:203``/``:231`` the compile cache on a bundle,
``:264`` the cache dir's resolution, ``:377``-``:412`` the fleet smoke, its
usage errors and flags) and the port's watch smoke over an existing
publish dir.  On the CPU the plain versions run: no kernel library is on
the path, so the caches are consulted and stay empty (the card's warm
boot is ``tests/test_torch_cuda.py``).

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
    for flag in ("--serve_watch", "--serve_fleet", "--compile_cache_dir",
                 "--serve_canary_pct", "--serve_probation_requests",
                 "--serve_shadow", "--tenant_spec", "--tenant_capacity_rate",
                 "--tenant_credit", "--reload_probation"):
        assert f"{flag}=" in out, flag
    for flag in ("--serve_preflight", "--deploy_lint"):
        assert f"{flag}=" not in out, flag


@pytest.mark.parametrize("flag,item", [
    ("--serve_watch", 7), ("--serve_fleet", 7), ("--compile_cache_dir=c", 7),
    ("--tenant_spec=a:1", 7), ("--serve_canary_pct=5", 7),
    ("--serve_preflight", 9), ("--serve_preflight=false", 9),
    ("--deploy_lint=false", 9), ("--metrics_port=9000", 9)])
def test_cli_serve_refused_flags_name_their_item(flag, item):
    """``--serve_preflight``, ``--deploy_lint`` and ``--metrics_port`` still
    raise naming item 9.  The item-7 flags are ported: each parses, and
    the serve command line acts on it (``--serve_watch`` without
    ``--publish_dir`` and ``--serve_fleet`` without a smoke are typed
    usage errors; ``--compile_cache_dir``, ``--tenant_spec`` and
    ``--serve_canary_pct`` ride a fleet smoke that exits 0)."""
    if item == 9:
        with pytest.raises(ConfigError, match=f"Queue 1 item {item}\\b"):
            main(["serve", flag, "--serve_smoke=1", "--device=cpu"])
        return
    name = flag[2:].partition("=")[0]
    if name == "serve_watch":
        with pytest.raises(ConfigError, match="publish_dir"):
            main(["serve", flag, "--device=cpu"])
    elif name == "serve_fleet":
        with pytest.raises(ConfigError, match="serve_fleet|smoke"):
            main(["serve", flag, "--serve_smoke=0", "--device=cpu"])
    else:
        extra = ("--tenant_spec=a:1,b:1:0.5:2" if name == "tenant_spec"
                 else flag)
        assert main(["serve", "--serve_fleet", extra, "--serve_smoke=2",
                     "--serve_deadline_ms=60000", "--device=cpu"]) == 0


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


# ---------------------------------------------------------------------------
# continuous delivery: watch, the compile cache, the fleet
# ---------------------------------------------------------------------------


def test_cli_serve_watch_smoke_publish_reload_roundtrip(tmp_path, capsys):
    """tests/test_cli.py::test_cli_serve_watch_smoke_publish_reload_roundtrip:
    publish v1, boot the watcher from it, publish v2, stream the requests
    across the hot swap: zero shed, v2 committed, no cache miss."""
    rc = main(["serve", "--serve_watch", "--serve_smoke=8",
               f"--publish_dir={tmp_path / 'pub'}",
               "--serve_deadline_ms=60000", "--device=cpu"])
    assert rc == 0
    out = _lines(capsys)
    first, last = out[0], out[-1]
    assert first["ready"] is True
    assert first["model"]["version"] == 1
    assert first["counters"]["compile_cache_misses"] == 0
    assert last["model"]["version"] == 2
    assert last["counters"]["shed"] == 0
    assert last["counters"]["completed"] >= 8
    assert last["counters"]["compile_cache_misses"] == 0
    assert last["counters"]["model_swaps"] == 1
    assert last["launches"] == {"by_kernel": {}, "by_path": {}}
    assert last["compile_cache"]["libraries"] == {} or all(
        v["builds"] == 0 for v in last["compile_cache"]["libraries"].values()
        if v["origin"] == "cache")
    assert (tmp_path / "pub" / "v-00002" / "manifest.json").exists()
    assert (tmp_path / "pub" / "ccache").is_dir()


def test_cli_serve_watch_without_publish_dir_or_smoke_is_config_error():
    """tests/test_cli.py::
    test_cli_serve_watch_without_publish_dir_or_smoke_is_config_error."""
    with pytest.raises(ConfigError, match="publish_dir"):
        main(["serve", "--serve_watch", "--device=cpu"])


def test_cli_serve_watch_smoke_serves_an_existing_publish(tmp_path, capsys):
    """Over a publish dir that holds versions, the watch smoke trains
    nothing: it serves the newest valid version (a corrupt newer one is
    skipped) and its last line's ``smoke_outputs`` equal that bundle's own
    ``infer`` of the example feed."""
    from paddle_tpu_torch.config import load_inference_model
    from paddle_tpu_torch.publish import version_dir
    from paddle_tpu_torch.resilience import chaos
    from paddle_tpu_torch.serving.feeds import example_feed

    pub = tmp_path / "pub"
    assert main(["serve", "--serve_watch", "--serve_smoke=4",
                 f"--publish_dir={pub}", "--serve_deadline_ms=60000",
                 "--device=cpu"]) == 0
    capsys.readouterr()
    # a third version, published and then damaged, must be skipped
    import shutil

    shutil.copytree(version_dir(str(pub), 2), version_dir(str(pub), 3))
    chaos.corrupt_publish(str(pub))
    assert main(["serve", "--serve_watch", "--serve_smoke=3",
                 f"--publish_dir={pub}", "--serve_deadline_ms=60000",
                 "--device=cpu", "--compute_dtype=float32"]) == 0
    out = _lines(capsys)
    last = out[-1]
    assert out[0]["ready"] is True and last["model"]["version"] == 2
    assert last["counters"]["completed"] == 3
    assert last["launches"] == {"by_kernel": {}, "by_path": {}}
    with compute_dtype_scope("float32"):
        m = load_inference_model(
            os.path.join(version_dir(str(pub), 2), "model.ptz"),
            device="cpu")
        want = m.infer(example_feed(m.topology))
    assert set(last["smoke_outputs"]) == set(want)
    for k, v in want.items():
        assert np.array_equal(np.asarray(last["smoke_outputs"][k],
                                         v.dtype), v)


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_cli_serve_smoke_bundle_with_compile_cache_dir(tmp_path, capsys,
                                                       quantize):
    """tests/test_cli.py::test_cli_serve_smoke_int8_bundle_warm_cache and
    ::test_cli_serve_default_compile_cache_warms_second_boot on the CPU:
    an explicit ``--compile_cache_dir`` and the ``auto`` default
    (``<bundle>.ccache``) are consulted, an explicit empty value opts out;
    every smoke request is answered.  The plain versions build nothing, so
    the cache stays empty and every warm call reads as compiled."""
    bundle = serve_bundle(tmp_path / "m.ptz", quantize)
    cache = tmp_path / "cache"
    for extra in ([f"--compile_cache_dir={cache}"], ["--compile_cache_dir=auto"],
                  ["--compile_cache_dir="]):
        assert main(["serve", f"--serve_bundle={bundle}", "--serve_smoke=2",
                     "--serve_deadline_ms=60000", "--device=cpu",
                     *extra]) == 0
        out = _lines(capsys)
        first, last = out[0], out[-1]
        assert first["ready"] is True
        assert first["cold_start"]["warmup_compiles"] == 4
        assert first["cold_start"]["compile_cache_misses"] == 0
        assert last["counters"]["completed"] == 2
        assert not [n for n, v in last["compile_cache"]["libraries"].items()
                    if v["origin"] == "cache" or n != "dataio"]
    assert cache.is_dir() and os.listdir(cache) == []
    assert os.path.isdir(bundle + ".ccache")


def test_serve_auto_cache_resolution_and_unwritable_fallback(
        tmp_path, monkeypatch):
    """tests/test_cli.py::
    test_serve_auto_cache_resolution_and_unwritable_fallback."""
    from paddle_tpu_torch.serving.cli import (_resolve_cache_dir,
                                              _watch_cache_dir)

    bundle = str(tmp_path / "m.ptz")
    FLAGS.compile_cache_dir = "auto"
    assert _resolve_cache_dir(bundle) == bundle + ".ccache"
    assert _resolve_cache_dir(None) == ""
    assert _watch_cache_dir("/p") == os.path.join("/p", "ccache")

    def deny(path, exist_ok=False):
        raise OSError(30, "Read-only file system", path)

    monkeypatch.setattr(os, "makedirs", deny)
    assert _resolve_cache_dir(bundle) == ""
    FLAGS.compile_cache_dir = "/explicit/dir"
    assert _resolve_cache_dir(bundle) == "/explicit/dir"
    assert _watch_cache_dir("/p") == "/explicit/dir"
    FLAGS.compile_cache_dir = ""
    assert _resolve_cache_dir(bundle) == "" == _watch_cache_dir("/p")


def test_cli_serve_fleet_smoke_two_models_two_tenants(capsys):
    """tests/test_cli.py::test_cli_serve_fleet_smoke_two_models_two_tenants."""
    assert main(["serve", "--serve_fleet", "--serve_smoke=4",
                 "--serve_deadline_ms=60000", "--device=cpu"]) == 0
    hz = _lines(capsys)[-1]
    assert hz["ready"] is True
    assert set(hz["models"]) == {"add1@v1", "mul2@v1"}
    assert hz["models"]["add1@v1"]["state"] == "serving"
    assert hz["routes"]["add1"]["incumbent"] == 1
    assert hz["tenants"]["gold"]["admitted"] >= 4
    assert hz["tenants"]["gold"]["quota_rejected"] == 0
    assert hz["tenants"]["free"]["quota_rejected"] > 0
    assert hz["launches"] == {"by_kernel": {}, "by_path": {}}


def test_cli_serve_fleet_requires_smoke():
    """tests/test_cli.py::test_cli_serve_fleet_requires_smoke."""
    with pytest.raises(ConfigError, match="serve_fleet|smoke"):
        main(["serve", "--serve_fleet", "--device=cpu"])


def test_cli_serve_fleet_rejects_malformed_tenant_spec():
    """tests/test_cli.py::test_cli_serve_fleet_rejects_malformed_tenant_spec;
    the port's parser reads the same specs as the reference's."""
    from paddle_tpu.serving.cli import _parse_tenant_spec as jparse
    from paddle_tpu_torch.serving.cli import _parse_tenant_spec

    with pytest.raises(ConfigError, match="tenant_spec"):
        main(["serve", "--serve_fleet", "--serve_smoke=1",
              "--tenant_spec=gold:notanumber", "--device=cpu"])
    spec = "gold:3:100:20, free:1:10, solo"
    got = [vars(t) for t in _parse_tenant_spec(spec)]
    assert got == [vars(t) for t in jparse(spec)]


def test_cli_help_lists_fleet_flags(capsys):
    """tests/test_cli.py::test_cli_help_lists_fleet_flags."""
    assert main(["--help"]) == 0
    out = capsys.readouterr().out
    for flag in ("--serve_fleet", "--serve_canary_pct", "--serve_shadow",
                 "--serve_probation_requests", "--tenant_spec",
                 "--tenant_capacity_rate", "--tenant_credit",
                 "--serve_watch", "--publish_dir", "--publish_every",
                 "--reload_probation", "--compile_cache_dir",
                 "--scrub_every_s", "--obs_journal"):
        assert f"{flag}=" in out, flag
